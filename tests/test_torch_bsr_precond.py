"""The BSR-route preconditioners of waiwera_tpu_torch (solver/precond.py)
against the JAX package's, f64, on the block 1-D Laplacians of
tests/test_solver.py (laplacian_1d, :216 the DILU case) and the column
model of :969 (the LU case): the same split, transposed blocks and
preconditioner applications at rtol 1e-10, from the same numpy inputs."""

import numpy as np
import pytest
import torch

from torch_parity import np_


def laplacian_pair(n, b, seed=0):
    """tests/test_solver.py laplacian_1d as the JAX package's and the
    port's BSR matrices, built from the same numpy blocks."""
    import jax.numpy as jnp
    from waiwera_tpu.solver import bsr as jbsr
    from waiwera_tpu_torch.solver import bsr as tbsr

    rng = np.random.default_rng(seed)
    face_cells = np.stack([np.arange(n - 1), np.arange(1, n)], axis=1)
    base = 2.0 * np.eye(b) + 0.1 * rng.standard_normal((b, b))
    diag = np.stack([base * (2.0 + 0.05 * i) for i in range(n)])
    off = -np.tile(np.eye(b), (n - 1, 1, 1)) * 0.9
    # a nonsymmetric touch on the lower side, so transposed blocks differ
    low = off * (1.0 + 0.1 * rng.uniform(size=(n - 1, 1, 1)))
    sj = jbsr.build_structure(n, face_cells, b)
    lr, rl = jbsr.face_block_positions(sj, face_cells)
    mj = jbsr.assemble(sj, jnp.asarray(diag), jnp.asarray(off),
                       jnp.asarray(low), jnp.asarray(lr), jnp.asarray(rl))
    st = tbsr.build_structure(n, face_cells, b)
    mt = tbsr.assemble(st, tbsr.assembly(st, face_cells),
                       torch.as_tensor(diag), torch.as_tensor(off),
                       torch.as_tensor(low))
    np.testing.assert_array_equal(np_(mt.data), np.asarray(mj.data))
    return mj, mt


def _apply_both(pj, pt, n, b, seed=3, dtype=torch.float64):
    import jax.numpy as jnp

    r = np.random.default_rng(seed).standard_normal((n, b))
    zj = np.asarray(pj(jnp.asarray(r, dtype=str(dtype).split(".")[1])))
    zt = pt(torch.as_tensor(r, dtype=dtype))
    assert zt.dtype == dtype
    return np_(zt), zj


def test_ilu0_split_and_transpose_match_jax():
    from waiwera_tpu.solver import precond as jp
    from waiwera_tpu_torch.solver import precond as tp

    mj, mt = laplacian_pair(30, 3, seed=2)
    sj = jp.ilu0_split(mj.structure)
    st = tp.ilu0_split(mt.structure)
    for name in ("lower_pos", "lower_rows", "lower_cols", "upper_pos",
                 "upper_rows", "upper_cols"):
        np.testing.assert_array_equal(np_(getattr(st, name)),
                                      np.asarray(getattr(sj, name)),
                                      err_msg=name)
    tb = np_(tp._transpose_blocks(mt, st))
    np.testing.assert_array_equal(tb, np.asarray(
        jp._transpose_blocks(mj, sj)))
    # the transposed block of A_ij is A_ji: here the upper neighbour
    assert np.abs(tb - np_(mt.data[st.lower_pos])).max() > 0.0


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_block_jacobi_matches_jax(dtype):
    import jax.numpy as jnp
    from waiwera_tpu.solver import precond as jp
    from waiwera_tpu_torch.solver import precond as tp

    mj, mt = laplacian_pair(40, 4, seed=5)
    jdt = None if dtype == torch.float64 else jnp.float32
    zt, zj = _apply_both(jp.block_jacobi(mj, dtype=jdt),
                         tp.block_jacobi(mt, dtype=dtype), 40, 4,
                         dtype=dtype)
    rtol = 1e-10 if dtype == torch.float64 else 1e-5
    np.testing.assert_allclose(zt, zj, rtol=rtol, atol=rtol * abs(zj).max())


@pytest.mark.parametrize("sweeps", [1, 3])
def test_dilu_matches_jax(sweeps):
    """tests/test_solver.py:216's matrix (60 x 2) and a 3 x 3-block one:
    the DILU-modified diagonal and the fixed-point sweeps."""
    from waiwera_tpu.solver import precond as jp
    from waiwera_tpu_torch.solver import precond as tp

    for n, b in ((60, 2), (25, 3)):
        mj, mt = laplacian_pair(n, b)
        pj = jp.dilu(mj, jp.ilu0_split(mj.structure), sweeps=sweeps)
        pt = tp.dilu(mt, tp.ilu0_split(mt.structure), sweeps=sweeps)
        zt, zj = _apply_both(pj, pt, n, b)
        np.testing.assert_allclose(zt, zj, rtol=1e-10,
                                   atol=1e-12 * abs(zj).max())


def test_lu_matches_jax():
    """The dense LU apply at rtol 1e-10 (pivots may differ at ties
    between LAPACK builds), and the size guard's message."""
    from waiwera_tpu.solver import precond as jp
    from waiwera_tpu_torch.solver import precond as tp

    mj, mt = laplacian_pair(50, 3, seed=4)
    zt, zj = _apply_both(jp.lu(mj), tp.lu(mt), 50, 3)
    np.testing.assert_allclose(zt, zj, rtol=1e-10, atol=1e-12 * abs(zj).max())
    big = mt._replace(structure=mt.structure._replace(num_rows=7000))
    with pytest.raises(ValueError, match="system too large"):
        tp.lu(big)


@pytest.mark.parametrize("name", ["none", "bjacobi", "line", "cpr", "asm",
                                  "ilu", "sgs", "lu"])
def test_make_preconditioner_matches_jax(name):
    from waiwera_tpu.solver import precond as jp
    from waiwera_tpu_torch.solver import precond as tp

    mj, mt = laplacian_pair(36, 2, seed=6)
    zt, zj = _apply_both(jp.make_preconditioner(name, mj),
                         tp.make_preconditioner(name, mt), 36, 2)
    np.testing.assert_allclose(zt, zj, rtol=1e-10, atol=1e-12 * abs(zj).max())
    with pytest.raises(ValueError, match="unknown preconditioner"):
        tp.make_preconditioner("amg", mt)


def test_lu_preconditioner_one_iteration_matches_jax():
    """tests/test_solver.py:969 through both packages: the column model's
    Jacobian, System.make_linear_operator(mat, "lu") and BiCGStab, which
    converges in at most 2 iterations, as many as the JAX package's."""
    import jax.numpy as jnp
    from waiwera_tpu.mesh.rect import column_mesh as jcolumn
    from waiwera_tpu.sim.simulation import Simulation as JSim
    from waiwera_tpu.solver import krylov as jk
    from waiwera_tpu.solver.system import MethodCoeffs as JCoeffs
    from waiwera_tpu_torch.mesh.rect import column_mesh as tcolumn
    from waiwera_tpu_torch.sim.simulation import Simulation as TSim
    from waiwera_tpu_torch.solver import krylov as tk
    from waiwera_tpu_torch.solver.system import MethodCoeffs as TCoeffs

    def cfg():
        return {"eos": {"name": "we"},
                "initial": {"primary": [5.0e6, 180.0], "region": 1},
                "source": [{"cell": 23, "rate": -0.02}]}

    sj = JSim(cfg(), mesh=jcolumn([10.0] * 24))
    st = TSim(cfg(), mesh=tcolumn([10.0] * 24), device="cpu")
    lj, _, _ = sj.lhs_at(sj.y0, sj.region0)
    lt, _, _ = st.lhs_at(st.y0, st.region0)
    dt = 1.0e4
    rj, _, _, _, matj = sj.system.residual_and_jacobian(
        sj.y0, sj.region0, sj.rock,
        JCoeffs(c_lhs=jnp.asarray(1.0), dt_eff=jnp.asarray(dt), const=-lj),
        jnp.asarray(0.0), jnp.asarray(dt))
    rt, _, _, _, matt = st.system.residual_and_jacobian(
        st.y0, st.region0, st.rock, TCoeffs(c_lhs=1.0, dt_eff=dt, const=-lt),
        0.0, dt)
    mvj, pcj = sj.system.make_linear_operator(matj, "lu")
    mvt, pct = st.system.make_linear_operator(matt, "lu")
    resj = jk.solve("bcgs", mvj, -rj, precond=pcj, rtol=1e-8)
    rest = tk.solve("bcgs", mvt, -rt, precond=pct, rtol=1e-8)
    assert rest.converged and rest.iterations <= 2
    assert rest.iterations == int(resj.iterations)
    np.testing.assert_allclose(np_(rest.x), np.asarray(resj.x), rtol=1e-8,
                               atol=1e-10 * np.abs(np.asarray(resj.x)).max())
