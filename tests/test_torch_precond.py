"""The band preconditioners of waiwera_tpu_torch against waiwera_tpu.

- dia_dilu_em, dia_line_pc_em and CPR (ops/mg.py) on the f64 Jacobian
  of the flagship model on a 6 x 5 x 4 box (as tests/test_solver.py:422,
  463, 792): applied in f64, rtol 1e-10 / atol 1e-10 * max|z| (the same
  operations in the same order); applied in f32, rtol 2e-5 /
  atol 2e-4 * max|z| (tests/test_solver.py:723). The line
  preconditioner also solves its block tridiagonal exactly (rtol 1e-8).
- One step (dt 1e3 s) of the flagship model (f32 Jacobian, f32
  BiCGStab) on a 5 x 4 x 3 box per preconditioner: equal converged
  flag, Newton and BiCGStab iterations and regions; y within rtol 2e-5,
  atol 2e-5 (tests/test_torch_step.py).
"""

import numpy as np
import pytest
import torch

from torch_parity import jax_coeffs, jax_sim, np_, torch_sim

DT = 1.0e4
DT_STEP = 1.0e3  # at 1e4 s the cpr step fails in both packages


@pytest.fixture(scope="module")
def bands():
    """JAX f64 parts of the 6 x 5 x 4 flagship box, and both band
    matrices built from them."""
    import jax.numpy as jnp
    from waiwera_tpu.ops import dia as jdia
    from waiwera_tpu_torch.ops import dia as tdia

    sj, st = jax_sim(6, 5, 4), torch_sim(6, 5, 4)
    cj, _ = jax_coeffs(sj, DT)
    parts = [np.array(p) for p in sj.system.jacobian_parts(
        sj.y0, sj.region0, sj.rock, cj, jnp.asarray(0.0), jnp.asarray(DT))]
    mj = jdia.bands_from_blocks(sj.system.dia, sj.system.band_plan,
                                *(jnp.asarray(p) for p in parts))
    mt = tdia.bands_from_blocks(st.system.bands, st.system.band_fill,
                                *(torch.as_tensor(p) for p in parts))
    n = mt.num_rows
    np.testing.assert_array_equal(np_(mt.bands),
                                  np.asarray(mj.bands)[:, :, :n])
    r = np.random.default_rng(3).standard_normal((n, 3))
    return mj, mt, r


def _pcs(name, mj, mt, dtype):
    """(JAX apply, port apply) of one preconditioner in dtype."""
    import jax.numpy as jnp
    from waiwera_tpu.ops import dia as jdia
    from waiwera_tpu.ops import mg as jmg
    from waiwera_tpu.solver.smallblocks import invert_blocks_em as jinv
    from waiwera_tpu_torch.ops import dia as tdia
    from waiwera_tpu_torch.ops import mg as tmg
    from waiwera_tpu_torch.solver.smallblocks import invert_blocks_em as tinv

    jdt = None if dtype == torch.float64 else jnp.float32
    tdt = None if dtype == torch.float64 else torch.float32
    if name == "dilu":
        return (jdia.dia_dilu_em(mj, sweeps=3, dtype=jdt),
                tdia.dia_dilu_em(mt, dtype=tdt))
    if name == "line":
        return (jdia.dia_line_pc_em(mj, dtype=jdt),
                tdia.dia_line_pc_em(mt, dtype=tdt))
    n = mt.num_rows
    k0 = mt.offsets.index(0)
    levels_j, dims_j = jmg.pressure_levels(mj, dtype=jdt)
    levels_t, dims_t = tmg.pressure_levels(mt, dtype=tdt)
    assert dims_t == dims_j
    bj_j = jdia.dia_block_jacobi_em(jinv(mj.bands[k0, :, :n]), jdt)
    bj_t = tdia.dia_block_jacobi_em(tinv(mt.bands[k0]), tdt)
    mt_a = mt if tdt is None else mt._replace(bands=mt.bands.to(tdt))
    mj_a = mj if jdt is None else mj._replace(bands=mj.bands.astype(jdt))
    return (jmg.cpr_apply(levels_j, dims_j, lambda x: jdia.jnp_matvec(mj_a, x),
                          bj_j, n, 3),
            tmg.cpr_apply(levels_t, dims_t,
                          lambda x: tdia.dia_matvec(mt_a, x), bj_t, n))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("name", ["dilu", "line", "cpr"])
def test_preconditioner_matches_jax(bands, name, dtype):
    import jax.numpy as jnp

    mj, mt, r = bands
    pj, pt = _pcs(name, mj, mt, dtype)
    rr = r.astype(np.float32) if dtype == torch.float32 else r
    zj = np.asarray(pj(jnp.asarray(rr)))
    zt = pt(torch.as_tensor(rr))
    assert zt.dtype == dtype and tuple(zt.shape) == r.shape
    tol = 1e-10 if dtype == torch.float64 else 2e-5
    atol = (1e-10 if dtype == torch.float64 else 2e-4) * np.abs(zj).max()
    np.testing.assert_allclose(np_(zt), zj, rtol=tol, atol=atol)


def test_line_pc_solves_its_tridiagonal(bands):
    from waiwera_tpu_torch.ops import dia as tdia

    _, mt, r = bands
    z = np_(tdia.dia_line_pc_em(mt)(torch.as_tensor(r)))
    n, b = r.shape
    offs = list(mt.offsets)
    p = max(d for d in offs if d > 0 and -d in offs)
    A = np.zeros((n * b, n * b))
    bnd = np_(mt.bands)
    for k, d in enumerate(offs):
        if d in (0, p, -p):
            for i in range(max(0, -d), min(n, n - d)):
                A[i * b:(i + 1) * b, (i + d) * b:(i + d + 1) * b] = \
                    bnd[k, :, i].reshape(b, b)
    zref = np.linalg.solve(A, r.reshape(-1)).reshape(n, b)
    np.testing.assert_allclose(z, zref, rtol=1e-8, atol=1e-10)


@pytest.fixture(scope="module")
def small_box():
    return jax_sim(), torch_sim()


@pytest.mark.parametrize("pc", ["dilu", "line", "cpr"])
def test_step_per_preconditioner_matches_jax(small_box, pc):
    import jax.numpy as jnp
    from waiwera_tpu.solver.newton import NewtonParams as JParams
    from waiwera_tpu_torch.solver.newton import NewtonParams as TParams

    sj, st = small_box
    kw = dict(max_iterations=8, min_iterations=1, linear_dtype="float32",
              jacobian_dtype="float32", linear_pc=pc)
    step_j = sj.make_step_fn(JParams(**kw), "beuler")
    step_t = st.make_step_fn(TParams(**kw), "beuler")
    lhs_j, fluid_j, _ = sj.lhs_at(sj.y0, sj.region0)
    lhs_t, fluid_t, _ = st.lhs_at(st.y0, st.region0)
    rj = step_j(sj.y0, sj.region0, fluid_j.temperature, lhs_j, lhs_j,
                jnp.asarray(0.0), jnp.asarray(DT_STEP), jnp.asarray(DT_STEP),
                jnp.asarray(1.0), fluid_last=fluid_j,
                fluxes_last=sj.initial_fluxes(sj.y0, sj.region0))[0]
    rt = step_t(st.y0, st.region0, fluid_t.temperature, lhs_t, lhs_t, 0.0,
                DT_STEP, DT_STEP, 1.0)[0]
    assert rt.converged == bool(rj.converged) and rt.converged
    assert rt.failed == bool(rj.failed)
    assert rt.iterations == int(rj.iterations)
    assert rt.linear_iterations == int(rj.linear_iterations)
    np.testing.assert_array_equal(np_(rt.region), np.asarray(rj.region))
    np.testing.assert_allclose(np_(rt.y), np.asarray(rj.y), rtol=2e-5,
                               atol=2e-5)
