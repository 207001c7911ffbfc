"""BSR assembly, the ELL operator and the f64 residual + Jacobian of
waiwera_tpu_torch against waiwera_tpu.

- f64 residual and Jacobian parts of the flagship model on a 5 x 4 x 3
  box: the port's torch.func.jvp chain against the JAX package's
  jax.linearize chain (_rj_core), rtol 1e-10 (round-off of two AD
  orders), atol 1e-10 * max|part|.
- BSR assembly from the same parts: exact (each stored block receives
  one part).
- ELL matvec against the JAX package's, f64 rtol 1e-13
  (tests/test_solver.py:240), on the flagship box and on a random
  unstructured pattern; and the ELL route's operator with block-Jacobi
  against the band route's (rtol 1e-12 / 1e-10, test_solver.py:829), its
  BSR DILU against the JAX package's (rtol 1e-10).
"""

import numpy as np
import pytest
import torch

from torch_parity import jax_coeffs, jax_sim, np_, torch_coeffs, torch_sim

DT = 1.0e4


@pytest.fixture(scope="module")
def systems():
    import jax.numpy as jnp

    sj, st = jax_sim(), torch_sim()
    cj, _ = jax_coeffs(sj, DT)
    ct, _ = torch_coeffs(st, DT)
    out_j = sj.system.residual_and_jacobian_parts(
        sj.y0, sj.region0, sj.rock, cj, jnp.asarray(0.0), jnp.asarray(DT))
    out_t = st.system.residual_and_jacobian_parts(
        st.y0, st.region0, st.rock, ct, 0.0, DT)
    return sj, st, out_j, out_t


def test_f64_residual_and_jacobian_match_jax(systems):
    _, _, out_j, out_t = systems
    rj, Lj, fxj, errj, parts_j = out_j
    rt, Lt, fxt, errt, parts_t = out_t
    for a, b in ((rt, rj), (Lt, Lj), (fxt, fxj)):
        assert a.dtype == torch.float64
        np.testing.assert_allclose(np_(a), np.asarray(b), rtol=1e-10,
                                   atol=1e-10 * np.abs(np.asarray(b)).max())
    np.testing.assert_array_equal(np_(errt), np.asarray(errj))
    for name, pt, pj in zip(("diag", "lr", "rl"), parts_t, parts_j):
        pj = np.asarray(pj)
        assert pt.dtype == torch.float64 and tuple(pt.shape) == pj.shape
        np.testing.assert_allclose(np_(pt), pj, rtol=1e-10,
                                   atol=1e-10 * np.abs(pj).max(),
                                   err_msg=name)


def test_bsr_assembly_matches_jax(systems):
    import jax.numpy as jnp

    sj, st, out_j, _ = systems
    parts = [np.array(p) for p in out_j[4]]
    mj = sj.system.assemble_bsr(tuple(jnp.asarray(p) for p in parts))
    mt = st.system.assemble_bsr(tuple(torch.as_tensor(p) for p in parts))
    np.testing.assert_array_equal(np_(mt.data), np.asarray(mj.data))
    np.testing.assert_array_equal(np_(mt.diag_blocks()),
                                  np.asarray(mj.diag_blocks()))


def test_ell_matvec_matches_jax(systems):
    import jax.numpy as jnp
    from waiwera_tpu.ops import ell as jell
    from waiwera_tpu_torch.ops import ell as tell

    sj, st, out_j, _ = systems
    parts = [np.array(p) for p in out_j[4]]
    mj = sj.system.assemble_bsr(tuple(jnp.asarray(p) for p in parts))
    mt = st.system.assemble_bsr(tuple(torch.as_tensor(p) for p in parts))
    ej = jell.to_ell(mj, sj.system.ell)
    et = tell.to_ell(mt, st.system.ell_tables)
    np.testing.assert_array_equal(np_(et.indices), np.asarray(ej.indices))
    np.testing.assert_array_equal(np_(et.data), np.asarray(ej.data))
    x = np.random.default_rng(5).standard_normal((st.mesh.num_cells, 3))
    np.testing.assert_allclose(np_(et.matvec(torch.as_tensor(x))),
                               np.asarray(ej.matvec(jnp.asarray(x))),
                               rtol=1e-13, atol=1e-13 * np.abs(parts[0]).max())
    # f32 ELL (the bench's ELL section): cast once, f32 result
    e32 = tell.to_ell(mt, st.system.ell_tables, torch.float32)
    y32 = e32.matvec(torch.as_tensor(x, dtype=torch.float32))
    assert y32.dtype == torch.float32
    np.testing.assert_allclose(np_(y32), np_(et.matvec(torch.as_tensor(x))),
                               rtol=2e-5, atol=2e-4 * np.abs(parts[0]).max())


def test_ell_unstructured_pattern_matches_jax():
    """A random pattern with no bands (test_solver.py:252)."""
    import jax.numpy as jnp
    from waiwera_tpu.ops import ell as jell
    from waiwera_tpu.solver import bsr as jbsr
    from waiwera_tpu_torch.ops import ell as tell
    from waiwera_tpu_torch.solver import bsr as tbsr

    n = 30
    rng = np.random.default_rng(11)
    faces = np.unique(np.array([
        (min(i, j), max(i, j)) for i in range(n)
        for j in rng.choice(n, size=3, replace=False) if i != j
    ]), axis=0)
    sj = jbsr.build_structure(n, faces, 2)
    stt = tbsr.build_structure(n, faces, 2)
    data = rng.standard_normal((len(stt.indices), 2, 2))
    ej = jell.to_ell(jbsr.BSRMatrix(structure=sj, data=jnp.asarray(data)),
                     jell.ell_structure(sj))
    et = tell.to_ell(tbsr.BSRMatrix(structure=stt,
                                    data=torch.as_tensor(data),
                                    diag_pos=torch.as_tensor(stt.diag_pos)),
                     tell.ell_structure(stt))
    x = rng.standard_normal((n, 2))
    np.testing.assert_allclose(np_(et.matvec(torch.as_tensor(x))),
                               np.asarray(ej.matvec(jnp.asarray(x))),
                               rtol=1e-13, atol=1e-13)


def test_ell_route_operator_matches_band_route(systems):
    _, st, _, out_t = systems
    parts = out_t[4]
    mat = st.system.assemble_bsr(parts)
    v = torch.as_tensor(
        np.random.default_rng(6).standard_normal((st.mesh.num_cells, 3)))
    for pc_name in ("bjacobi", "none"):
        mv_a, pc_a = st.system.make_linear_operator(mat, pc_name)
        mv_b, pc_b = st.system.linear_operator_from_parts(parts, pc_name)
        np.testing.assert_allclose(np_(mv_a(v)), np_(mv_b(v)),
                                   rtol=1e-12, atol=1e-10)
        np.testing.assert_allclose(np_(pc_a(v)), np_(pc_b(v)),
                                   rtol=1e-10, atol=1e-10)
    # the BSR DILU of the ELL route against the JAX package's on the
    # same matrix (the band route's DILU is another preconditioner)
    import jax.numpy as jnp
    from waiwera_tpu.solver import precond as jprecond

    sj = systems[0]
    mj = sj.system.assemble_bsr(tuple(jnp.asarray(np_(p)) for p in parts))
    _, pc = st.system.make_linear_operator(mat, "dilu")
    want = np.asarray(jprecond.make_preconditioner("dilu", mj)(
        jnp.asarray(np_(v))))
    np.testing.assert_allclose(np_(pc(v)), want, rtol=1e-10,
                               atol=1e-12 * np.abs(want).max())
