"""Zones, MINC and the hybrid band + tail operator of waiwera_tpu_torch
against waiwera_tpu, on the bench's MINC configuration (the flagship
model with a dual-porosity lower half, two matrix levels) on a 5 x 4 x 4
box.

- Zones (cell arrays, boxes, combinations): equal cell lists.
- The MINC mesh (matrix cells, their numbering, volumes, connection
  faces), the rock and the initial state: equal, geometry to rtol 1e-12.
- The hybrid split: f_live and the band offsets equal the JAX package's
  face plan and hybrid structures (tests/test_solver.py:598), and
  y = A x and the preconditioners on the f64 Jacobian agree to
  rtol 1e-12 / atol 1e-9 (f64; the same operations), and in f32 to
  rtol 2e-5 / atol 2e-4 * max|y| (test_solver.py:638).
- One MINC step of 1e3 s (f32 Jacobian, f32 BiCGStab, block-Jacobi):
  equal converged flag, Newton iterations and regions; y within
  rtol 2e-5, atol 2e-5 (tests/test_torch_step.py); BiCGStab iterations
  within 10% (on this MINC system the two packages' f64 solves of one
  and the same linear system, equal to 1e-15, take 35 and 37
  iterations: the restarts are sensitive to summation order).
"""

import numpy as np
import pytest
import torch

from torch_parity import jax_coeffs, jax_sim, np_, torch_sim

SIZE = (5, 4, 4)
DT = 1.0e4
DT_STEP = 1.0e3  # the MINC step fails at 1e4 s in both packages


@pytest.fixture(scope="module")
def sims():
    return jax_sim(*SIZE, minc=True), torch_sim(*SIZE, minc=True)


def test_zones_match_jax():
    from waiwera_tpu.mesh.rect import rectangular_mesh as jrect
    from waiwera_tpu.sim.simulation import Simulation as JSim
    from waiwera_tpu_torch.mesh.rect import rectangular_mesh as trect
    from waiwera_tpu_torch.sim.simulation import Simulation as TSim

    config = {"mesh": {"zones": {
        "a": {"cells": [0, 3, 7]},
        "b": {"type": "box", "x": [0.0, 120.0], "z": [-60.0, -20.0]},
        "ab": {"+": ["a", "b"]},
        "not_b": {"-": "b"},
        "a_not_b": {"type": "combine", "+": "ab", "-": ["b"]},
        "plain": [1, 2],
    }}}
    args = ([50.0] * 5, [50.0] * 4, [20.0] * 4)
    zj = JSim._setup_zones(None, config, jrect(*args, origin=[0, 0, -80.0]))
    zt = TSim._setup_zones(config, trect(*args, origin=[0, 0, -80.0]))
    assert set(zt) == set(zj)
    for name in zj:
        np.testing.assert_array_equal(zt[name], np.asarray(zj[name]),
                                      err_msg=name)


def test_minc_mesh_rock_and_state_match_jax(sims):
    sj, st = sims
    mj, mt = sj.mesh, st.mesh
    n0 = SIZE[0] * SIZE[1] * SIZE[2]
    np.testing.assert_array_equal(st.zones["lower"], sj.zones["lower"])
    assert (mt.num_cells, mt.num_interior_cells) == (mj.num_cells,
                                                     mj.num_interior_cells)
    assert mt.num_interior_cells == n0 + 2 * len(sj.zones["lower"])
    for f in ("minc_level", "minc_parent", "face_cells",
              "face_permeability_direction", "is_ghost"):
        np.testing.assert_array_equal(getattr(mt, f), getattr(mj, f),
                                      err_msg=f)
    for f in ("cell_volume", "cell_centroid", "face_area", "face_distance",
              "face_distance12", "face_gravity_normal"):
        np.testing.assert_allclose(getattr(mt, f), getattr(mj, f),
                                   rtol=1e-12, atol=1e-12, err_msg=f)
    for f in sj.rock._fields:
        np.testing.assert_array_equal(np_(getattr(st.rock, f)),
                                      np.asarray(getattr(sj.rock, f)),
                                      err_msg=f)
    np.testing.assert_array_equal(np_(st.region0), np.asarray(sj.region0))
    np.testing.assert_allclose(np_(st.y0), np.asarray(sj.y0), rtol=1e-14)


@pytest.fixture(scope="module")
def operators(sims):
    """The JAX package's f64 Jacobian parts of the MINC box at the
    initial state."""
    import jax.numpy as jnp

    sj, st = sims
    cj, _ = jax_coeffs(sj, DT)
    parts = [np.array(p) for p in sj.system.jacobian_parts(
        sj.y0, sj.region0, sj.rock, cj, jnp.asarray(0.0), jnp.asarray(DT))]
    v = np.random.default_rng(11).standard_normal((st.mesh.num_cells, 3))
    return sj, st, parts, v


def test_hybrid_split_matches_jax(operators):
    sj, st, _, _ = operators
    js, ts = sj.system, st.system
    assert js.band_plan is None and js.hybrid is not None
    assert ts.dia is None and ts.hybrid is not None
    assert ts.f_live == js.face_plan.f_live
    assert ts.hybrid.offsets == tuple(js.hybrid[0].offsets)
    assert ts._tail_cl.numel() == int(js._tail_cl.shape[0]) > 0
    np.testing.assert_array_equal(np_(ts._tail_cl), np.asarray(js._tail_cl))
    np.testing.assert_array_equal(np_(ts._tail_cr), np.asarray(js._tail_cr))


@pytest.mark.parametrize("dtype", ["f64", "f32"])
@pytest.mark.parametrize("pc_name", ["bjacobi", "none", "dilu", "line"])
def test_hybrid_operator_matches_jax(operators, pc_name, dtype):
    import jax.numpy as jnp

    sj, st, parts, v = operators
    jdt, tdt = (None, None) if dtype == "f64" else (jnp.float32,
                                                   torch.float32)
    if dtype == "f32":
        v = v.astype(np.float32)
    mv_j, pc_j = sj.system.linear_operator_from_parts(
        tuple(jnp.asarray(p) for p in parts), pc_name, dtype=jdt)
    mv_t, pc_t = st.system.linear_operator_from_parts(
        tuple(torch.as_tensor(p) for p in parts), pc_name, dtype=tdt)
    for fj, ft in ((mv_j, mv_t), (pc_j, pc_t)):
        yj = np.asarray(fj(jnp.asarray(v)))
        yt = ft(torch.as_tensor(v))
        assert yt.dtype == torch.as_tensor(v).dtype
        if dtype == "f64":
            np.testing.assert_allclose(np_(yt), yj, rtol=1e-12, atol=1e-9)
        else:
            np.testing.assert_allclose(np_(yt), yj, rtol=2e-5,
                                       atol=2e-4 * np.abs(yj).max())


def test_minc_step_matches_jax(sims):
    import jax.numpy as jnp
    from waiwera_tpu.solver.newton import NewtonParams as JParams
    from waiwera_tpu_torch.solver.newton import NewtonParams as TParams

    sj, st = sims
    kw = dict(max_iterations=8, min_iterations=1, linear_dtype="float32",
              jacobian_dtype="float32")
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
    lin_j = int(rj.linear_iterations)
    assert abs(rt.linear_iterations - lin_j) <= max(2, 0.1 * lin_j)
    np.testing.assert_array_equal(np_(rt.region), np.asarray(rj.region))
    np.testing.assert_allclose(np_(rt.y), np.asarray(rj.y), rtol=2e-5,
                               atol=2e-5)
