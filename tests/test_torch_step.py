"""The whole implicit timestep of waiwera_tpu_torch against waiwera_tpu:
the flagship model's configuration (f32 Jacobian, f32 BiCGStab with
block-Jacobi) on a small box, three consecutive steps.

Step 1 starts both packages from the same initial state. Steps 2 and 3
start the port from the JAX package's previous accepted state, carried
across with state_from_numpy and entering through the initial= path
(fluid_last/fluxes_last). Per step: equal converged, failed, Newton
iterations and regions; Krylov iterations within 2 (f32 dot products
sum in another order); y within rtol 2e-5, atol 2e-5
(tests/test_solver.py:966).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import jax_sim, np_, torch_sim

DTS = (1.0e4, 1.0e3, 1.0e3)


def _params(module):
    return module.NewtonParams(
        max_iterations=8, min_iterations=1, linear_dtype="float32",
        jacobian_dtype="float32",
    )


@pytest.fixture(scope="module")
def runs():
    from waiwera_tpu.solver import newton as jnewton
    from waiwera_tpu_torch.sim.simulation import state_from_numpy
    from waiwera_tpu_torch.solver import newton as tnewton

    sj, st = jax_sim(), torch_sim()
    step_j = sj.make_step_fn(_params(jnewton), "beuler")
    step_t = st.make_step_fn(_params(tnewton), "beuler")

    # step 1 from the initial state, without carried state
    lhs_j, fluid_j, _ = sj.lhs_at(sj.y0, sj.region0)
    lhs_t, fluid_t, _ = st.lhs_at(st.y0, st.region0)
    t = 0.0
    dt = DTS[0]
    # (the JAX step takes its carried-state path here too, which gives
    # the same residual, so that its step function compiles once)
    out_j = step_j(sj.y0, sj.region0, fluid_j.temperature, lhs_j, lhs_j,
                   jnp.asarray(t), jnp.asarray(dt), jnp.asarray(dt),
                   jnp.asarray(1.0), fluid_last=fluid_j,
                   fluxes_last=sj.initial_fluxes(sj.y0, sj.region0))
    out_t = step_t(st.y0, st.region0, fluid_t.temperature, lhs_t, lhs_t,
                   t, dt, dt, 1.0)
    results = [(out_j[0], out_t[0])]
    t += dt

    # steps 2 and 3: the port starts from the JAX package's state
    for dt in DTS[1:]:
        res_j, f_j, l_j, fx_j = out_j
        y, region, temp, lhs, fluid, fx = state_from_numpy(
            np.asarray(res_j.y), np.asarray(res_j.region),
            np.asarray(f_j.temperature), np.asarray(l_j),
            {k: np.asarray(v) for k, v in f_j._asdict().items()},
            np.asarray(fx_j), device="cpu",
        )
        out_t = step_t(y, region, temp, lhs, lhs, t, dt, dt, 0.0,
                       fluid_last=fluid, fluxes_last=fx)
        out_j = step_j(res_j.y, res_j.region, f_j.temperature, l_j, l_j,
                       jnp.asarray(t), jnp.asarray(dt), jnp.asarray(dt),
                       jnp.asarray(0.0), fluid_last=f_j, fluxes_last=fx_j)
        results.append((out_j[0], out_t[0]))
        t += dt
    return results


@pytest.mark.parametrize("k", [0, 1, 2], ids=["step1", "step2", "step3"])
def test_step_matches_jax(runs, k):
    rj, rt = runs[k]
    assert rt.converged == bool(rj.converged)
    assert rt.failed == bool(rj.failed)
    assert rt.converged and not rt.failed
    assert rt.iterations == int(rj.iterations)
    assert abs(rt.linear_iterations - int(rj.linear_iterations)) <= 2
    assert rt.region.dtype == torch.int32
    np.testing.assert_array_equal(np_(rt.region), np.asarray(rj.region))
    y = np_(rt.y)
    assert y.dtype == np.float64 and np.all(np.isfinite(y))
    np.testing.assert_allclose(y, np.asarray(rj.y), rtol=2e-5, atol=2e-5)
    # the host reads the flags once before the loop, once per BiCGStab
    # chunk and round, and once per Newton iteration (not per BiCGStab
    # iteration)
    from waiwera_tpu_torch.solver import krylov

    run = rt.linear_iterations + rt.masked_iterations
    assert run % krylov.CHUNK == 0 and rt.masked_iterations < (
        krylov.CHUNK * rt.iterations * krylov.MAX_ROUNDS)
    chunks = run // krylov.CHUNK
    assert 1 + chunks + 2 * rt.iterations <= rt.host_syncs <= (
        1 + chunks + (1 + krylov.MAX_ROUNDS) * rt.iterations)


def test_two_phase_cells_appear(runs):
    """The steps exercise the region transitions (1 -> 4)."""
    assert 4 in set(np_(runs[-1][1].region).tolist())


def test_f64_step_matches_jax():
    """The f64/f64 policy of the bench's dtype table (f64 Jacobian, f64
    BiCGStab: the f64 band SpMV) on the small box, from the initial state:
    equal converged flag, Newton iterations and regions; BiCGStab
    iterations within 2 (summation order); y within rtol 1e-8, atol 1e-8
    (the f64 solves agree far below the BiCGStab tolerance)."""
    from waiwera_tpu.solver import newton as jnewton
    from waiwera_tpu_torch.solver import newton as tnewton

    sj, st = jax_sim(), torch_sim()
    kw = dict(max_iterations=8, min_iterations=1, linear_dtype="float64",
              jacobian_dtype="float64")
    dt = DTS[0]
    lhs_j, fluid_j, _ = sj.lhs_at(sj.y0, sj.region0)
    lhs_t, fluid_t, _ = st.lhs_at(st.y0, st.region0)
    rj = sj.make_step_fn(jnewton.NewtonParams(**kw), "beuler")(
        sj.y0, sj.region0, fluid_j.temperature, lhs_j, lhs_j,
        jnp.asarray(0.0), jnp.asarray(dt), jnp.asarray(dt), jnp.asarray(1.0),
        fluid_last=fluid_j, fluxes_last=sj.initial_fluxes(sj.y0, sj.region0),
    )[0]
    rt = st.make_step_fn(tnewton.NewtonParams(**kw), "beuler")(
        st.y0, st.region0, fluid_t.temperature, lhs_t, lhs_t, 0.0, dt, dt,
        1.0,
    )[0]
    assert rt.converged == bool(rj.converged) and rt.converged
    assert rt.iterations == int(rj.iterations)
    assert abs(rt.linear_iterations - int(rj.linear_iterations)) <= 2
    np.testing.assert_array_equal(np_(rt.region), np.asarray(rj.region))
    np.testing.assert_allclose(np_(rt.y), np.asarray(rj.y), rtol=1e-8,
                               atol=1e-8)


def test_state_from_numpy_takes_the_card_by_default(monkeypatch):
    """state_from_numpy and timestepper_state_from_numpy without a device
    take the CUDA device, as Simulation does, and raise where there is
    none (no fall-back to the CPU); device="cpu" still works."""
    from waiwera_tpu_torch.physics.state import FluidState
    from waiwera_tpu_torch.sim.simulation import (
        state_from_numpy,
        timestepper_state_from_numpy,
    )

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    y, region = np.ones((4, 3)), np.ones(4, np.int32)
    fluid = {k: np.ones(4) for k in FluidState._fields}
    args = (y, region, np.ones(4), y, fluid, np.ones((5, 3)))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        timestepper_state_from_numpy(y, region)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        state_from_numpy(*args)
    y_t, region_t = timestepper_state_from_numpy(y, region, device="cpu")
    assert (y_t.device.type, y_t.dtype, region_t.dtype) == (
        "cpu", torch.float64, torch.int32)
    out = state_from_numpy(*args, device="cpu")
    assert all(t.device.type == "cpu" for t in out[:4])
