"""The timestepper state machine of waiwera_tpu_torch: the manufactured
decay ODE cases of tests/test_timestepper.py with a torch DecaySim, and,
for each of their configurations, the port's and the JAX package's
Timestepper side by side: the same tried step sizes, the same log
messages (statuses, tries, sizes, accepted times) in the same order,
floats equal to 1e-12 relative, and the same final state."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from test_timestepper import DecaySim as JaxDecaySim
from torch_parity import RecordingLogger, assert_same_records, np_


class DecaySim:
    """Manufactured ODE d/dt y = -lam*y (L = y, R = -lam*y) for the
    port's Timestepper: the implicit update solves
    c_lhs*y + const + dt_eff*lam*y = 0 exactly, through the port's
    method_coeffs. iterations may be a function of dt."""

    def __init__(self, lam=1.0, y0=1.0, fail_if_dt_above=None,
                 iterations=3):
        self.lam = lam
        self.y0 = torch.tensor([[float(y0)]], dtype=torch.float64)
        self.region0 = torch.tensor([1], dtype=torch.int32)
        self.mesh_dev = SimpleNamespace(is_ghost=torch.tensor([False]))
        self.sources = None
        self.tracers = None
        self.config = {}
        self.fail_if_dt_above = fail_if_dt_above
        self.iterations = iterations
        self.tried_dts = []

    def lhs_at(self, y, region):
        fluid = SimpleNamespace(temperature=torch.zeros(1))
        return y, fluid, torch.tensor([False])

    def make_step_fn(self, params, method="beuler"):
        from waiwera_tpu_torch.solver.newton import NewtonResult
        from waiwera_tpu_torch.solver.system import method_coeffs

        def step(y, region, temperature, lhs_last, lhs_last2, t_last,
                 dt, dt_last, first):
            self.tried_dts.append(float(dt))
            c = method_coeffs(method, dt, dt_last, first, lhs_last,
                              lhs_last2)
            ynew = -c.const / (c.c_lhs + c.dt_eff * self.lam)
            its = (self.iterations(float(dt)) if callable(self.iterations)
                   else self.iterations)
            res = NewtonResult(
                y=ynew, region=region, iterations=its,
                converged=not (self.fail_if_dt_above is not None
                               and float(dt) > self.fail_if_dt_above),
                failed=False, max_residual=torch.tensor(0.0),
                linear_iterations=0, worst_cell=torch.tensor(0),
                worst_equation=torch.tensor(0), host_syncs=0, matvecs=0,
            )
            return (res, SimpleNamespace(temperature=temperature), ynew,
                    torch.zeros((1, 1)))

        return step


def _config(**step):
    return {"time": {"stop": step.pop("stop", None), "step": step}}


def _run(cfg, **sim_kw):
    from waiwera_tpu_torch.sim.timestepper import Timestepper

    sim = DecaySim(**sim_kw)
    ts = Timestepper(cfg, sim, logger=RecordingLogger())
    return sim, ts, ts.run()


def _final(ts):
    return float(np_(ts.final_y)[0, 0])


# name -> (config, DecaySim arguments); iterations given as a pair
# (threshold, above, below) vary with dt as in the adaptive reduction case
_CHECKPOINTS = {"initial": False, "final": False}
CASES = {
    "beuler_exact": (
        _config(size=0.1, stop=1.0, maximum={"number": 100}),
        dict(lam=0.7)),
    "bdf2_dt_0.05": (
        _config(size=0.05, stop=1.0, method="bdf2",
                maximum={"number": 1000}), {}),
    "bdf2_dt_0.025": (
        _config(size=0.025, stop=1.0, method="bdf2",
                maximum={"number": 1000}), {}),
    "retry_ladder": (
        _config(size=0.5, stop=1.0, maximum={"number": 5}),
        dict(fail_if_dt_above=0.05)),
    "abort_after_max_tries": (
        _config(size=1.0, stop=10.0, maximum={"number": 5, "tries": 4}),
        dict(fail_if_dt_above=0.0)),
    "fixed_then_adaptive": (
        _config(size=[0.1, 0.2, 0.3], stop=10.0,
                adapt={"on": True, "minimum": 5, "maximum": 8,
                       "amplification": 2.0},
                maximum={"number": 6}),
        dict(iterations=2)),
    "adaptive_reduction": (
        _config(size=0.1, stop=1.0,
                adapt={"on": True, "minimum": 5, "maximum": 8,
                       "reduction": 0.2},
                maximum={"number": 3}),
        dict(iterations=(0.05, 9, 6))),
    "checkpoints": (
        {"time": {"stop": 1.0,
                  "step": {"size": 0.15, "maximum": {"number": 50}}},
         "output": dict(_CHECKPOINTS, checkpoint={"time": [0.2, 0.5]})},
        {}),
    "checkpoint_repeat": (
        {"time": {"stop": 2.0,
                  "step": {"size": 0.3, "maximum": {"number": 50}}},
         "output": dict(_CHECKPOINTS,
                        checkpoint={"time": [0.4, 0.8], "repeat": 2})},
        {}),
    "stop_time": (
        _config(size=0.4, stop=1.0, maximum={"number": 50}), {}),
    "directss": (
        {"time": {"step": {"method": "directss", "size": 0.0}}}, {}),
    "change_monitor": (
        _config(size=0.05, stop=3.0,
                adapt={"on": True, "method": "change", "minimum": 0.01,
                       "maximum": 0.08},
                maximum={"number": 12, "size": 0.5}), {}),
}


def _sim_kw(kw):
    kw = dict(kw)
    its = kw.get("iterations")
    if isinstance(its, tuple):
        limit, above, below = its
        kw["iterations"] = lambda dt: above if dt > limit else below
    return kw


def _case(name):
    cfg, kw = CASES[name]
    return _run(cfg, **_sim_kw(kw))


def test_backward_euler_exact_discrete_solution():
    sim, ts, ok = _case("beuler_exact")
    assert ok
    np.testing.assert_allclose(_final(ts), 1.0 / (1.0 + 0.7 * 0.1) ** 10,
                               rtol=1e-12)
    assert ts.taken == 10
    np.testing.assert_allclose(ts.final_time, 1.0, rtol=1e-12)


def test_bdf2_second_order_convergence():
    """The BDF2 error on dy/dt = -y over [0, 1] shrinks ~4x when dt
    halves."""
    errs = {}
    for dt in ("0.05", "0.025"):
        _, ts, ok = _case(f"bdf2_dt_{dt}")
        assert ok
        errs[dt] = abs(_final(ts) - np.exp(-1.0))
    assert 3.3 < errs["0.05"] / errs["0.025"] < 4.7, errs


def test_retry_ladder_reduces_stepsize():
    sim, ts, ok = _case("retry_ladder")
    assert ok
    np.testing.assert_allclose(sim.tried_dts[:3], [0.5, 0.1, 0.02])
    assert ts.taken >= 1
    assert ts.stats["tries"] == len(sim.tried_dts)


def test_retry_ladder_aborts_after_max_tries():
    sim, ts, ok = _case("abort_after_max_tries")
    assert not ok and ts.aborted
    np.testing.assert_allclose(sim.tried_dts, [1.0, 0.2, 0.04, 0.008])
    assert ts.log.events("timestep", "aborted") == [{"num_tries": 4}]


def test_fixed_sequence_then_fall_over_to_adaptive():
    sim, ts, ok = _case("fixed_then_adaptive")
    assert ok
    np.testing.assert_allclose(sim.tried_dts[:5],
                               [0.1, 0.2, 0.3, 0.6, 1.2])


def test_adaptive_reduction_when_iterations_high():
    sim, ts, ok = _case("adaptive_reduction")
    assert ok
    assert sim.tried_dts[0] == pytest.approx(0.1)
    assert sim.tried_dts[1] == pytest.approx(0.02)
    assert ts.final_time <= 1.0


def test_checkpoints_hit_exact_times_and_restore():
    sim, ts, ok = _case("checkpoints")
    assert ok
    times = np.cumsum(sim.tried_dts)
    assert np.any(np.isclose(times, 0.2)) and np.any(np.isclose(times, 0.5))
    i = int(np.argmin(np.abs(times - 0.2)))
    assert sim.tried_dts[i + 1] == pytest.approx(0.15)


def test_checkpoint_repeat_cycles():
    sim, ts, ok = _case("checkpoint_repeat")
    assert ok
    times = np.cumsum(sim.tried_dts)
    for t_chk in (0.4, 0.8, 1.2, 1.6):
        assert np.any(np.isclose(times, t_chk)), (t_chk, times)


def test_stop_time_exact_landing():
    sim, ts, ok = _case("stop_time")
    assert ok
    np.testing.assert_allclose(ts.final_time, 1.0, rtol=1e-12)
    np.testing.assert_allclose(sum(sim.tried_dts), 1.0, rtol=1e-12)


def test_direct_steady_state_single_step():
    sim, ts, ok = _case("directss")
    assert ok and ts.taken == 1
    np.testing.assert_allclose(np_(ts.final_y), 0.0, atol=1e-14)


def test_checkpoint_without_output_advances():
    """A checkpoint that is hit with no output attached still advances:
    no later try has dt = 0."""
    sim, ts, ok = _case("checkpoints")
    assert ok and min(sim.tried_dts) > 0.0
    assert ts.checkpoints.done


def _jax_run(cfg, kw):
    from waiwera_tpu.sim.timestepper import Timestepper

    kw = _sim_kw(kw)
    its = kw.pop("iterations", 3)
    sim = JaxDecaySim(iterations=3 if callable(its) else its, **kw)
    if callable(its):
        make = sim.make_step_fn

        def make_step_fn(params, method="beuler"):
            inner = make(params, method)

            def step(*args):
                sim.iterations = its(float(args[6]))
                return inner(*args)

            return step

        sim.make_step_fn = make_step_fn
    ts = Timestepper(cfg, sim, logger=RecordingLogger())
    return sim, ts, ts.run()


@pytest.mark.parametrize("name", list(CASES))
def test_same_sequence_as_jax(name):
    cfg, kw = CASES[name]
    sim_t, ts_t, ok_t = _run(cfg, **_sim_kw(kw))
    sim_j, ts_j, ok_j = _jax_run(cfg, kw)
    assert ok_t == ok_j and ts_t.aborted == ts_j.aborted
    assert len(sim_t.tried_dts) == len(sim_j.tried_dts)
    np.testing.assert_allclose(sim_t.tried_dts, sim_j.tried_dts, rtol=1e-12)
    assert_same_records(ts_t.log, ts_j.log)
    assert ts_t.taken == ts_j.taken
    np.testing.assert_allclose(ts_t.final_time, ts_j.final_time, rtol=1e-12)
    np.testing.assert_allclose(np_(ts_t.final_y), np.asarray(ts_j.final_y),
                               rtol=1e-12, atol=1e-300)
    # what the port's loop records beside the log
    assert [s for s, _, _ in ts_t.accepted] == [
        d["size"] for d in ts_t.log.events("timestep", "end")]
    assert len(ts_t.tried) == ts_t.stats["tries"] == len(sim_t.tried_dts)
