"""Whole model runs of waiwera_tpu_torch against waiwera_tpu: the flagship
configuration on a 5 x 4 x 3 box, mesh built from the config, through
both packages' Timestepper, for backward Euler, BDF2 and direct steady
state, with adaptive stepping, a checkpoint list with repeat, a stop
time and a limit on tries.

f64 Jacobian and f64 BiCGStab: the same tries, step sizes and statuses
(log messages equal in order, times and sizes to 1e-12 relative,
BiCGStab iteration totals within 2 per try, residual norms to rtol 1e-3
plus 1e-9: a converged norm is round-off of a solve to 1e-5); final
scaled primaries within rtol 1e-8 and atol 1e-8 per variable (pressure
in MPa, temperature in 100 K or saturation, gas pressure as a fraction
of the pressure). f32 Jacobian and f32 BiCGStab: final primaries within
rtol 2e-5, atol 2e-4 (tests/test_solver.py:723), and the same accepted
steps.

Each package compiles or builds one step function per method and
precision; the cases share them.
"""

import copy

import numpy as np
import pytest

from torch_parity import (RecordingLogger, assert_same_records, model_config,
                          np_)

F64 = {"dtype": "float64", "jacobian_dtype": "float64"}
F32 = {"dtype": "float32", "jacobian_dtype": "float32"}
LOOSE = {"linear_iterations": 2, "max_residual": (1e-3, 1e-9),
         "worst_cell": 10 ** 9, "worst_equation": 3}


def _time(method, linear, size=1.0e3, stop=None, number=6, tries=10,
          adapt=True):
    step = {
        "method": method, "size": size,
        "maximum": {"number": number, "tries": tries},
        "solver": {"nonlinear": {"minimum": {"iterations": 1}},
                   "linear": dict(linear)},
    }
    if adapt:
        step["adapt"] = {"on": True, "minimum": 3, "maximum": 7}
    return {"stop": stop, "step": step}


OUTPUT = {"initial": False, "final": False,
          "checkpoint": {"time": [2.0e3, 6.0e3], "repeat": 2}}

# name -> (method, precision, time section, output section)
CASES = {
    "beuler_f64": ("beuler", "f64", _time("beuler", F64, stop=1.3e4,
                                          number=12), OUTPUT),
    "bdf2_f64": ("bdf2", "f64", _time("bdf2", F64, stop=3.0e3, number=8),
                 OUTPUT),
    "directss_f64": ("directss", "f64", _time("directss", F64, size=0.0),
                     {}),
    "aborted_f64": ("beuler", "f64", _time("beuler", F64, size=1.0e7,
                                           tries=2, adapt=False), {}),
    "beuler_f32": ("beuler", "f32", _time("beuler", F32, number=5), OUTPUT),
}


class _Runner:
    """Builds each package's simulation once and one step function per
    (method, precision); every run gets a new Timestepper over them."""

    def __init__(self):
        from waiwera_tpu.sim.simulation import Simulation as JSim
        from waiwera_tpu_torch.sim.simulation import Simulation as TSim

        self.cfg = model_config()
        self.sim_j = JSim(copy.deepcopy(self.cfg))
        self.sim_t = TSim(copy.deepcopy(self.cfg), device="cpu")
        self.initial_j = (self.sim_j.y0, self.sim_j.region0)
        self.initial_t = (self.sim_t.y0, self.sim_t.region0)
        self.steps = {}

    def timestepper(self, which, key, time_cfg, output_cfg, output=None):
        if which == "jax":
            from waiwera_tpu.sim.timestepper import Timestepper
            sim = self.sim_j
        else:
            from waiwera_tpu_torch.sim.timestepper import Timestepper
            sim = self.sim_t
        cfg = dict(self.cfg, time=time_cfg, output=output_cfg)
        ts = Timestepper(cfg, sim, output=output, logger=RecordingLogger())
        ts.step_fn = self.steps.setdefault((which, key), ts.step_fn)
        return ts

    def reset(self):
        self.sim_j.y0, self.sim_j.region0 = self.initial_j
        self.sim_t.y0, self.sim_t.region0 = self.initial_t

    def run(self, name):
        method, prec, time_cfg, output_cfg = CASES[name]
        self.reset()
        out = []
        for which in ("jax", "torch"):
            ts = self.timestepper(which, (method, prec), time_cfg,
                                  output_cfg)
            out.append((ts, ts.run()))
        return out


@pytest.fixture(scope="module")
def runner():
    return _Runner()


@pytest.fixture(scope="module")
def runs(runner):
    return {}


def _get(runner, runs, name):
    if name not in runs:
        runs[name] = runner.run(name)
    return runs[name]


@pytest.mark.parametrize("name", ["beuler_f64", "bdf2_f64", "directss_f64",
                                  "aborted_f64"])
def test_f64_run_matches_jax(runner, runs, name):
    (tj, ok_j), (tt, ok_t) = _get(runner, runs, name)
    assert ok_t == ok_j and tt.aborted == tj.aborted
    assert_same_records(tt.log, tj.log, loose=LOOSE)
    assert tt.taken == tj.taken
    if name == "aborted_f64":
        assert tt.aborted and tt.taken == 0
        assert tt.log.events("timestep", "aborted") == [{"num_tries": 2}]
        return
    np.testing.assert_allclose(tt.final_time, tj.final_time, rtol=1e-12)
    np.testing.assert_array_equal(np_(tt.final_region),
                                  np.asarray(tj.final_region))
    np.testing.assert_allclose(np_(tt.final_y), np.asarray(tj.final_y),
                               rtol=1e-8, atol=1e-8)


def test_f64_runs_exercise_the_state_machine(runner, runs):
    """The backward Euler case refuses tries, hits both checkpoints of
    both repeats exactly and lands on the stop time; BDF2 leaves backward
    Euler's path after the first step."""
    (_, _), (tt, ok) = _get(runner, runs, "beuler_f64")
    assert ok
    assert tt.log.events("timestep", "reduction")
    times = [t for _, t, _ in tt.accepted]
    for chk in (2.0e3, 6.0e3, 8.0e3, 1.2e4):
        assert chk in times, (chk, times)
    assert tt.final_time == 1.3e4
    statuses = {s for _, _, s in tt.accepted}
    assert {"restore", "final"} <= statuses
    (_, _), (tb, _) = _get(runner, runs, "bdf2_f64")
    assert not np.allclose(np_(tb.final_y), np_(tt.final_y), rtol=1e-6,
                           atol=1e-9)


def test_f32_run_matches_jax(runner, runs):
    (tj, ok_j), (tt, ok_t) = _get(runner, runs, "beuler_f32")
    assert ok_t and ok_j
    ends_t = tt.log.events("timestep", "end")
    ends_j = tj.log.events("timestep", "end")
    assert [(e["tries"], e["status"]) for e in ends_t] == [
        (e["tries"], e["status"]) for e in ends_j]
    np.testing.assert_allclose([e["time"] for e in ends_t],
                               [e["time"] for e in ends_j], rtol=1e-12)
    np.testing.assert_array_equal(np_(tt.final_region),
                                  np.asarray(tj.final_region))
    np.testing.assert_allclose(np_(tt.final_y), np.asarray(tj.final_y),
                               rtol=2e-5, atol=2e-4)


def test_port_continues_from_a_jax_state(runner, runs):
    """The port's Timestepper started from the JAX package's final state
    (carried across with timestepper_state_from_numpy) takes the steps
    that the JAX package takes from there."""
    from waiwera_tpu_torch.sim.simulation import timestepper_state_from_numpy

    (tj, _), _ = _get(runner, runs, "beuler_f64")
    time_cfg = _time("beuler", F64, size=5.0e2, stop=2.0e4, number=4)
    time_cfg["start"] = float(tj.final_time)
    runner.reset()
    runner.sim_j.y0, runner.sim_j.region0 = tj.final_y, tj.final_region
    runner.sim_t.y0, runner.sim_t.region0 = timestepper_state_from_numpy(
        np.asarray(tj.final_y), np.asarray(tj.final_region), device="cpu")
    assert runner.sim_t.y0.dtype == runner.initial_t[0].dtype
    assert runner.sim_t.region0.dtype == runner.initial_t[1].dtype
    out = []
    for which in ("jax", "torch"):
        ts = runner.timestepper(which, ("beuler", "f64"), time_cfg, {})
        assert ts.run()
        out.append(ts)
    runner.reset()
    cj, ct = out
    assert_same_records(ct.log, cj.log, loose=LOOSE)
    assert ct.taken == cj.taken and ct.taken > 0
    np.testing.assert_allclose(np_(ct.final_y), np.asarray(cj.final_y),
                               rtol=1e-8, atol=1e-8)


def test_timestepper_host_syncs_are_counted(runner, runs):
    """The loop adds one transfer per try (and one initial check); the
    rest are the step function's own: one per try, one per Newton
    iteration, one per BiCGStab chunk and one per round (not one per
    BiCGStab iteration)."""
    from waiwera_tpu_torch.solver import krylov

    _, (tt, _) = _get(runner, runs, "beuler_f64")
    st = tt.stats
    assert st["host_syncs_timestepper"] == st["tries"] + 1
    run = st["linear_iterations"] + st["masked_krylov_iterations"]
    assert run % krylov.CHUNK == 0
    chunks = run // krylov.CHUNK
    newton = st["newton_iterations"]
    assert st["tries"] + chunks + 2 * newton <= st["host_syncs_step"] <= (
        st["tries"] + chunks + (1 + krylov.MAX_ROUNDS) * newton)
    assert st["matvecs"] >= 2 * st["linear_iterations"]


@pytest.mark.cuda
def test_timestepper_on_the_card_matches_the_cpu():
    """The small box through the Timestepper on the card and on the CPU:
    the same tries and sizes, y within rtol 2e-5, atol 2e-5."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from waiwera_tpu_torch.sim.simulation import Simulation
    from waiwera_tpu_torch.sim.timestepper import Timestepper

    cfg = model_config(time=_time("beuler", F32, stop=1.3e4, number=12),
                       output=OUTPUT)
    out = []
    for device in (None, "cpu"):
        ts = Timestepper(cfg, Simulation(copy.deepcopy(cfg), device=device),
                         logger=RecordingLogger())
        assert ts.run()
        out.append(ts)
    card, cpu = out
    assert card.sim.device.type == "cuda"
    np.testing.assert_allclose([d for d, _ in card.tried],
                               [d for d, _ in cpu.tried], rtol=1e-12)
    assert [c for _, c in card.tried] == [c for _, c in cpu.tried]
    np.testing.assert_allclose(np_(card.final_y), np_(cpu.final_y),
                               rtol=2e-5, atol=2e-5)
