"""The plain reference against the port on small boxes, and the check
that decides `correct` driven through the harness on the CPU: sound
runs pass; the control (the reference in f32 in the program's place)
and each fault planted in the timed path fail."""

import copy
import math
import re
import time
from pathlib import Path

import pytest
import torch

from perfbench.lib import harness
from perfbench.reference import flow

ROOT = Path(__file__).resolve().parents[2]
SEED = 2**31 + 12345


def _model(grid, steps):
    wl = harness.load_workload("box-ramp", ROOT / "perfbench")
    cfg = harness.config_module("box-wge-524k", ROOT / "perfbench")
    model = harness.model_for(wl, cfg, SEED, grid)
    model["time"]["step"]["maximum"]["number"] = steps
    return model


def _port_steps(model):
    """The port's accepted steps (y0, region0, y1, region1, dt) and its
    Simulation."""
    from waiwera_tpu_torch.sim.simulation import Simulation
    from waiwera_tpu_torch.sim.timestepper import Timestepper
    from waiwera_tpu_torch.utils.logging import Logger

    sim = Simulation(copy.deepcopy(model), device="cpu")
    ts = Timestepper(model, sim, logger=Logger())
    inner, steps = ts.step_fn, []

    def step(*args, **kwargs):
        out = inner(*args, **kwargs)
        res = out[0]
        if bool(res.converged) and not bool(res.failed):
            steps.append((args[0], args[1], res.y, res.region,
                          float(args[6])))
        return out

    for attr in ("program_mode", "stats"):
        setattr(step, attr, getattr(inner, attr))
    ts.step_fn = step
    assert ts.run()
    return sim, steps


def test_residual_matches_port():
    """The reference's balances and residual at every state the port's
    Newton accepted (liquid and two-phase cells), against the port's
    own, to round-off of the balances."""
    from waiwera_tpu_torch.solver.system import method_coeffs

    model = _model((6, 5, 4), 6)
    sim, steps = _port_steps(model)
    box = flow.WGEBox(model)
    n = box.n
    regions = set()
    y, region = box.initial_state()
    assert torch.equal(y, sim.y0[:n]) and torch.equal(region,
                                                      sim.region0[:n].long())
    for y0, r0, y1, r1, dt in steps:
        fl0, _, _ = sim.system.derived_state(y0, r0, sim.rock)
        L0 = sim.system.lhs(fl0, sim.rock)
        r, _, _, _ = sim.system.residual(
            y1, r1, sim.rock, method_coeffs("beuler", dt, dt, 0.0, L0, L0),
            0.0, dt)
        ref_r, ref_L0, bad = box.residual(y1[:n], r1[:n], y0[:n], r0[:n], dt)
        scale = torch.clamp_min(L0[:n].abs(), 1.0)
        assert not bool(bad.any())
        assert float(((ref_L0 - L0[:n]).abs() / scale).max()) < 1e-13
        assert float(((ref_r - r[:n]).abs() / scale).max()) < 1e-13
        regions |= set(r1[:n].tolist())
    assert regions == {1, 4}


@pytest.mark.parametrize("region", [1, 2, 4])
def test_fluid_matches_port(region):
    """Density, viscosity, enthalpy, internal energy and air mass
    fraction of each phase in each region, at states drawn across the
    range the cells reach."""
    from waiwera_tpu_torch.physics.state import default_rock
    from waiwera_tpu_torch.sim.simulation import Simulation

    model = _model((3, 2, 2), 1)
    sim = Simulation(copy.deepcopy(model), device="cpu")
    g = torch.Generator().manual_seed(region)
    n = 64
    p = 1e5 + 9e6 * torch.rand(n, generator=g, dtype=torch.float64)
    if region == 4:
        second = torch.rand(n, generator=g, dtype=torch.float64)
        pg = p * 0.5 * torch.rand(n, generator=g, dtype=torch.float64)
    else:
        second = 15.0 + 260.0 * torch.rand(n, generator=g,
                                            dtype=torch.float64)
        pg = p * 0.3 * torch.rand(n, generator=g, dtype=torch.float64)
    if region == 2:
        p = 2e3 + 4e5 * torch.rand(n, generator=g, dtype=torch.float64)
        second = 150.0 + 150.0 * torch.rand(n, generator=g,
                                             dtype=torch.float64)
        pg = p * torch.rand(n, generator=g, dtype=torch.float64)
    primary = torch.stack([p, second, pg], 1)
    reg = torch.full((n,), region, dtype=torch.int32)
    port, err = sim.eos.properties(primary, reg, default_rock(n))
    box = flow.WGEBox(model)
    ref = box.fluid(primary, reg)
    assert torch.equal(err, ref.bad)
    for mine, theirs in ((ref.rho, port.density), (ref.visc, port.viscosity),
                         (ref.h, port.specific_enthalpy),
                         (ref.u, port.internal_energy),
                         (ref.mass_frac, port.mass_fraction),
                         (ref.t, port.temperature), (ref.sat, port.saturation)):
        assert torch.allclose(mine, theirs, rtol=1e-12, atol=0.0)


def test_reference_refuses_what_it_does_not_cover():
    model = _model((3, 2, 2), 1)
    for key, value in (("tracer", {"name": "t"}),
                       ("rock", {"capillary_pressure": {"type": "linear"}}),
                       ("eos", {"name": "we"})):
        with pytest.raises(flow.Unsupported):
            flow.WGEBox(dict(model, **{key: value}))


GRID = (5, 4, 3)


def _run(fault=None, control=False, steps=2, seconds=1.0):
    return harness.run_cell(ROOT, "box-ramp", SEED, seconds, False,
                            time.perf_counter(), device="cpu", grid=GRID,
                            fault=fault, control=control,
                            episode_steps=steps, log=lambda *a, **k: None)


def test_sound_run_is_correct():
    result, checks = _run()
    assert result["correct"], checks
    assert list(result)[-1] == "checks"
    assert checks["records"][0] < 1e-13
    assert checks["residual"][0] < checks["residual"][1]


def test_control_fails():
    result, checks = _run(control=True)
    assert not result["correct"]
    assert checks["records"][0] > checks["records"][1]


def _unchanged(args, out):
    return (out[0]._replace(y=args[0], region=args[1]),) + tuple(out[1:])


def _half_left_out(args, out):
    y = out[0].y.clone()
    y[y.shape[0] // 2:] = args[0][y.shape[0] // 2:]
    return (out[0]._replace(y=y),) + tuple(out[1:])


def _altered(args, out):
    y = out[0].y.clone()
    y[7, 0] = y[7, 0] * (1.0 + 1e-4)
    return (out[0]._replace(y=y),) + tuple(out[1:])


@pytest.mark.parametrize("fault", [_unchanged, _half_left_out, _altered],
                         ids=["unchanged", "half", "altered"])
def test_fault_fails(fault):
    result, checks = _run(fault=fault)
    assert not result["correct"], checks
    assert checks["residual"][0] > checks["residual"][1] or \
        math.isinf(checks["residual"][0])


def test_history_cell_from_data(tmp_path):
    """A cell added as data only, with a fixed step, the window closed
    after the step in flight and source records every step: the check
    judges the sampled steps' records, and the run is correct."""
    import json
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    wl = json.loads((ROOT / "perfbench/workloads/box-ramp.json").read_text())
    wl["episode"] = {"method": "beuler", "size": 1000.0,
                     "adapt": {"on": False},
                     "maximum": {"number": 3, "tries": 10}}
    wl["output"].update(frequency=1, source_fields="step")
    wl["window_ends"] = "step"
    (tmp_path / "perfbench/workloads/box-fixed.json").write_text(
        json.dumps(wl))
    m = json.loads((tmp_path / "BENCHMARK.json").read_text())
    m["workloads"].append({"name": "box-fixed", "config": "box-wge-524k",
                           "traffic": "box-fixed", "chips": 1,
                           "why": "a test cell"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(m))
    lines = []
    result, checks = harness.run_cell(
        tmp_path, "box-fixed", SEED, 1.0, False, time.perf_counter(),
        device="cpu", grid=GRID,
        log=lambda *a, **k: lines.append(" ".join(map(str, a))))
    assert result["correct"], checks
    compared = next(x for x in lines if x.startswith("compared"))
    steps, datasets = (int(w) for w in re.findall(
        r"(\d+) accepted steps' residuals, (\d+) output datasets",
        compared)[0])
    # 5 source datasets a sampled step, 18 at a complete episode's end
    assert steps >= 1 and datasets in (5 * steps, 5 * steps + 18), compared
