"""The timestep try's pieces through solver/program.py with a stand-in
for CUDA graphs on the CPU (EmulatedGraphs: a capture learns a piece's
outputs and undoes its writes; a replay runs it again and writes its
results into the captured tensors, the tensors its closures hold
included, as a replayed graph writes the same memory), under a guard
that fails on what a capture cannot hold (a host read, a tensor made
from host data, an index by a list, a mask or a 0-d tensor): launches
counted per replay, the argument checks, and whole Timestepper runs of
the flagship box (refused tries; BDF2 at two first step sizes through
one captured program) bitwise equal to the same runs eagerly, with
equal counts. The CPU itself is always eager.
"""

import contextlib

import pytest
import torch

from torch_parity import RecordingLogger, build_sim


@contextlib.contextmanager
def no_host_reads():
    """Fail on what a CUDA graph capture cannot hold: a value read on the
    host, a tensor made from host data or written with a Python number,
    an index by a list or by a boolean mask (a device-to-host count)."""
    def refuse(what):
        def fn(*a, **k):
            raise AssertionError(f"{what} inside a piece")
        return fn

    def check(idx):
        for p in idx if isinstance(idx, tuple) else (idx,):
            if isinstance(p, list) or (isinstance(p, torch.Tensor) and (
                    p.dtype == torch.bool or (p.dim() == 0 and not
                                              p.is_floating_point()))):
                raise AssertionError("a list, mask or 0-d tensor index "
                                     "inside a piece")

    def checked(orig):
        def fn(self, idx, *value):
            check(idx)
            if value and not isinstance(value[0], torch.Tensor):
                # a CUDA tensor takes a Python number through a
                # host-to-device copy
                raise AssertionError("a Python number written into a "
                                     "tensor inside a piece")
            return orig(self, idx, *value)
        return fn

    def made(orig):
        def fn(data, *a, **k):
            if not isinstance(data, torch.Tensor):
                raise AssertionError("tensor from host data inside a piece")
            return orig(data, *a, **k)
        return fn

    patches = {
        (torch.Tensor, name): refuse(f"Tensor.{name}")
        for name in ("__bool__", "item", "tolist", "__float__", "__int__",
                     "__index__", "numpy", "cpu", "nonzero")
    }
    patches[(torch.Tensor, "__getitem__")] = checked(torch.Tensor.__getitem__)
    patches[(torch.Tensor, "__setitem__")] = checked(torch.Tensor.__setitem__)
    patches[(torch, "tensor")] = made(torch.tensor)
    patches[(torch, "as_tensor")] = made(torch.as_tensor)
    patches[(torch, "nonzero")] = refuse("torch.nonzero")
    saved = {k: getattr(*k) for k in patches}
    try:
        for (obj, name), fn in patches.items():
            setattr(obj, name, fn)
        yield
    finally:
        for (obj, name), fn in saved.items():
            setattr(obj, name, fn)


def _copy_into(old, new, seen):
    """Write new's tensors into old's: tensors, containers, the tensors
    closed over by functions and those of a bound method's object (a
    replayed graph's memory)."""
    if id(old) in seen or old is new:
        return
    seen.add(id(old))
    if isinstance(old, torch.Tensor):
        old.copy_(new)
    elif isinstance(old, (tuple, list)):
        for a, b in zip(old, new):
            _copy_into(a, b, seen)
    elif hasattr(old, "__self__") and hasattr(old, "__func__"):
        _copy_into(old.__self__, new.__self__, seen)
    elif callable(old) and getattr(old, "__closure__", None):
        for a, b in zip(old.__closure__, new.__closure__):
            _copy_into(a.cell_contents, b.cell_contents, seen)


class EmulatedGraphs:
    """CudaGraphs' stand-in on the CPU."""

    def __init__(self, device=None):
        self.device = device

    def warm(self, fn):
        fn()

    def capture(self, fn, mutated):
        saved = [m.clone() for m in mutated or ()]
        with no_host_reads():
            out = fn()
        for m, s in zip(mutated or (), saved):
            m.copy_(s)
        return (fn, out), out

    def replay(self, graph):
        from waiwera_tpu_torch.ops.dia import LaunchCount

        fn, out = graph
        counts = [c.count for c in LaunchCount.all]
        with no_host_reads():
            new = fn()
        for c, n in zip(LaunchCount.all, counts):
            c.count = n
        _copy_into(out, new, set())


def test_program_counts_launches_per_replay():
    from waiwera_tpu_torch.ops.dia import LaunchCount
    from waiwera_tpu_torch.solver.program import Program

    count = LaunchCount()
    try:
        prog = Program(EmulatedGraphs())
        x = prog.stage("in", torch.arange(4.0))

        def piece(v):
            count.count += 1  # a wrapper launching its kernel
            return v * 2.0

        def body(st, v):
            count.count += 2
            return st + v, st.sum()

        y = prog.run("double", piece, x)
        assert count.count == 1 and prog.captures == 1
        for _ in range(3):
            assert prog.run("double", piece, x) is y
        assert count.count == 4 and prog.replays == 4
        assert torch.equal(y, 2.0 * torch.arange(4.0))
        st = y.clone()
        prog._own([st])
        st2, s = prog.loop("acc", body, st, x)
        assert st2 is st and count.count == 6
        st2, s = prog.loop("acc", body, st, x)
        assert torch.equal(st, 2.0 * torch.arange(4.0) + 2 * torch.arange(4.0))
        assert float(s) == float((2.0 * torch.arange(4.0)
                                  + torch.arange(4.0)).sum())
        # a tensor the program does not own, a changed constant
        with pytest.raises(ValueError, match="captured with"):
            prog.run("double", piece, torch.arange(4.0))
        with pytest.raises(ValueError, match="neither a staged"):
            prog.run("other", piece, torch.arange(4.0))
        prog.run("k", lambda v, c: v * c, x, 1.0)
        with pytest.raises(ValueError, match="constant"):
            prog.run("k", lambda v, c: v * c, x, 2.0)
    finally:
        LaunchCount.all.remove(count)


def _tiny_run(device_graphs, monkeypatch, config, size=(5, 4, 3),
              runs=((1.0e6,),)):
    """Timestepper runs of the flagship box on the CPU, through the graph
    program with EmulatedGraphs or eagerly; one Simulation, so that the
    runs after the first replay the first one's captures."""
    from waiwera_tpu_torch.sim import simulation
    from waiwera_tpu_torch.sim.timestepper import Timestepper
    from waiwera_tpu_torch.solver import program

    if device_graphs:
        monkeypatch.setattr(simulation, "step_program_mode",
                            lambda system, params: "graph")
        monkeypatch.setattr(program, "CudaGraphs", EmulatedGraphs)
    sim = build_sim(*size, "cpu")
    out = []
    for (size0,) in runs:
        cfg = {"time": {"step": dict(config, size=size0)}}
        ts = Timestepper(cfg, sim, logger=RecordingLogger())
        assert ts.run()
        out.append(ts)
    monkeypatch.undo()
    return out


def _same_runs(ga, ea):
    for g, e in zip(ga, ea):
        assert g.tried == e.tried
        assert g.stats["step_program"] == "graph"
        assert e.stats["step_program"] == "eager"
        for k in ("tries", "newton_iterations", "linear_iterations",
                  "matvecs", "masked_krylov_iterations", "host_syncs_step"):
            assert g.stats[k] == e.stats[k], k
        assert torch.equal(g.final_y, e.final_y)
        assert torch.equal(g.final_region, e.final_region)


def test_graph_program_refused_tries_match_eager(monkeypatch):
    """A first step too large to converge: refused tries and their
    retries start from the accepted state, not the refused try's
    buffers."""
    config = {"adapt": {"on": True}, "maximum": {"number": 2},
              "solver": {"linear": {"dtype": "float32",
                                    "jacobian_dtype": "float32"}}}
    ga = _tiny_run(True, monkeypatch, config, runs=((3.0e7,),))
    ea = _tiny_run(False, monkeypatch, config, runs=((3.0e7,),))
    assert any(not ok for _, ok in ga[0].tried)
    _same_runs(ga, ea)
    g = ga[0].stats
    assert g["graph_captures"] >= 4 and g["graph_replays"] > g["tries"]


def test_graph_program_bdf2_two_step_sizes(monkeypatch):
    """Two BDF2 runs at different first step sizes through one captured
    program: each equals its eager twin (a step size baked into a
    graph would repeat the first run's)."""
    config = {"method": "bdf2", "maximum": {"number": 2},
              "solver": {"linear": {"preconditioner": {"type": "asm"}}}}
    runs = ((1.0e4,), (3.0e4,))
    ga = _tiny_run(True, monkeypatch, config, runs=runs)
    ea = _tiny_run(False, monkeypatch, config, runs=runs)
    _same_runs(ga, ea)
    assert ga[1].stats["graph_captures"] == 0
    assert not torch.equal(ga[0].final_y, ga[1].final_y)


def test_step_program_mode_from_configuration():
    """The CPU is always eager, whatever the method and the tracer step;
    tests/test_torch_graph_krylov.py holds the gate's table on a CUDA
    device by route, method and preconditioner."""
    from waiwera_tpu_torch.bench import newton_params
    from waiwera_tpu_torch.sim.simulation import (
        step_program_mode,
        tracer_program_mode,
    )

    sim = build_sim(5, 4, 3, "cpu")
    for method in ("bcgs", "gmres", "lgmres"):
        params = newton_params()._replace(linear_method=method)
        assert step_program_mode(sim.system, params) == "eager"
    assert sim.make_step_fn(newton_params()).program_mode == "eager"
    assert tracer_program_mode(sim.system) == "eager"
