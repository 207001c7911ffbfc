"""The port's profiler spans (waiwera_tpu_torch/utils/spans.py) and their
reading (perfbench/lib/spans.py).

A Timestepper run of a small box through the graph program, with the
CPU stand-in for CUDA graphs, under torch.profiler: the spans nest
timestepper.try > newton.solve > program.launch:<piece>, one launch span
per replay and one read span per host sync. Without a profiler no span
is entered. With the Jacobian a piece of its own, graph runs equal eager
runs bit for bit with equal counts. The reading of a trace is checked
on hand-made events: device time by piece through the correlation ids,
idle time by host layer summing to the window's idle time, and the
per-layer numbers.
"""

import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from test_torch_graph_program import EmulatedGraphs
from torch_parity import RecordingLogger, build_sim

from perfbench.lib import spans as spans_mod
from perfbench.lib import trace as trace_mod

# one step: a refused try at 1e5 s, then an accepted one
CONFIG = {"adapt": {"on": True}, "maximum": {"number": 1},
          "solver": {"linear": {"dtype": "float32",
                                "jacobian_dtype": "float32"}}}
PIECES = {"newton.start", "newton.jacobian", "newton.krylov.start",
          "newton.krylov.chunk", "newton.krylov.round_end",
          "newton.update"}


def _runs(graph, entered, profiled=False):
    """Two Timestepper runs on one Simulation of the 5 x 4 x 3 box (the
    second replays the first one's captures); with profiled, the first
    under torch.profiler. Unprofiled runs note in `entered` every
    record_function the port enters. Returns (runs, the profiler or
    None)."""
    from waiwera_tpu_torch.sim import simulation
    from waiwera_tpu_torch.sim.timestepper import Timestepper
    from waiwera_tpu_torch.solver import program
    from waiwera_tpu_torch.utils import spans

    mp = pytest.MonkeyPatch()
    if graph:
        mp.setattr(simulation, "step_program_mode",
                   lambda system, params: "graph")
        mp.setattr(program, "CudaGraphs", EmulatedGraphs)
    out, prof = [], None
    try:
        sim = build_sim(5, 4, 3, "cpu")
        for i in range(2):
            ts = Timestepper({"time": {"step": dict(CONFIG, size=1.0e5)}},
                             sim, logger=RecordingLogger())
            if profiled and i == 0:
                with profile(activities=[ProfilerActivity.CPU]) as prof:
                    assert ts.run()
            else:
                with pytest.MonkeyPatch.context() as m:
                    m.setattr(spans, "record_function",
                              lambda *a, **k: entered.append(a))
                    assert ts.run()
            out.append(ts)
    finally:
        mp.undo()
    return out, prof


@pytest.fixture(scope="module")
def runs():
    """Graph runs (the first profiled, its captures; the second
    replays) and eager runs, every unprofiled run with record_function
    watched."""
    entered = []
    graph, prof = _runs(True, entered, profiled=True)
    eager, _ = _runs(False, entered)
    return {"graph": graph, "eager": eager, "prof": prof,
            "entered": entered}


def _spans(prof):
    """(name, start, end) of every user span of a CPU trace."""
    return [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
            for e in prof.profiler.kineto_results.events()
            if e.is_user_annotation()]


def test_spans_nest_and_count(runs):
    spans = _spans(runs["prof"])
    st = runs["graph"][0].stats
    by = {}
    for name, s, e in spans:
        by.setdefault(name.split(":")[0], []).append((name, s, e))

    def inside(a, outer):
        return any(s <= a[1] and a[2] <= e for _, s, e in outer)

    tries, solves = by["timestepper.try"], by["newton.solve"]
    assert len(tries) == st["tries"] and len(solves) == st["tries"]
    assert all(inside(s, tries) for s in solves)
    for kind in ("program.launch", "program.read", "program.capture",
                 "program.hand_out"):
        assert by[kind] and all(inside(s, solves) for s in by[kind]), kind
    assert all(inside(s, tries) for s in by["program.stage"])
    launches = {n.split(":", 1)[1] for n, _, _ in by["program.launch"]}
    assert PIECES <= launches
    jac = [s for s in by["program.launch"]
           if s[0] == "program.launch:newton.jacobian"]
    assert len(jac) == st["newton_iterations"]
    # one launch span per replay, one read span per host sync
    assert len(by["program.launch"]) == st["graph_replays"]
    assert len(by["program.read"]) == st["host_syncs_step"]
    assert len(by["program.capture"]) == st["graph_captures"]
    # a read names the piece launched last: the Krylov solve's start is
    # read after the Jacobian's launch, never the Jacobian itself
    reads = {n.split(":", 1)[1] for n, _, _ in by["program.read"]}
    assert "newton.jacobian" not in reads
    assert "newton.krylov.start" in reads
    # the try's args name the step, the try and dt
    args = [e for e in runs["prof"].profiler.kineto_results.events()
            if e.name() == "timestepper.try"]
    assert len(args) == st["tries"]
    assert "timestepper.output" not in by  # no output configured


def test_no_span_entered_without_a_profiler(runs):
    from waiwera_tpu_torch.utils import spans

    assert not spans.profiling()
    assert runs["entered"] == []
    assert runs["graph"][1].stats["graph_replays"] > 0


def test_jacobian_piece_graph_equals_eager(runs):
    """The Jacobian as its own piece: graph runs (profiled or not) equal
    eager runs bit for bit, with equal counts; the first graph run
    captures the Jacobian piece, the later ones replay it."""
    graph, eager = runs["graph"], runs["eager"]
    for g, e in zip(graph, eager):
        assert g.tried == e.tried
        assert g.stats["step_program"] == "graph"
        assert e.stats["step_program"] == "eager"
        for k in ("tries", "newton_iterations", "linear_iterations",
                  "matvecs", "masked_krylov_iterations", "host_syncs_step"):
            assert g.stats[k] == e.stats[k], k
        assert torch.equal(g.final_y, e.final_y)
        assert torch.equal(g.final_region, e.final_region)
    progs = graph[0].sim.system._step_programs.values()
    pieces = set().union(*(p._pieces for p in progs))
    assert PIECES <= pieces
    assert graph[0].stats["graph_captures"] == sum(
        len(p._pieces) for p in progs)
    assert graph[1].stats["graph_captures"] == 0


# -- perfbench/lib/spans.py on hand-made events --------------------------


class Ev:
    """A stand-in for torch's _KinetoEvent."""

    def __init__(self, name, start, end, device=False, kind="cpu_op",
                 corr=0, linked=0, thread=7):
        self._name, self._s, self._d = name, start, end - start
        self._dev = DeviceType.CUDA if device else DeviceType.CPU
        self._kind = kind if not device else "kernel"
        self._corr, self._linked, self._thread = corr, linked, thread

    def name(self):
        return self._name

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        return self._dev

    def is_user_annotation(self):
        return self._kind in ("user_annotation", "gpu_user_annotation")

    def activity_type(self):
        return self._kind

    def correlation_id(self):
        return self._corr

    def linked_correlation_id(self):
        return self._linked

    def device_resource_id(self):
        return self._thread


def span(name, s, e, corr=0):
    return Ev(name, s, e, kind="user_annotation", corr=corr)


def op(name, s, e, linked=0, corr=0):
    return Ev(name, s, e, device=True, linked=linked, corr=corr)


def events():
    """A window of 1,000 ns: a graph replay of the Jacobian (its kernel
    linked to the launch span), the Krylov start queued behind it and
    its flags read, an eager update (a kernel linked to an aten op
    inside its launch span, one tied by its runtime call, one by time
    alone), a copy outside every launch span, a sync and a device-side
    annotation the reading leaves out."""
    return [
        span(trace_mod.WINDOW_SPAN, 0, 1000),
        span("timestepper.try", 50, 950, corr=20),
        span("program.launch:newton.jacobian", 100, 150, corr=1),
        Ev("cudaGraphLaunch", 110, 140, kind="cuda_runtime", corr=900),
        op("jac_kernel", 160, 300, linked=1, corr=900),
        span("program.launch:newton.krylov.start", 200, 220, corr=2),
        op("krylov_kernel", 300, 400, linked=2, corr=901),
        span("program.read:newton.krylov.start", 230, 450, corr=3),
        op("Memcpy DtoH (Device -> Pageable)", 400, 400, linked=3),
        span("program.launch:newton.update", 500, 600, corr=4),
        Ev("aten::mul", 510, 520, corr=5),
        op("mul_kernel", 530, 560, linked=5, corr=902),
        Ev("cudaLaunchKernel", 520, 522, kind="cuda_runtime", corr=903),
        op("add_kernel", 600, 640, corr=903),
        op("late_kernel", 700, 710),
        op("cudaDeviceSynchronize", 710, 900),
        Ev("gpu_note", 0, 1000, device=True),
        Ev("aten::copy_", 960, 970, corr=6),
        op("copy_kernel", 975, 990, linked=6, corr=904),
    ]


def _gpu_annotation(evs):
    evs[-3]._kind = "gpu_user_annotation"
    return evs


def test_split_attributes_device_time_by_correlation():
    res = spans_mod.split(_gpu_annotation(events()), DeviceType.CUDA)
    assert res["window_s"] == pytest.approx(1000e-9)
    assert res["busy_s"] == pytest.approx(335e-9)
    p = res["pieces"]
    assert p["newton.jacobian"] == {"device_s": pytest.approx(140e-9),
                                    "launches": 1}
    assert p["newton.krylov.start"] == {"device_s": pytest.approx(100e-9),
                                        "launches": 1}
    assert p["newton.update"] == {"device_s": pytest.approx(80e-9),
                                  "launches": 1}
    assert res["unattributed_s"] == pytest.approx(15e-9)
    assert res["ops"] == {"total": 6, "linked": 3, "runtime": 1, "time": 1}
    assert res["early_ops"] == 0


def test_split_idle_parts_sum_to_the_window_idle():
    evs = _gpu_annotation(events())
    res = spans_mod.split(evs, DeviceType.CUDA)
    idle = res["idle_s"]
    assert idle == {"read": pytest.approx(50e-9),
                    "launch": pytest.approx(120e-9),
                    "host_loop": pytest.approx(410e-9),
                    "other": pytest.approx(85e-9)}
    summ = trace_mod.summarise(evs, DeviceType.CUDA)
    assert sum(idle.values()) / res["window_s"] == pytest.approx(
        1.0 - summ["busy_s"] / summ["window_s"], abs=1e-12)
    assert res["busy_s"] == summ["busy_s"]
    # each gap named by the layer over its midpoint
    assert res["longest_gaps"] == [
        ["host_loop", pytest.approx(265e-9)],
        ["host_loop", pytest.approx(160e-9)],
        ["host_loop", pytest.approx(130e-9)],
        ["host_loop", pytest.approx(60e-9)],
        ["launch:newton.update", pytest.approx(40e-9)],
        ["other", pytest.approx(10e-9)]]
    assert res["idle_by_piece_s"] == {
        "read": {"newton.krylov.start": pytest.approx(50e-9)},
        "launch": {"newton.jacobian": pytest.approx(50e-9),
                   "newton.krylov.start": 0.0,
                   "newton.update": pytest.approx(70e-9)}}


def test_trace_summarise_unchanged():
    """trace.summarise on the same events: the output it gave before the
    port had spans of its own."""
    out = trace_mod.summarise(_gpu_annotation(events()), DeviceType.CUDA)
    assert out["busy_s"] == pytest.approx(335e-9)
    assert out["window_s"] == pytest.approx(1000e-9)
    assert out["kernel_n"] == {
        "jac_kernel": 1, "krylov_kernel": 1, "mul_kernel": 1,
        "add_kernel": 1, "late_kernel": 1, "copy_kernel": 1}
    assert out["breakdown"]["device_ops"][0] == ["jac_kernel",
                                                 pytest.approx(140e-9)]
    gaps = out["breakdown"]["idle_gaps"]
    # the longest first, each named by the innermost host event over
    # its midpoint
    assert [g[0] for g in gaps] == [
        "timestepper.try", "timestepper.try", "timestepper.try",
        "timestepper.try", "program.launch:newton.update",
        "host outside any traced call"]
    assert [round(g[1] * 1e9) for g in gaps] == [265, 160, 130, 60, 40, 10]


class OldEv(Ev):
    """An event of a torch that gives no activity type."""

    activity_type = None


def test_split_without_activity_types():
    """Runtime calls known by their names where torch gives no activity
    type: the same split."""
    evs = _gpu_annotation(events())
    old = [OldEv(e._name, e._s, e._s + e._d, e._dev == DeviceType.CUDA,
                 e._kind, e._corr, e._linked, e._thread) for e in evs]
    for o, e in zip(old, evs):
        o._kind = e._kind
    assert spans_mod.split(old, DeviceType.CUDA) == spans_mod.split(
        evs, DeviceType.CUDA)


def test_split_flags_ops_before_their_launch():
    evs = [span(trace_mod.WINDOW_SPAN, 0, 100),
           span("program.launch:newton.update", 40, 60, corr=1),
           op("k", 30, 35, linked=1)]
    res = spans_mod.split(evs, DeviceType.CUDA)
    assert res["early_ops"] == 1
    assert res["pieces"]["newton.update"]["launches"] == 1


def test_per_layer_numbers():
    res = spans_mod.split(_gpu_annotation(events()), DeviceType.CUDA)
    res["pieces"]["newton.krylov.chunk"] = {"device_s": 8e-6,
                                            "launches": 4}
    got = spans_mod.per_layer(res)
    assert got == {
        "jacobian_ms": pytest.approx(140e-6),
        "update_ms": pytest.approx(80e-6),
        "krylov_chunk_ms": pytest.approx(2e-3),
        "read_idle_share": pytest.approx(5.0),
        "launch_idle_share": pytest.approx(12.0),
        "host_loop_idle_share": pytest.approx(41.0)}
    # no such piece, no launch, no window: None
    res["pieces"].pop("newton.update")
    res["pieces"]["newton.jacobian"]["launches"] = 0
    res["window_s"] = 0.0
    got = spans_mod.per_layer(res)
    assert got["jacobian_ms"] is None and got["update_ms"] is None
    assert got["read_idle_share"] is None
    assert got["krylov_chunk_ms"] == pytest.approx(2e-3)
