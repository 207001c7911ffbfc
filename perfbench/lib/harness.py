"""One run of one benchmark cell: set-up, warm-up, the measured window
of whole Timestepper episodes, the reference check and the result.

Everything that belongs to a configuration, a cell or a metric is read
from files named in BENCHMARK.json: perfbench/configs/<config>.py
(`build(seed)` and `sizes()`), perfbench/workloads/<cell>.json (the
episode, output, warm-up, samples and limits) and
perfbench/metrics/<metric>.py (`read(run)`, None where it finds
nothing to read). Nothing here names a cell, a configuration or a
metric.
"""

from __future__ import annotations

import copy
import gc
import importlib.util
import json
import math
import os
import random
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

from perfbench.lib import trace as trace_mod

HERE = Path(__file__).resolve().parent.parent  # perfbench/
FORBIDDEN = ("jax", "jaxlib", "flax", "waiwera_tpu")
# the window's first episodes, whose sampled steps and end records the
# reference judges
JUDGED_EPISODES = 2


class SetupError(RuntimeError):
    """The run cannot be made here (no card, missing file)."""


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose top-level name, compared whole, is JAX's or
    the JAX package's."""
    names = sys.modules if modules is None else modules
    return sorted({m for m in names if m.split(".")[0] in FORBIDDEN})


def fix_caches(root: Path):
    """Every build and kernel cache at a fixed place inside the
    checkout (the port builds its CUDA sources into its own _build/)."""
    cache = root / "perfbench" / ".cache"
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(cache / sub)


def guard(when: str):
    """Raise SetupError, naming them, if JAX or the JAX package is
    loaded."""
    bad = forbidden_modules()
    if bad:
        raise SetupError(f"loaded {when}: {bad}")


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not path.is_file():
        raise SetupError(f"missing {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_manifest(root: Path) -> dict:
    path = root / "BENCHMARK.json"
    if not path.is_file():
        raise SetupError(f"missing {path}")
    return json.loads(path.read_text())


def cell_entry(manifest: dict, name: str) -> dict:
    for w in manifest["workloads"]:
        if w["name"] == name:
            return w
    raise SetupError(f"no workload {name!r} in BENCHMARK.json")


def config_module(name: str, bench=HERE):
    return load_module(bench / "configs" / f"{name}.py",
                       f"perfbench_config_{name.replace('-', '_')}")


def metric_reader(name: str, bench=HERE):
    return load_module(bench / "metrics" / f"{name}.py",
                       f"perfbench_metric_{name.replace('.', '_')}")


def load_workload(name: str, bench=HERE) -> dict:
    path = bench / "workloads" / f"{name}.json"
    if not path.is_file():
        raise SetupError(f"missing {path}")
    return json.loads(path.read_text())


def model_for(workload: dict, cfg_mod, seed: int, grid=None) -> dict:
    """The JSON model a cell runs: the configuration's model for the
    seed, with the workload's episode as time.step (the configuration's
    solver kept) and its output fields."""
    model = cfg_mod.build(seed) if grid is None else cfg_mod.build(seed, grid)
    step = dict((model.get("time", {}) or {}).get("step", {}) or {})
    step.update(copy.deepcopy(workload["episode"]))
    model["time"] = {"step": step}
    out = workload["output"]
    fields = dict(out.get("fields", {}))
    fields["cell_geometry"] = []
    model["output"] = {"frequency": int(out["frequency"]), "initial": False,
                       "final": True, "fields": fields}
    return model


class HostSlots:
    """Host buffers, pinned on the card, for the states the reference
    judges: allocated at set-up, so that the window holds no host
    allocation, and filled by asynchronous copies in stream order."""

    def __init__(self, like: dict, count: int, pinned: bool):
        self.free = [{k: torch.empty(t.shape, dtype=t.dtype,
                                     pin_memory=pinned)
                      for k, t in like.items()} for _ in range(count)]

    def take(self, values: dict):
        """A slot holding copies of `values`, or None when all are
        taken."""
        if not self.free:
            return None
        slot = self.free.pop()
        for k, v in values.items():
            slot[k].copy_(v, non_blocking=True)
        return slot


class EpisodeOutput:
    """The output of one episode through the port's HDF5Output: every
    record's source fields into one file, and the episode's end record
    (cell fields, tracers and source fields) into another. The port's
    output writes cell fields in every record; this keeps them to the
    end, as the cell's `output` asks."""

    face_group = None

    def __init__(self, writer_cls, sim, directory: Path, episode: int,
                 steps: int):
        self.writer_cls = writer_cls
        self.sim = sim
        self.steps = steps
        self.step_file = directory / f"episode{episode}-steps.h5"
        self.end_file = None
        self._end_path = directory / f"episode{episode}-end.h5"
        self.steps_out = writer_cls(str(self.step_file), sim, fields=[])
        self.ts = None

    def write(self, index, time_, fluid, source_data=None, tracer=None,
              fluxes=None):
        with torch.profiler.record_function("output.write"):
            self.steps_out.write(index, time_, fluid, source_data)
            if self.ts is not None and self.ts.taken >= self.steps:
                end = self.writer_cls(str(self._end_path), self.sim)
                try:
                    end.write(0, time_, fluid, source_data, tracer=tracer)
                finally:
                    end.close()
                self.end_file = self._end_path

    def close(self):
        self.steps_out.close()


class Recorder:
    """Wraps an episode's step function: keeps every try's (converged,
    iterations) and, for accepted steps of the judged episodes drawn
    from the seed, host copies of the states the reference judges (the
    first episode's first step always, since it starts from the initial
    state that the reference builds itself). `fault` (tests) breaks the
    step's answer where it is produced."""

    def __init__(self, seed: int, per_episode: int, steps: int, slots,
                 fault=None):
        self.rng = random.Random(f"samples/{seed}")
        self.slots = slots
        self.per_episode = per_episode
        self.steps = steps
        self.fault = fault
        self.samples = {}
        self.after_try = None

    def attach(self, ts, episode: int):
        first = 1 if episode == 0 else 0
        picks = set(self.rng.sample(
            range(first, self.steps),
            max(0, min(self.per_episode - first, self.steps - first))))
        if first:
            picks.add(0)
        if episode >= JUDGED_EPISODES:
            picks = set()
        outcomes = []
        inner = ts.step_fn
        self.captured = []  # (try, size) of this episode's captures

        def step(*args, **kwargs):
            before = inner.stats()["graph_captures"]
            with torch.profiler.record_function("timestep.try"):
                out = inner(*args, **kwargs)
            if inner.stats()["graph_captures"] > before:
                self.captured.append((len(outcomes), float(args[6])))
            if self.fault is not None:
                out = self.fault(args, out)
            if self.after_try is not None:
                self.after_try()
            res = out[0]
            converged = bool(res.converged) and not bool(res.failed)
            outcomes.append([converged, int(res.iterations)])
            k = ts.taken
            if converged and k in picks:
                old = self.samples.pop((episode, k), None)
                if old is not None:  # a try refused after converging
                    self.slots.free.append(old["host"])
                slot = self.slots.take({"y0": args[0], "region0": args[1],
                                        "y1": res.y, "region1": res.region})
                if slot is not None:
                    self.samples[(episode, k)] = dict(
                        slot, host=slot, episode=episode, step=k,
                        first=k == 0, t0=float(args[5]), dt=float(args[6]))
            return out

        for attr in ("program_mode", "stats"):
            setattr(step, attr, getattr(inner, attr))
        ts.step_fn = step
        return outcomes


class TracedWindow:
    """torch.profiler over the window's first TRACE_SECONDS: kernels,
    copies and sets on the card, and the host's operations and spans. It
    stops after the try that passes that time, once the card has
    finished its work, so the traced window holds whole tries. The
    profiler's own stop, which collects the events, takes about twice
    the traced time (and reading them as long again), so the trace is
    kept short enough for the run to end within its allowance; `stop_s`
    keeps the stop's seconds, which the window leaves out."""

    TRACE_SECONDS = 5.0

    def __init__(self, on_card: bool, counts):
        self.on_card = on_card
        self.counts = counts  # () -> the launch counters now
        self.prof = None
        self.span = None
        self.stop_s = 0.0

    def start(self):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.on_card:
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.start()
        self.span = torch.profiler.record_function(trace_mod.WINDOW_SPAN)
        self.span.__enter__()
        self.t0 = time.perf_counter()
        self.counts0 = self.counts()

    def after_try(self):
        if (self.span is not None
                and time.perf_counter() - self.t0 >= self.TRACE_SECONDS):
            self.stop()

    def stop(self):
        if self.span is None:
            return
        if self.on_card:
            torch.cuda.synchronize()
        self.span.__exit__(None, None, None)
        self.span = None
        t0 = time.perf_counter()
        self.prof.stop()
        self.stop_s += time.perf_counter() - t0
        self.launches = [b - a for a, b in zip(self.counts0, self.counts())]

    def summary(self) -> dict:
        from torch.autograd import DeviceType

        out = trace_mod.summarise(self.prof.profiler.kineto_results.events(),
                                  DeviceType.CUDA)
        self.prof = None
        return out


def card_line(device_index: int = 0) -> str:
    """The card's name, power limit and clocks, as nvidia-smi reads
    them."""
    query = "name,power.limit,clocks.sm,clocks.max.sm,clocks.mem,temperature.gpu"
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--id={device_index}",
             f"--query-gpu={query}", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
        text = out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        text = f"nvidia-smi unavailable: {e}"
    return f"card ({query}): {text}"


def _sum_stats(runs: list) -> dict:
    """The episodes' Timestepper.stats: counts and seconds summed, lists
    joined (the metrics take the ratios)."""
    total = {}
    for st in runs:
        for k, v in st.items():
            if isinstance(v, (bool, str)) or k == "host_syncs_per_try":
                continue
            if isinstance(v, (int, float)):
                total[k] = total.get(k, 0) + v
            elif isinstance(v, list):
                total.setdefault(k, []).extend(v)
    return total


def run_cell(root: Path, name: str, seed: int, seconds: float, trace: bool,
             t_start: float, device=None, grid=None,
             fault=None, control=False, episode_steps=None, log=print):
    """One run of cell `name`. Returns (result, checks): the result line
    and {number: (value, limit)}. device None takes cuda:0 and fails
    without a card, or with fewer than the cell asks for; tests pass
    "cpu", a small grid, a shorter episode and a fault."""
    manifest = load_manifest(root)
    entry = cell_entry(manifest, name)
    if device is None:
        if not torch.cuda.is_available():
            raise SetupError("no CUDA device")
        if torch.cuda.device_count() < int(entry["chips"]):
            raise SetupError(f"{entry['chips']} cards needed, "
                             f"{torch.cuda.device_count()} present")
        device = "cuda:0"
    device = torch.device(device)
    on_card = device.type == "cuda"
    workload = load_workload(name, root / "perfbench")
    if episode_steps is not None:
        workload["episode"]["maximum"]["number"] = int(episode_steps)
    cfg_mod = config_module(entry["config"], root / "perfbench")
    sizes = cfg_mod.sizes() if grid is None else cfg_mod.sizes(grid)
    model = model_for(workload, cfg_mod, seed, grid)
    steps = int(workload["episode"]["maximum"]["number"])

    from waiwera_tpu_torch.ops import dia
    from waiwera_tpu_torch.sim.output import HDF5Output
    from waiwera_tpu_torch.sim.simulation import Simulation
    from waiwera_tpu_torch.sim.timestepper import Timestepper
    from waiwera_tpu_torch.utils.logging import Logger

    def sync():
        if on_card:
            torch.cuda.synchronize(device)

    marks = [("start", t_start), ("model", time.perf_counter())]
    sim = Simulation(copy.deepcopy(model), device=device)
    sync()
    marks.append(("simulation", time.perf_counter()))
    # warm-up: the episode's first `warmup_steps` accepted steps, whose
    # tries capture every piece of the step program as a CUDA graph (the
    # last first needed is BiCGStab's restart). The window's episodes
    # take the same tries; a capture inside the window is logged below
    warm = copy.deepcopy(model)
    warm["time"]["step"]["maximum"]["number"] = min(
        steps, int(workload["warmup_steps"]))
    wts = Timestepper(warm, sim, output=None, logger=Logger())
    captured_at = []
    inner = wts.step_fn

    def warm_step(*args, **kwargs):
        before = inner.stats()["graph_captures"]
        out = inner(*args, **kwargs)
        if inner.stats()["graph_captures"] > before:
            captured_at.append(len(wts.tried))
        return out

    for attr in ("program_mode", "stats"):
        setattr(warm_step, attr, getattr(inner, attr))
    wts.step_fn = warm_step
    wts.run()
    sync()
    marks.append(("warm-up", time.perf_counter()))
    guard("by the end of set-up")
    setup_s = time.perf_counter() - t_start
    log("set-up: " + ", ".join(
        f"{b[0]} {b[1] - a[1]:.2f} s" for a, b in zip(marks, marks[1:]))
        + f"; warm-up {len(wts.tried)} tries, graph captures "
        f"{wts.stats['graph_captures']} "
        f"({wts.stats['graph_capture_seconds']:.2f} s) at tries "
        f"{captured_at}", file=sys.stderr)

    outdir = Path(tempfile.mkdtemp(prefix="perfbench-"))
    per_episode = int(workload["samples_per_episode"])
    state = {"y0": sim.y0, "region0": sim.region0, "y1": sim.y0,
             "region1": sim.region0}
    slots = HostSlots(state, JUDGED_EPISODES * per_episode, on_card)
    finals = HostSlots({"final_y": sim.y0, "final_region": sim.region0},
                       JUDGED_EPISODES, on_card)
    recorder = Recorder(seed, per_episode, steps, slots, fault)
    episodes, stats = [], []

    def spmv_counts():
        return (dia.dia_spmv_launches.count, dia.dia_spmv_f64_launches.count)

    launches0 = spmv_counts()
    whole_episodes = workload["window_ends"] == "episode"
    traced = TracedWindow(on_card, spmv_counts) if trace else None
    recorder.after_try = traced.after_try if trace else None
    try:
        if traced is not None:
            traced.start()
        t_open = time.perf_counter()
        deadline = t_open + seconds
        longest = 0.0
        e = 0
        while True:
            now = time.perf_counter()
            stopped = traced.stop_s if traced is not None else 0.0
            # the window holds whole episodes where the cell's unit of work
            # is the episode (window_ends "episode"): one more starts only
            # where it ends before the deadline, as the longest so far did
            if now >= deadline or (whole_episodes and e > 0
                                   and now + longest > deadline):
                break
            out = EpisodeOutput(HDF5Output, sim, outdir, e, steps)
            ts = Timestepper(model, sim, output=out, logger=Logger())
            out.ts = ts
            outcomes = recorder.attach(ts, e)
            try:
                # otherwise the window closes after the step in flight
                ts.run(max_wall_seconds=None if whole_episodes
                       else deadline - now)
            finally:
                out.close()
            took = time.perf_counter() - now - (
                traced.stop_s - stopped if traced is not None else 0.0)
            longest = max(longest, took)
            complete = ts.taken >= steps
            ep = {"outcomes": outcomes,
                  "tried": [float(dt) for dt, _ in ts.tried],
                  "taken": ts.taken, "aborted": bool(ts.aborted),
                  "complete": complete, "step_file": out.step_file,
                  "end_file": None}
            fin = finals.take({"final_y": ts.final_y,
                               "final_region": ts.final_region}) \
                if complete else None
            if fin is not None:
                ep.update(fin, end_file=out.end_file)
            episodes.append(ep)
            stats.append(ts.stats)
            refused = [dt for (dt, ok) in ts.tried if not ok]
            log(f"episode {e}: {ts.taken} steps, {len(ts.tried)} tries, "
                f"{took:.3f} s, refused sizes "
                f"{refused[:12]}, Newton {ts.stats['newton_iterations']}, "
                f"linear {ts.stats['linear_iterations']}, captures "
                f"{ts.stats['graph_captures']} at tries {recorder.captured}",
                file=sys.stderr)
            e += 1
        sync()
        # the profiler's stops inside the window are not the program's
        window_s = time.perf_counter() - t_open - (
            traced.stop_s if traced is not None else 0.0)
    finally:
        if traced is not None:
            traced.stop()
    memory_peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    # the SpMV launches of the window, or of its traced part
    n32, n64 = (traced.launches if traced is not None else
                [b - a for a, b in zip(launches0, spmv_counts())])
    launches = {"float32": n32, "float64": n64}
    total = _sum_stats(stats)
    accepted = sum(ep["taken"] for ep in episodes)
    log(f"window: {window_s:.3f} s, {len(episodes)} episodes, "
        f"{accepted} accepted steps, {total.get('tries', 0)} tries, "
        f"graph captures {total.get('graph_captures', 0)}", file=sys.stderr)

    tr = None
    if traced is not None:
        t0 = time.perf_counter()
        tr = traced.summary()
        log(f"trace: {time.perf_counter() - t0:.1f} s to read, "
            f"busy {tr['busy_s']:.4f} of {tr['window_s']:.4f} s",
            file=sys.stderr)
        traced = None

    # the program's state goes before the reference runs
    del sim, ts, out, wts, inner
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    sync()

    from perfbench.reference import check

    samples = [recorder.samples[k] for k in sorted(recorder.samples)]
    t_check = time.perf_counter()
    checks = check.judge(cfg_mod, model, workload, samples, episodes, device,
                         control=control, log=log)
    log(f"check: {time.perf_counter() - t_check:.1f} s", file=sys.stderr)
    shutil.rmtree(outdir, ignore_errors=True)
    guard("by the end of the run")

    run = {"workload": workload, "sizes": sizes, "setup_s": setup_s,
           "window_s": window_s, "accepted_steps": accepted,
           "stats": total, "launches": launches, "trace": tr}
    wanted = manifest["per_layer"] if trace else manifest["end_to_end"]
    metrics = {}
    for m in wanted:
        if name not in m.get("workloads", [name]):
            continue
        value = metric_reader(m["name"], root / "perfbench").read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    values = [v for v, _ in checks.values()]
    correct = (all(v <= lim for v, lim in checks.values())
               and not any(math.isnan(v) for v in values))
    result = {
        "correct": correct,
        "attempted": sum(len(ep["outcomes"]) for ep in episodes),
        "failed": sum(1 for ep in episodes if ep["aborted"]),
        "metrics": metrics,
        "device": {
            "platform": "gpu" if on_card else "cpu",
            "kind": (torch.cuda.get_device_name(device) if on_card
                     else "cpu"),
            "count": 1,
            "memory_peak_bytes": int(memory_peak),
        },
    }
    if tr is not None:
        result["device"]["busy_s"] = tr["busy_s"]
        result["device"]["window_s"] = tr["window_s"]
        result["breakdown"] = tr["breakdown"]
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in checks.items()}
    return result, checks
