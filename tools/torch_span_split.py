#!/usr/bin/env python3
"""A traced run of one benchmark cell with the port's spans read from
its trace.

    python3 tools/torch_span_split.py --workload box-ramp --seed <n> \
        [--seconds 25] [--no-spans] [--trace-seconds S] [--out FILE]

Runs the cell as `perfbench/run.py --trace 1` does (the same harness,
window and profiler), and reads the port's spans
(waiwera_tpu_torch/utils/spans.py) from the same trace through
perfbench/lib/spans.py: each piece's device ms a launch, the idle time
by host layer and by piece, the device time no piece launched, which
rule tied the device ops to their launches and the ops that start
before their launch span. Prints one JSON line: the harness's result,
the split, its per-layer numbers and the tries a second of the traced
window. --no-spans turns the port's spans off (the profiler still
records the harness's own), for their cost under the profiler;
--trace-seconds traces longer than the harness does (a whole episode,
say). --device
cpu, --grid and --episode-steps rehearse the run on the CPU (there the
trace has no device ops).
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def links(events, device_type, spans) -> dict:
    """How the device ops' ids lead to the host: the kind of event their
    linked correlation id names (a launch span, another op or span, none)
    and the runtime call their own correlation id names."""
    by_corr, runtime = {}, {}
    dev = []
    for e in events:
        if e.device_type() == device_type:
            if not e.is_user_annotation() and "Sync" not in e.name():
                dev.append((e.linked_correlation_id(), e.correlation_id()))
            continue
        if spans.is_runtime(e):
            runtime[e.correlation_id()] = e.name()
        else:
            by_corr[e.correlation_id()] = e.name()
    out = {}
    for linked, corr in dev:
        name = by_corr.get(linked) if linked else None
        target = ("none" if name is None else "launch span"
                  if name.startswith("program.launch:") else "other")
        key = f"{target} / {runtime.get(corr, 'no runtime call')}"
        out[key] = out.get(key, 0) + 1
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=25.0)
    p.add_argument("--no-spans", action="store_true")
    p.add_argument("--out", default=None)
    p.add_argument("--trace-seconds", type=float, default=None,
                   help="trace this long (the harness's 5 s by default)")
    p.add_argument("--device", default=None)
    p.add_argument("--grid", default=None, help="nx,ny,nz")
    p.add_argument("--episode-steps", type=int, default=None)
    args = p.parse_args(argv)

    sys.path.insert(0, str(ROOT))
    from torch.autograd import DeviceType

    from perfbench.lib import harness, spans
    from perfbench.lib import trace as trace_mod
    from waiwera_tpu_torch.utils import spans as port_spans

    harness.fix_caches(ROOT)
    if args.no_spans:
        port_spans._profiler_enabled = lambda: False
    read = {}

    class SpanWindow(harness.TracedWindow):
        def summary(self):
            events = self.prof.profiler.kineto_results.events()
            t0 = time.perf_counter()
            read["split"] = spans.split(events, DeviceType.CUDA)
            read["read_s"] = time.perf_counter() - t0
            read["links"] = links(events, DeviceType.CUDA, spans)
            lo = next(e.start_ns() for e in events
                      if e.name() == trace_mod.WINDOW_SPAN)
            read["tries"] = sum(1 for e in events
                                if e.name() == "timestep.try"
                                and e.device_type() == DeviceType.CPU
                                and e.start_ns() >= lo)
            return super().summary()

    if args.trace_seconds is not None:
        SpanWindow.TRACE_SECONDS = args.trace_seconds
    harness.TracedWindow = SpanWindow
    grid = (None if args.grid is None
            else tuple(int(v) for v in args.grid.split(",")))
    result, _ = harness.run_cell(
        ROOT, args.workload, args.seed, args.seconds, True, T_START,
        device=args.device, grid=grid, episode_steps=args.episode_steps)
    split = read["split"]
    line = {
        "card": harness.card_line(), "spans": not args.no_spans,
        "total_s": time.perf_counter() - T_START, "result": result,
        "split": split, "per_layer": spans.per_layer(split),
        "links": read["links"], "split_read_s": read["read_s"],
        "tries_traced": read["tries"],
        "tries_per_s_traced": (read["tries"] / split["window_s"]
                               if split["window_s"] > 0 else None),
        "unattributed_share": (split["unattributed_s"] / split["busy_s"]
                               if split["busy_s"] > 0 else None),
    }
    text = json.dumps(line)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text + "\n")
    print(text, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
