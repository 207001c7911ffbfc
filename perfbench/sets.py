#!/usr/bin/env python3
"""Runs of one cell, one process after another, as the benchmark's
check makes them, and the spread of each metric over them.

    python3 perfbench/sets.py --workload <name> --seeds 11,12,13 \
        --seconds <s> [--trace 1] [--out DIR]

Each run is `perfbench/run.py` in a new process; its standard output
and error go to DIR/<workload>-<seed>-t<trace>.{out,err} (DIR is
perfbench/.cache/runs by default). Prints one line per run (correct, the numbers
compared, the metrics) and, last, a JSON summary: per metric the
values in seed order, the median and the spread (inter-quartile
distance over the median, perfbench/lib/stats.py), the first run's
set-up apart; the summary also goes to DIR/<workload>-t<trace>.summary.json.
"""

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from perfbench.lib.stats import spread  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, default=0)
    p.add_argument("--out", default=str(ROOT / "perfbench" / ".cache" / "runs"))
    args = p.parse_args(argv)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    values, checks, rcs = {}, {}, []
    for seed in [int(s) for s in args.seeds.split(",")]:
        stem = out / f"{args.workload}-{seed}-t{args.trace}"
        t0 = time.perf_counter()
        with open(f"{stem}.out", "w") as fo, open(f"{stem}.err", "w") as fe:
            rc = subprocess.call(
                [sys.executable, str(ROOT / "perfbench" / "run.py"),
                 "--workload", args.workload, "--seed", str(seed),
                 "--seconds", str(args.seconds), "--trace", str(args.trace)],
                stdout=fo, stderr=fe, cwd=ROOT)
        elapsed = time.perf_counter() - t0
        rcs.append(rc)
        lines = Path(f"{stem}.out").read_text().strip().splitlines()
        if rc != 0 or not lines:
            err = Path(f"{stem}.err").read_text()[-3000:]
            print(f"seed {seed}: rc {rc}\n{err}", flush=True)
            continue
        res = json.loads(lines[-1])
        for k, m in res["metrics"].items():
            values.setdefault(k, []).append(m["value"])
        for k, c in res["checks"].items():
            checks.setdefault(k, []).append(c["value"])
        dev = res["device"]
        print(f"seed {seed}: correct {res['correct']} attempted "
              f"{res['attempted']} checks "
              f"{ {k: c['value'] for k, c in res['checks'].items()} } "
              f"metrics { {k: m['value'] for k, m in res['metrics'].items()} }"
              f" peak {dev['memory_peak_bytes']} busy {dev.get('busy_s')} "
              f"window {dev.get('window_s')} run {elapsed:.1f} s", flush=True)
    summary = {"workload": args.workload, "rcs": rcs, "checks": checks,
               "metrics": {}}
    for k, v in values.items():
        rest = v[1:] if k == "setup_s" and len(v) > 1 else v
        summary["metrics"][k] = {
            "values": v, "median": statistics.median(rest),
            "spread": spread(rest) if len(rest) >= 2 else None}
    text = json.dumps(summary)
    (out / f"{args.workload}-t{args.trace}.summary.json").write_text(text)
    print(text)
    return 0 if rcs and all(rc == 0 for rc in rcs) else 1


if __name__ == "__main__":
    sys.exit(main())
