#!/usr/bin/env python3
"""The benchmark of waiwera_tpu_torch: one run of one cell.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Builds the cell's JSON model from the seed, `Simulation(model)` on
cuda:0, warms up the episode's first steps (the CUDA graph captures),
then runs the cell's Timestepper episode again and again from the same
initial state for --seconds, lets the step in flight finish, judges
what the window produced against the plain f64 reference
(perfbench/reference) and prints one JSON line last on standard output:
the cell's end-to-end metrics with --trace 0, its per-layer metrics
(from Timestepper.stats and a torch.profiler trace of the window) with
--trace 1. Each number compared is printed beside its limit as the last
lines on standard error. Exits non-zero, with no result, without a CUDA
card, without the program, or if JAX or the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    sys.path.insert(0, str(ROOT))
    from perfbench.lib import harness

    harness.fix_caches(ROOT)

    try:
        result, checks = harness.run_cell(
            ROOT, args.workload, args.seed, args.seconds, bool(args.trace),
            T_START)
    except (harness.SetupError, ImportError) as e:
        print(f"perfbench: {e}", file=sys.stderr)
        return 2
    print(harness.card_line())
    for k, (v, lim) in checks.items():
        print(f"check {k}: {v!r} limit {lim!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
