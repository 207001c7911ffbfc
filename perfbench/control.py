#!/usr/bin/env python3
"""The control of `correct`: one run of a cell in which the reference,
held in the nearest lower precision than the configuration states
(f32 states and f32 records in place of f64), stands in the program's
place. The run has to come out not correct.

    python3 perfbench/control.py --workload <name> --seed <n> --seconds <s>

Prints the numbers compared beside their limits and the result line,
as perfbench/run.py does. The benchmark's own runs never run it; the
CPU test perfbench/tests/test_perfbench_reference.py runs it at a test
size."""

import argparse
import json
import sys
import time
from pathlib import Path

T_START = time.perf_counter()
ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from perfbench.lib import harness

    harness.fix_caches(ROOT)

    result, checks = harness.run_cell(ROOT, args.workload, args.seed,
                                      args.seconds, False, T_START,
                                      control=True)
    for k, (v, lim) in checks.items():
        print(f"control {k}: {v!r} limit {lim!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
