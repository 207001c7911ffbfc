"""Counts the device kernels of the band preconditioners line and cpr on
a CUDA card: one factorisation (the operator and preconditioner built
from the Jacobian's parts, System.linear_operator_from_parts, as a try's
Krylov start piece does) and one application, each run once eagerly
under torch.profiler (the kernels a CUDA graph of it replays), f32 as
the bench runs them, at the flagship's initial state (128 x 64 x 64
unless --nx/--ny/--nz say otherwise). Prints one JSON line with the
counts, the device seconds of each call and the card's name and power
limit.

Run it from the checkout to be counted (its package is the one
imported), e.g. a parent and a change in one call:

    cd parent && python3 ../tools/torch_pc_kernels.py --label parent
    cd change && python3 tools/torch_pc_kernels.py --label change
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def _events(fn):
    """fn() once under torch.profiler: (device events, device seconds)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kern = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    return (sum(e.count for e in kern),
            sum(e.self_device_time_total for e in kern) / 1e6)


def count(size, pcs=("line", "cpr"), dt=1.0e4):
    """{pc: {factor_kernels, factor_device_s, apply_kernels,
    apply_device_s}} at the flagship model's initial state on `size`."""
    import torch
    from waiwera_tpu_torch import bench
    from waiwera_tpu_torch.solver.system import MethodCoeffs

    sim = bench.build_sim(*size, "cuda")
    system = sim.system
    lhs, _, _ = sim.lhs_at(sim.y0, sim.region0)
    coeffs = MethodCoeffs(c_lhs=1.0, dt_eff=dt, const=-lhs)
    parts = system.jacobian_parts(sim.y0, sim.region0, sim.rock, coeffs,
                                  0.0, dt, tangent_dtype=torch.float32)
    gen = torch.Generator(device="cuda").manual_seed(0)
    r = torch.randn(tuple(sim.y0.shape), generator=gen, device="cuda")
    out = {}
    for pc in pcs:
        def factor():
            return system.linear_operator_from_parts(
                parts, pc, dtype=torch.float32)[1]

        apply = factor()  # warm: the first call's lazy set-up
        apply(r)
        fk, fs = _events(factor)
        ak, as_ = _events(lambda: apply(r))
        out[pc] = {"factor_kernels": fk, "factor_device_s": fs,
                   "apply_kernels": ak, "apply_device_s": as_}
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--label", default=os.path.basename(os.getcwd()))
    parser.add_argument("--nx", type=int, default=128)
    parser.add_argument("--ny", type=int, default=64)
    parser.add_argument("--nz", type=int, default=64)
    args = parser.parse_args(argv)
    sys.path.insert(0, os.getcwd())
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch_pc_kernels: no CUDA device")
    from waiwera_tpu_torch import bench

    rec = count((args.nx, args.ny, args.nz))
    print(json.dumps({"label": args.label,
                      "size": [args.nx, args.ny, args.nz],
                      "card": bench.card(), **rec}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
