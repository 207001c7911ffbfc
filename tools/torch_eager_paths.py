"""Times the port's eager GMRES / LGMRES / BiCGStab(l) paths on a CUDA
card, for comparing two checkouts of the repository in one call.

The runs are phase 11 (b) and (c) of chip_smoke.py over 4 ranks
sharing the card (gloo; the production field at 48 x 32 x 32 with asm
and its GMRES tracer solves, and 49,152 wedges with lgmres + asm; no
graph program covers ranks), each twice in one spawn, and on one rank,
run eagerly (Simulation._eager_step; through graphs otherwise) twice
each, the first a
warm-up: phase 10 (b)'s 49,152 wedges with bcgsl + asm, phase 10 (d)'s
tetrahedral box with lgmres + lu, phase 11 (c)'s wedges with lgmres +
asm and phase 11 (b)'s field with asm (--profile: those named once
more under torch.profiler: kernels launched, device busy seconds, the
top host ops and kernels). Prints one JSON line with each run's run
loop, tracer seconds and counts, and the card's name and power limit.

Run it from the checkout to be timed (its chip_smoke.py and package are
the ones imported), e.g. a parent and a change in turns:

    cd parent && python3 ../tools/torch_eager_paths.py --label parent
    cd change && python3 tools/torch_eager_paths.py --label change
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time


def _profile(fn, top=12):
    """fn() under torch.profiler: (its value, a record of the kernels
    launched, the device's busy seconds, and the `top` host ops by self
    time and kernels by device time (name, calls, ms))."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        value = fn()
    ev = prof.key_averages()
    kern = sorted((e for e in ev if e.device_type == DeviceType.CUDA),
                  key=lambda e: -e.self_device_time_total)
    ops = sorted((e for e in ev if e.device_type == DeviceType.CPU),
                 key=lambda e: -e.self_cpu_time_total)
    return value, {
        "kernels": sum(e.count for e in kern),
        "device_busy_s": sum(e.self_device_time_total for e in kern) / 1e6,
        "top_kernels": [(e.key[:60], e.count, e.self_device_time_total / 1e3)
                        for e in kern[:top]],
        "top_host_ops": [(e.key[:60], e.count, e.self_cpu_time_total / 1e3)
                         for e in ops[:top]]}


def _one_rank(cfg, label, device, runs=2, profile=False):
    """`runs` eager Timestepper runs of cfg on one Simulation: counts and
    run loops of each; with profile, one more run under the profiler."""
    from chip_smoke import _QuietLog
    from waiwera_tpu_torch.sim.simulation import Simulation
    from waiwera_tpu_torch.sim.timestepper import Timestepper

    cfg = json.loads(json.dumps(cfg))
    cfg.pop("output", None)
    sim = Simulation(json.loads(json.dumps(cfg)), device=device)
    sim._eager_step = True
    def run(profiled=False):
        ts = Timestepper(json.loads(json.dumps(cfg)), sim, logger=_QuietLog())
        with open(os.devnull, "w") as null:
            stdout, sys.stdout = sys.stdout, null
            try:
                ok, prof = _profile(ts.run) if profiled else (ts.run(), None)
            finally:
                sys.stdout = stdout
        if not ok:
            raise RuntimeError(f"{label}: the run aborted")
        return ts, prof

    out = []
    for _ in range(runs):
        st = run()[0].stats
        out.append({
            "run_loop_s": sum(st["step_seconds"]),
            "tracer_s": st["tracer_seconds"],
            "tries": st["tries"], "newton": st["newton_iterations"],
            "linear": st["linear_iterations"], "matvecs": st["matvecs"],
            "tracer_iterations": st["tracer_iterations"],
            "host_syncs_tracer": st["host_syncs_tracer"]})
    if profile:
        out.append({"profile": run(profiled=True)[1]})
    return out


def measure(label, device="cuda", wedge=None, reduced=None, profile=()):
    """The record of one checkout (the chip_smoke.py and package first on
    sys.path); wedge and reduced default to chip_smoke.WEDGE_REDUCED and
    bench.REDUCED (smaller on the CPU); the one-rank runs named in
    `profile` are run once more under the profiler."""
    import chip_smoke as cs
    from waiwera_tpu_torch import bench

    rec = {"label": label, "card": bench.card() if device == "cuda"
           else "cpu"}
    t0 = time.perf_counter()
    if device == "cuda":
        # before the ranks, which would each build it at first use
        from waiwera_tpu_torch.ops import cuda_build

        cuda_build.build_all(["dia_spmv"])
    with tempfile.TemporaryDirectory() as workdir:
        nx, ny, nz = wedge or cs.WEDGE_REDUCED
        verts, wedges, pos = cs.wedge_mesh(nx, ny, nz)
        path = os.path.join(workdir, "wedges.msh")
        cs.write_gmsh(path, verts, [("wedge", wedges)], version="4.1",
                      binary=True)
        cfg_b = cs.network_model_config(*(reduced or bench.REDUCED), steps=3)
        cfg_b["time"]["step"]["solver"] = {
            "linear": {"preconditioner": {"type": "asm"}}}
        cfg_c = cs.wedge_model_config(path, nx, ny, nz, pos, steps=3,
                                      solver=cs.LGMRES_ASM)
        res, wall = cs.ranks_run(["b1", "b2", "c1", "c2"],
                                 [cfg_b, cfg_b, cfg_c, cfg_c],
                                 [device] * cs.RANKS, log=lambda m: None)
        rec["ranks_spawn_s"] = wall
        for key, r in zip(("11b", "11b", "11c", "11c"), res):
            st = r[0]["stats"]
            rec.setdefault(f"ranks_{key}", []).append({
                "run_loop_s": r[0]["run_seconds"],
                "tracer_s": st.get("tracer_seconds"),
                "tries": st["tries"], "newton": st["newton_iterations"],
                "linear": st["linear_iterations"], "matvecs": st["matvecs"],
                "tracer_iterations": st["tracer_iterations"],
                "host_syncs_tracer": st["host_syncs_tracer"]})
        cs.release()
        cfg_10b = cs.wedge_model_config(path, nx, ny, nz, pos, steps=3,
                                        solver=cs.BCGSL_ASM)
        tx, ty, tz = cs.TET_BOX
        verts, tets, top = cs.tet_box(tx, ty, tz, h=cs.TET_SIDE)
        tet = os.path.join(workdir, "tet_box.msh")
        cs.write_gmsh(tet, verts, [("tetra", tets)], version="4.1",
                      binary=True)

        def cell(i, j, k):
            return 6 * (i + tx * (j + ty * k))

        cfg_10d = cs.mesh_file_config(
            tet, 6 * tx * ty, tz, cs.TET_SIDE, cell(tx // 2, ty // 2, tz - 2),
            cell(tx // 4, ty // 2, 0), top, steps=3, solver=cs.LGMRES_LU)
        for key, cfg in (("10b", cfg_10b), ("10d", cfg_10d),
                         ("11c_one_rank", cfg_c), ("11b_one_rank", cfg_b)):
            rec[key] = _one_rank(cfg, key, device, profile=key in profile)
            cs.release()
    rec["seconds"] = time.perf_counter() - t0
    return rec


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--label", default=os.path.basename(os.getcwd()))
    parser.add_argument("--profile", default="",
                        help="comma-separated one-rank runs to profile: "
                        "10b, 10d, 11c_one_rank, 11b_one_rank")
    args = parser.parse_args(argv)
    sys.path.insert(0, os.getcwd())
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch_eager_paths: no CUDA device")
    print(json.dumps(measure(args.label,
                             profile=tuple(filter(None,
                                                  args.profile.split(","))))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
