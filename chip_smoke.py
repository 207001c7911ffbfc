#!/usr/bin/env python3
"""Smoke run of waiwera_tpu_torch on one CUDA device.

    python3 chip_smoke.py

Phases (any failure raises and the exit code is nonzero):
1. the card: nvidia-smi name and power limit, torch's CUDA, nvcc;
2. build the CUDA kernels csrc/dia_spmv.cu, csrc/stream_scale.cu and
   csrc/wge_cell_jvp.cu from the checkout (one nvcc each, started
   together, sm_90a; -Xptxas=-v prints each kernel's registers, shared
   memory and spills);
3. each kernel against its plain PyTorch version on the card:
   - dia_spmv_f32 at b = 1..4 with odd, negative and out-of-range
     offsets, and at the flagship shape (b = 3, offsets 0, +-1, +-128,
     +-8192, n = 532,480): rtol 1e-5, atol 1e-5 * max|y| (f32 FMA
     contraction and summation order);
   - dia_spmv_f64 at the same shapes: rtol 1e-12, atol 1e-12 * max|y|
     (f64 FMA contraction);
   - stream_scale (check_stream_grid) at sizes 0, 1, 3, 4, 5, 4,099,
     8 x 4,099 and 8 x 8Mi with element offsets 0-3 of x and of out each,
     and once at 2^31 + 5 elements: bitwise equal to x * 0.999999,
     nothing written outside out, the launch counts of stream_plan's
     pieces; then on an [8, 8Mi] f32 array, bitwise;
   with times taken in turns (paired_ms: each round one chain of 20
   launches of every call, CUDA events, the order reversed every other
   round): the SpMV kernel and its plain version over 6 rounds, the
   stream kernel, torch.mul(out=) and x * 0.999999 over 12, printed as
   medians and quartiles with the kernel/library ratio;
4. the main path: the port's bench (waiwera_tpu_torch/bench.py) in this
   process at its default sizes with every section (flagship 128 x 64
   x 64 settled step, stage breakdown, SpMV roofline with the stream
   kernel's bandwidth, reduced-box step, f64/f64 dtype table, ELL, MINC,
   CPU reference, preconditioner sweep with each preconditioner held
   for 2 accepted steps instead of 4), with every kernel count set to
   0 just before and read just after. Checks: the flagship settle
   accepted >= 2 steps, kernel launches = Krylov matvecs > 0 on the
   bjacobi sections (no matvec took the plain version), finite y;
   0 < spmv_roofline_fraction <= 1.05; measured bandwidth below
   1.05 x 3.35 TB/s; the MINC step ran the hybrid operator with
   launches > 0; every kernel was launched, and every stream_scale call
   through the vector kernel;
5. dia_spmv (f32 and f64) against the plain version on the flagship's
   first Jacobian, at the tolerances of phase 3, timed in turns with
   torch.sparse.mm on the same matrix as a CUDA CSR tensor (12 rounds);
6. the same three small-box steps on the card and on the CPU (plain
   SpMV), which must agree as the CPU port agrees with the JAX package
   (rtol 2e-5, atol 2e-5);
7. the model run, with the kernel counts set to 0 just before and read
   just after: the flagship model written as a JSON file (mesh section
   128 x 64 x 64, f32 Jacobian and BiCGStab, adaptive stepping from
   1e5 s, 6 steps, a checkpoint at 2e4 s, output every 2nd step with
   the water flux) and run with no device named through cli.run_json,
   which writes the HDF5 output through the port's own writer
   (utils/hdf5.py, which needs no h5py) and the YAML log;
   the mesh comes from the config. Checks: the run is not aborted, 6
   steps, output times increase and hold the checkpoint time, finite
   final state of 1,597,440 unknowns, dia_spmv launches = Krylov
   matvecs > 0, the log ends with timestepper end; the file read back
   with the port's reader: the times, cell_index, every cell field
   [records, 524,288], face_fields/flux_water [records, faces], the
   last record's pressure equal bit for bit to the host copy of the
   final state's. Then the restart from that file (initial.filename)
   through cli.run_json for 2 steps: the primaries it reads equal the
   first run's final primaries bit for bit (f64), its initial state
   equals the first run's final state, its own file checks out the same
   way, and dia_spmv launches = its Krylov matvecs > 0. Prints each
   run's output seconds, MB written and MB/s, and the restart read's
   seconds. Then the same JSON at 48 x 32 x 32 with BDF2 for 3 steps
   (checkpoint at 1e4 s), and the 5 x 4 x 3 box for 2 steps on the card
   and on the CPU: the same tries and sizes, y within rtol 2e-5, atol
   2e-5;
8. the EOS models (eos_model_config: the flagship box and rock, Corey
   relative permeability, van Genuchten capillarity, a per-cell initial
   state, a top boundary holding the top layer's state, a deliverability
   producer near the top and a 20 kg/s injector low down), each written
   as a JSON file and run with no device named through cli.run_json
   (HDF5 output through the port's writer), the kernel counts set to
   0 just before each run and read just after: (a) the default EOS "we"
   (no eos and no thermodynamics section) at 128 x 64 x 64 with a
   two-phase top zone, the schema's default solver (f64 Jacobian, f64
   BiCGStab, block-Jacobi), 4 adaptive steps; (b) "wse" on IFC-67 at
   48 x 32 x 32 with a halite zone and the power-law permeability
   modifier, the bench's f32 solver, 3 steps; (c) "wsce" (b = 4) and the
   isothermal "w" (b = 1) at 48 x 32 x 32, default solver, 3 steps each.
   Checks: not aborted, the steps taken, a finite final state, launches
   of the kernel of the run's linear dtype = Krylov matvecs > 0, and in
   (a) a final state of 532,480 x 2 and at least one cell whose region
   changed. Each run's System.jacobian_parts is timed at its final
   state. (d) the 5 x 4 x 3 "we" model on the card and on the CPU: the
   same tries and sizes (rtol 1e-12), regions equal, y within rtol 2e-5,
   atol 2e-5;
9. a production field (network_model_config) on the model of 8 (a) at
   128 x 64 x 64: 64 deliverability producers on an 8 x 8 grid of
   columns in the lowest two-phase layer (half with a fixed
   productivity and 'initial' reference pressure, half with productivity
   from an initial rate against a reference pressure table), 4 groups
   of 16 with separators at 0.55 MPa and steam limiters, a progressive
   field group with a total limiter, north and south groups with
   separators feeding two reinjectors to 8 injectors each in the bottom
   layer (rate outputs, overflow named; proportion outputs), 8 recharge
   sources, a make-up injector with a rate table, 2 liquid tracers
   (decay 1e-9 /s; Arrhenius 1e-6 /s, 2,000 J/mol, diffusion 1e-9), a
   permeability table on the producers' rock type and a porosity table
   on the injectors', 3 adaptive steps from 1e4 s with the source,
   group, reinjector and tracer fields written every step, through
   Simulation(config) + Timestepper with the in-memory output (the run
   hooks rock_for, which the CLI has no hook for) and no device named,
   the kernel counts set to 0 just before and read just
   after. Checks: not aborted, 3 steps, a finite 532,480 x 2 final
   state, dia_spmv_f64 launches = Krylov matvecs > 0, every group's
   limited flow within its limit x (1 + 1e-9), no reinjector injecting
   more than the separated water it receives, a converged tracer solve
   for every accepted step, tracers finite and >= -1e-12, and rock_for
   giving another permeability at the second try than at the first.
   Prints the run's times and counts, GMRES iterations per tracer solve,
   tracer-solve seconds per step, one synchronised flows(collect=) call,
   jacobian_parts with the network inside and host syncs per try. Then
   the same network at 5 x 4 x 3 on the card and on the CPU: the same
   tries, y within rtol 2e-5, atol 2e-5, tracers within 1e-6 of max|x|;
10. models read from mesh files that the script writes, each JSON model
   run through Simulation(config) + Timestepper with the kernel counts
   set to 0 just before and read just after, and the set-up split into
   file write, read, build_mesh, System and initial state: (a) phase 8
   (a)'s default-EOS model on a layered triangulation (wedge_mesh) of the
   flagship's plan area and depth, 128 x 64 squares in 2 triangles each,
   32 layers of 40 m: 524,288 wedges, 1,048,576 unknowns, the plan's
   triangles in reverse Cuthill-McKee order, from gmsh 4.1 binary, lgmres +
   asm, the nonlinear monitor on, 3 steps; jacobian_fd_error at the
   initial state (4 probes) must be below 1e-5 and the model must take
   the ELL route (no kernel: launches 0); (b) the same construction at
   48 x 32 x 16 written as exodus (NetCDF-3) and as gmsh 2.2 ASCII, which
   must read to equal geometry (rtol 1e-12, face cells exactly), run from
   the exodus file with bcgsl + asm through graphs (asserted); (c) phase
   8 (c) "w"'s box from gmsh
   4.1 ASCII, which must take the band route with dia_spmv_f64 launches
   = Krylov matvecs, and phase 8 (c) "w"'s tries with y within rtol
   2e-5; (d) a 5 x 4 x 3 box of 20 m cubes in 6 tetrahedra each (720
   unknowns) with lgmres + lu and the monitor, on the card (through
   graphs, asserted) and on the CPU: the same tries, y within rtol
   2e-5. Every monitored run must
   print one line per try and per Newton iteration. (a)'s file is also
   read with numpy and on the card (mesh/geometry.py), both timed: face
   order equal, geometry within rtol 1e-12;
11. the multi-device run (parallel/): 4 ranks sharing the card through
   gloo, spawned once (parallel/launch.py) for (a) phase 8 (a)'s "we"
   model at 128 x 64 x 64, bjacobi, 2 steps, (b) phase 9's production
   field at 48 x 32 x 32 with asm (the local DILU, restricted additive
   Schwarz), 3 steps, twice, (c) phase 10 (b)'s 49,152 wedges from gmsh
   4.1 binary (the graph partitioner, local RCM, the ELL route), lgmres
   + asm, 3 steps; each against the same model on one rank: the same
   tries and Newton iterations, y within rtol 1e-8 / atol 1e-10 in (a)
   and rtol 2e-5 in (b) (tracers too) and (c); on every rank of (a)
   dia_spmv_f64 launches = its Krylov matvecs > 0; (b)'s two runs
   repeat their counts (checked again with the C15 runs); (e) phase 8
   (d)'s 5 x 4 x 3 "we" model for 2 steps through cli.run_json over 2
   ranks sharing the card, rank 0 writing the HDF5 file through the
   port's writer, read back and held within rtol 1e-8 (atol 1e-8 of each
   dataset's largest magnitude) of the one-rank file; (d) where there
   are 2 cards or more, (a) over NCCL with one rank per card, else one
   line saying so. The one-rank runs go through cli.run_json. Then the
   ROADMAP C15
   check: phase 8 (c) "w" and phase 9's production field at 48 x 32 x 32,
   each twice in the default mode and twice under
   torch.use_deterministic_algorithms, which must repeat their counts;
   the fixed-order face scatter-sum against the index_adds it replaced;
   and the bench's settled flagship step with the fixed-order sums and
   with index_add in turn.

12. the timestep try as replayed CUDA graphs (solver/program.py)
   against the same try eagerly on the card: (a) the flagship settled
   (the bench's settle protocol through the graph program), then one
   step from that state through both: the same Newton, BiCGStab, matvec
   and masked counts, y, regions, fluid, balances and fluxes bitwise
   equal, host reads at most 1 + 2 per Newton iteration + 1 per
   BiCGStab chunk; (b) both timed in turns, 6 rounds, the order
   reversed every other round (medians, quartiles, graph/eager, host
   syncs, capture seconds, the card's name and power limit), and the
   graph step at krylov.CHUNK 4, 8 and 16 in turns (each equal to the
   first bit for bit); (c) phase 7's 48 x 32 x 32 JSON model for 3
   steps from a first step of 3e6 s (at least one refused try,
   asserted) through the graph program and eagerly: the same tries,
   counts and final state bit for bit; (d) the same model with BDF2 at
   first steps of 1e4 and 3e4 s, both runs on one Simulation through
   one captured program, each equal to its eager twin bit for bit.
   (e) phase 9's production field (128 x 64 x 64, 3 steps; its tracer
   step a program of its own) and (f) phase 10 (a)'s 524,288-wedge
   field (ELL route, lgmres + asm, monitor on, 3 steps), each through
   the graph program on one Simulation and eagerly on another: a first
   run in each mode (the graph run captures), then 3 timed rounds in
   turns, the order reversed every other round: every run's tries,
   Newton, Krylov and GMRES tracer iterations, matvecs, monitor lines
   and final state (y, regions, tracers, the network's flows) bitwise
   equal to the first graph run's; printed: (e) the tracer solve's
   seconds per step in both modes, its host reads per solve and
   captures, (f) the run loops, host reads per try, capture seconds and
   LGMRES cycles, each with the medians of the timed rounds (graph
   replays against eager runs), their ratio, and the first runs apart,
   with the card's name and power limit; then one more
   run in each mode under torch.profiler, each piece's device time read
   from the port's spans (piece_split), the graph run's with the
   device's busy seconds and share of the wall and the kernels by
   device time; then PyTorch's row gathers
   (x[index], index_select) against ops/segment.py RowGather at the
   Krylov loops' shapes (ROW_GATHER_SHAPES), equal bit for bit, timed in
   turns. (g) from (a)'s settled flagship, one step with line and one
   with cpr (f32, bcgs, as the bench runs them) through graphs and
   eagerly: the same counts and dia_spmv launches, y, regions, fluid,
   balances and fluxes bitwise equal; 3 rounds in turns (medians,
   ratio, host reads per try, capture seconds) and the kernels of one
   factorisation and one application of each preconditioner
   (torch.profiler over one replay of each as a CUDA graph, and over
   one eager call). (h) (f)'s wedge field with bcgsl + asm and (i) lu
   on phase 10 (d)'s tetrahedral box and on a 16 x 16 x 16 band-route
   box (13,056 unknowns, f64 bcgs + lu), each as (e)-(f): bitwise
   equal, timed in turns; printed: (h) the BiCGStab(l) chunks, (i) the
   box's factorisation seconds per Jacobian and the linear-algebra
   library behind it.
   `python3 chip_smoke.py --phase 12` runs phases 1, 2 and 12 alone.
13. the Jacobian's cell chain (csrc/wge_cell_jvp.cu, wge_cell_phase):
   the flagship's tries from 1e5 s (retry ladder, 2 steps accepted) as
   graphs, the kernel's launches equal to their Newton iterations; at the
   boiling state they reach, the kernel against the plain chain (every
   field's f32 error at most twice the plain f32 chain's against the
   plain f64 chain, equal phase compositions), then, replayed as CUDA
   graphs in turns (12 rounds, CUDA events): the plain cell chain, the
   kernel, the kernel with the source tangents, jacobian_parts on each
   route and the band pack with block-Jacobi, so the Jacobian's split
   before and after; the two cell chains also eagerly; the kernel's
   bound (bytes over 3.35 TB/s, transcendental calls over the special
   function units). Phase 7's flagship run also holds the kernel's
   launches to its Newton iterations. `python3 chip_smoke.py --phase 13`
   runs phases 1, 2 and 13 alone (~3 min).
   Every one-rank configuration runs as graphs: phases 4 (the bench's
   operating points and its stages, and the preconditioner sweep's
   line and cpr), 6, 7, 8, 9 (its tracer step too), 10 and 12 (each
   asserted: step_program "graph" in phases 4, 7 and 10 (b)-(d), and
   in every model run the program that step_program_mode gives its
   configuration); phase 11's ranks run eagerly (asserted and said: a
   distributed System), as does the C15 step cost (its A/B switch
   patches Python).

Prints each bench section's wall time on its own line, then the model
runs' times and counts, the bench's full JSON record, one JSON line
{"kernels": [...]} (launches on the bench path, on the phase 7 model run
and its restart,
over phase 8's card runs, on phase 9's full-size run, over phase 10's
card runs and over every rank of phase 11's runs; for stream_scale also
its vector kernel's launches on the bench path; the quartiles of kernel
and library in turns and their ratio) and the card's
nvidia-smi name and power limit; the last line is {"ok": true,
"device": {...}}. Exits nonzero without a CUDA device.
"""

from __future__ import annotations

import contextlib
import json
import os
import statistics
import sys
import tempfile
import time
import warnings

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

from waiwera_tpu_torch.bench import (  # noqa: E402
    build_sim,
    flagship_config,
    flagship_spacing,
    make_step,
)

__all__ = ["build_sim", "eos_model_config", "flagship_config",
           "flagship_spacing", "hex_box", "make_step", "mesh_file_config",
           "model_config", "model_run", "plan_rcm_order", "run_steps",
           "tet_box",
           "wedge_mesh", "wedge_model_config", "write_exodus", "write_gmsh"]

RTOL = {torch.float32: 1e-5, torch.float64: 1e-12}
FLAGSHIP = (128, 64, 64)
FLAGSHIP_OFFSETS = (-8192, -128, -1, 0, 1, 128, 8192)
FLAGSHIP_ROWS = 128 * 64 * 64 + 128 * 64  # interior + top ghost cells
# published H100 SXM rates at 700 W (NVIDIA data sheet): device memory,
# f32 outside the tensor cores, f64 outside the tensor cores
PEAK_BYTES_S = 3.35e12
PEAK_FLOP_S = {torch.float32: 67e12, torch.float64: 34e12}


def run_steps(sim, step, dts=None, accept=2, max_tries=12, log=None):
    """Drive the step function from the initial state: with dts, one try
    per listed dt; otherwise the retry ladder (dt x0.2 on failure) until
    `accept` steps are accepted. Returns the per-try results."""
    lhs, fluid, _ = sim.lhs_at(sim.y0, sim.region0)
    fx = sim.initial_fluxes(sim.y0, sim.region0)
    y, region, temp = sim.y0, sim.region0, fluid.temperature
    t, dt, first = 0.0, 1.0e5, 1.0
    tries = []
    while len(tries) < (len(dts) if dts else max_tries):
        if dts:
            dt = dts[len(tries)]
        t0 = time.perf_counter()
        res, f_new, lhs_new, fx_new = step(
            y, region, temp, lhs, lhs, t, dt, dt, first,
            fluid_last=fluid, fluxes_last=fx,
        )
        if sim.device.type == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        ok = res.converged and not res.failed
        tries.append((dt, res, wall))
        if log:
            log(f"try {len(tries)}: dt {dt:.6g} s accepted {ok} "
                f"newton {res.iterations} krylov {res.linear_iterations} "
                f"matvecs {res.matvecs} host_syncs {res.host_syncs} "
                f"wall {wall:.3f} s")
        if ok:
            y, region, temp = res.y, res.region, f_new.temperature
            lhs, fluid, fx = lhs_new, f_new, fx_new
            t += dt
            first = 0.0
            if not dts and sum(r.converged and not r.failed
                               for _, r, _ in tries) >= accept:
                break
        elif not dts:
            dt *= 0.2
    return tries


def paired_ms(calls, rounds=12, k=20):
    """Time the calls {name: fn} in turns: each round runs one chain of k
    calls of every fn, timed with CUDA events, the order reversed every
    other round (one warm-up chain each first). Returns {name: (q1,
    median, q3)} of ms per call over the rounds."""
    for fn in calls.values():
        for _ in range(k):
            fn()
    torch.cuda.synchronize()
    names = list(calls)
    times = {n: [] for n in names}
    for r in range(rounds):
        for n in (names if r % 2 == 0 else names[::-1]):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(k):
                calls[n]()
            end.record()
            end.synchronize()
            times[n].append(start.elapsed_time(end) / k)
    return {n: tuple(statistics.quantiles(v, n=4, method="inclusive"))
            for n, v in times.items()}


def _quartile_fields(t, prefix):
    """The (q1, median, q3) of paired_ms as record fields."""
    if t is None:
        return {f"{prefix}ms": None, f"{prefix}q1_ms": None,
                f"{prefix}q3_ms": None}
    return {f"{prefix}ms": t[1], f"{prefix}q1_ms": t[0],
            f"{prefix}q3_ms": t[2]}


def _bound_ms(nbytes, flops, dtype):
    """Least time of the card for the work: the larger of bytes over the
    memory rate and operations over the type's rate, and which binds."""
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = flops / PEAK_FLOP_S[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations")


def spmv_work(m):
    """(bytes, flops) of one band SpMV: each band value, x and y once."""
    D, bb, n = len(m.offsets), m.block_size ** 2, m.num_rows
    size = m.bands.element_size()
    return (D * bb * n + 2 * n * m.block_size) * size, 2 * D * bb * n


def to_csr(m):
    """The band matrix m as a CUDA CSR tensor [n*b, n*b] (the library
    yardstick; the port never calls it)."""
    b, n = m.block_size, m.num_rows
    dev = m.bands.device
    i = torch.arange(n, device=dev)
    rows, cols, vals = [], [], []
    for k, d in enumerate(m.offsets):
        j = i + d
        ok = (j >= 0) & (j < n)
        for r in range(b):
            for c in range(b):
                rows.append(i[ok] * b + r)
                cols.append(j[ok] * b + c)
                vals.append(m.bands[k, r * b + c, :n][ok])
    coo = torch.sparse_coo_tensor(
        torch.stack([torch.cat(rows), torch.cat(cols)]), torch.cat(vals),
        (n * b, n * b),
    ).coalesce()
    return coo.to_sparse_csr()


def compare_spmv(m, x, label, log, library=False):
    """Kernel vs plain version on the card, timed in turns (paired_ms;
    with library, beside torch.sparse.mm on the CSR form): dict of
    max_abs_err, ms, q1_ms, q3_ms, plain_ms, library_ms, library_q1_ms,
    library_q3_ms and ratio_to_library (None without library),
    bound_ms and bound_by."""
    from waiwera_tpu_torch.ops import dia

    rtol = RTOL[m.bands.dtype]
    y = dia.dia_matvec(m, x)
    torch.cuda.synchronize()
    y_ref = dia.dia_matvec_reference(m, x)
    err = float((y - y_ref).abs().max())
    scale = float(y_ref.abs().max())
    torch.testing.assert_close(y, y_ref, rtol=rtol, atol=rtol * scale)
    calls = {"kernel": lambda: dia.dia_matvec(m, x),
             "plain": lambda: dia.dia_matvec_reference(m, x)}
    if library:
        csr = to_csr(m)
        xv = x.reshape(-1, 1)
        y_lib = torch.sparse.mm(csr, xv).reshape(x.shape)
        torch.testing.assert_close(y_lib, y_ref, rtol=rtol, atol=rtol * scale)
        calls["library"] = lambda: torch.sparse.mm(csr, xv)
    t = paired_ms(calls, rounds=12 if library else 6)
    nbytes, flops = spmv_work(m)
    bound, bound_by = _bound_ms(nbytes, flops, m.bands.dtype)
    rec = {"max_abs_err": err, **_quartile_fields(t["kernel"], ""),
           "plain_ms": t["plain"][1],
           **_quartile_fields(t.get("library"), "library_"),
           "bound_ms": bound, "bound_by": bound_by, "bytes": nbytes}
    rec["ratio_to_library"] = (rec["ms"] / rec["library_ms"] if library
                               else None)
    log(f"spmv {label}: {m.bands.dtype} b {m.block_size} offsets "
        f"{m.offsets} n {m.num_rows} max_abs_err {err:.3e} (max|y| "
        f"{scale:.3e}) kernel {_fmt(t['kernel'])} plain "
        f"{_fmt(t['plain'])} library {_fmt(t.get('library'))} bound "
        f"{bound:.4f} ms ({bound_by}); kernel/library "
        f"{rec['ratio_to_library']}")
    return rec


def _fmt(t):
    """(q1, median, q3) in ms as text."""
    if t is None:
        return "None"
    return f"{t[1]:.4f} ms (q1 {t[0]:.4f}, q3 {t[2]:.4f})"


STREAM_SIZES = (0, 1, 3, 4, 5, 4099, 8 * 4099, 8 * 8 * 1024 * 1024)
# elements, above 2^31: at offsets (1, 1) the vector kernel's body starts
# beyond 2^31 bytes of each buffer; at (1, 2) the scalar kernel takes the
# whole array and its grid-stride loop's index passes 2^31
STREAM_BIG = 2 ** 31 + 5


def check_stream_grid(log, big=True):
    """stream_scale on the card at every size of STREAM_SIZES with element
    offsets 0-3 of x and of out each (mismatched ones included), then
    (big) at STREAM_BIG elements (8 GiB in, 8 GiB out) with offsets 1
    and 1 (head, vector body, tail) and 1 and 2 (all scalar): every call
    bitwise equal to x * 0.999999, nothing written outside out, and each
    kernel's launch count up by the number of ranges stream_plan gives
    it. Returns the number of calls checked."""
    from waiwera_tpu_torch.ops import stream

    gen = torch.Generator(device="cuda").manual_seed(1)
    top = max(STREAM_SIZES) + 8
    xb = torch.rand(top, generator=gen, device="cuda") + 0.5
    ob = torch.empty_like(xb)
    cases = [(n, ox, oo) for n in STREAM_SIZES for ox in range(4)
             for oo in range(4)]

    def one(n, ox, oo):
        xv, ov = xb[ox:ox + n], ob[oo:oo + n]
        ob.fill_(float("nan"))
        plan = stream.stream_plan(xv.data_ptr(), ov.data_ptr(), n)
        before = (stream.stream_scale_launches.count,
                  stream.stream_scalar_launches.count)
        stream.stream_scale(xv, ov)
        torch.cuda.synchronize()
        after = (stream.stream_scale_launches.count,
                 stream.stream_scalar_launches.count)
        want = (sum(k == "vec4" for k, _, _ in plan),
                sum(k == "scalar" for k, _, _ in plan))
        if (after[0] - before[0], after[1] - before[1]) != want:
            raise RuntimeError(f"stream_scale n {n} offsets {ox}, {oo}: "
                               f"launch counts {before} -> {after}, plan "
                               f"{plan}")
        if not torch.equal(ov, xv * stream.SCALE):
            raise RuntimeError(f"stream_scale n {n} offsets {ox}, {oo}: not "
                               "bitwise equal to x * 0.999999")
        if not (bool(torch.isnan(ob[:oo]).all())
                and bool(torch.isnan(ob[oo + n:]).all())):
            raise RuntimeError(f"stream_scale n {n} offsets {ox}, {oo} wrote "
                               "outside out")
        return plan

    vec4 = sum(any(k == "vec4" for k, _, _ in one(*c)) for c in cases)
    checked = len(cases)
    del xb, ob
    if big:
        xb = torch.rand(STREAM_BIG + 3, generator=gen, device="cuda") + 0.5
        ob = torch.empty_like(xb)
        for offsets, kinds in (((1, 1), ["scalar", "vec4", "scalar"]),
                               ((1, 2), ["scalar"])):
            plan = one(STREAM_BIG, *offsets)
            if [k for k, _, _ in plan] != kinds:
                raise RuntimeError(f"stream_scale n {STREAM_BIG} offsets "
                                   f"{offsets}: plan {plan}")
            checked += 1
        del xb, ob
        torch.cuda.empty_cache()
    log(f"stream_scale grid: {checked} calls bitwise equal to x * 0.999999 "
        f"(sizes {STREAM_SIZES}{f' and {STREAM_BIG}' if big else ''}, "
        f"offsets 0-3 of x and out), {vec4} of the grid through the vector "
        "kernel")
    return checked


def compare_stream(log):
    """stream_scale on the card: the grid of check_stream_grid, then on
    [8, 8Mi] f32 against x * 0.999999 (bitwise), timed in turns with
    torch.mul(out=) (the library call) and x * 0.999999 (plain)."""
    from waiwera_tpu_torch.ops import stream

    check_stream_grid(log)
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.rand((stream.N_SUB, stream.N_LANE), generator=gen,
                   device="cuda") + 0.5
    out = torch.empty_like(x)
    counts0 = (stream.stream_scale_launches.count,
               stream.stream_scalar_launches.count)
    stream.stream_scale(x, out)
    torch.cuda.synchronize()
    if (stream.stream_scale_launches.count - counts0[0],
            stream.stream_scalar_launches.count - counts0[1]) != (1, 0):
        raise RuntimeError("stream_scale [8, 8Mi] did not take the vector "
                           "kernel alone")
    ref = x * stream.SCALE
    bitwise = bool(torch.equal(out, ref))
    err = float((out - ref).abs().max())
    if not bitwise:
        raise RuntimeError(f"stream_scale [8, 8Mi] is not bitwise equal to "
                           f"x * 0.999999 (max abs err {err:.3e})")
    del ref
    y = torch.empty_like(x)
    t = paired_ms({
        "kernel": lambda: stream.stream_scale(x, out),
        "library": lambda: torch.mul(x, stream.SCALE, out=y),
        "plain": lambda: x * stream.SCALE,
    }, rounds=12)
    nbytes = 2 * x.numel() * 4
    bound, bound_by = _bound_ms(nbytes, x.numel(), torch.float32)
    rec = {"max_abs_err": err, **_quartile_fields(t["kernel"], ""),
           "plain_ms": t["plain"][1],
           **_quartile_fields(t["library"], "library_"),
           "bound_ms": bound, "bound_by": bound_by, "bytes": nbytes,
           "bitwise_equal": bitwise}
    rec["ratio_to_library"] = rec["ms"] / rec["library_ms"]
    log(f"stream_scale [8, 8Mi] f32 in turns (12 rounds of 20 launches): "
        f"kernel {_fmt(t['kernel'])} ({nbytes / rec['ms'] / 1e6:.1f} GB/s), "
        f"torch.mul(out=) {_fmt(t['library'])}, plain {_fmt(t['plain'])}, "
        f"kernel/library {rec['ratio_to_library']:.4f}, bound "
        f"{bound:.4f} ms ({bound_by}, {bound / rec['ms']:.3f} of it)")
    return rec


def random_matrix(rng, b, n, offsets, device, dtype=torch.float32):
    from waiwera_tpu_torch.ops import dia

    bands = torch.as_tensor(rng.standard_normal((len(offsets), b * b, n)),
                            dtype=dtype, device=device)
    x = torch.as_tensor(rng.standard_normal((n, b)), dtype=dtype,
                        device=device)
    return dia.DIAMatrix(offsets=tuple(offsets), bands=bands, block_size=b,
                         num_rows=n), x


def log(msg):
    print(msg, flush=True)


# checkpoint times, s. A checkpoint below the first step size clips the
# first try to itself, so the run reaches it on its first accepted steps:
# the flagship accepts 2e4 s from its initial state, the smaller boxes
# 1e4 s or, after one refusal, its fifth three times over
CHECKPOINT = 2.0e4
CHECKPOINT_SMALL = 1.0e4


def model_config(nx, ny, nz, method="beuler", steps=6,
                 checkpoint=CHECKPOINT):
    """The flagship model as a whole JSON model: its mesh as a config
    section, the bench's solver settings (f32 Jacobian, f32 BiCGStab
    with block-Jacobi, at least one Newton iteration), adaptive stepping
    from 1e5 s, a checkpoint and flux output."""
    cfg = flagship_config(nx, ny, nz)
    (dx, dy, dz), _ = flagship_spacing(nx, ny, nz)
    cfg["mesh"] = {"type": "rectangular", "dx": dx, "dy": dy, "dz": dz}
    cfg["time"] = {"step": {
        "method": method, "size": 1.0e5, "adapt": {"on": True},
        "maximum": {"number": steps, "tries": 10},
        "solver": {
            "nonlinear": {"minimum": {"iterations": 1}},
            "linear": {"dtype": "float32", "jacobian_dtype": "float32",
                       "preconditioner": {"type": "bjacobi"}},
        },
    }}
    cfg["output"] = {"frequency": 2, "checkpoint": {"time": [checkpoint]},
                     "fields": {"flux": ["water"]}}
    return cfg


# phase 8: the EOS models. Each is the flagship box (50 x 50 x 20 m
# cells, the flagship's rock) as a JSON model with its mesh section, a
# per-cell initial state near hydrostatic equilibrium (bottom layer
# first, the top layer last), a Dirichlet top boundary holding the top
# layer's state, a deliverability producer near the top and a 20 kg/s
# injector low down
EOS_DZ = 20.0
EOS_STATES = {
    # default EOS "we" on IAPWS-97: two-phase (region 4, [P, S_v]) in
    # the top quarter of the layers, liquid ([P, T]) below at one
    # temperature, 0.5 K above the saturation temperature of the top
    # liquid layer: that layer flashes to two-phase on the first Newton
    # iteration, the deeper (higher-pressure) ones stay liquid
    "we": {"p_top": 2.0e6, "density": 870.0},
    # "wse" on IFC-67: brine with salt mass fraction 0.1 at 150 C; the
    # lower layers' first half in x holds halite (region 5, liquid +
    # solid saturation 0.02); power-law permeability modifier
    "wse": {"p_top": 1.0e6, "density": 1000.0},
    # "wsce": brine with salt 0.05 and a CO2 partial pressure of 2e5 Pa
    # at 150 C
    "wsce": {"p_top": 1.0e6, "density": 950.0},
    # isothermal "w" at 20 C
    "w": {"p_top": 2.0e5, "density": 998.0},
}


def _saturation_temperature(p):
    from waiwera_tpu_torch.thermo import iapws97

    t, _ = iapws97.saturation_temperature(
        torch.as_tensor(np.asarray(p, np.float64)))
    return t.numpy()


def eos_initial_state(kind, nx, ny, nz, dz=EOS_DZ):
    """(primary [n, npv], region [n]) of the EOS model `kind`, cells in
    the mesh's natural order (x fastest, the top layer last), layers dz
    thick."""
    st = EOS_STATES[kind]
    depth = (nz - 1 - np.arange(nz) + 0.5) * dz  # per layer, from top
    p = st["p_top"] + st["density"] * 9.8 * (depth - 0.5 * dz)
    layer = np.repeat(np.arange(nz), nx * ny)
    i = np.tile(np.arange(nx), ny * nz)
    pc = p[layer]
    region = np.ones(nx * ny * nz, np.int32)
    if kind == "we":
        two_phase = layer >= nz - max(1, nz // 4)
        base = nz - max(1, nz // 4)  # lowest two-phase layer
        t_liq = float(_saturation_temperature(p[base - 1])) + 0.5 \
            if base > 0 else 200.0
        # vapour saturation 0.3 at the top, 0.01 at the zone's base
        frac = (layer - base) / max(1, nz - 1 - base)
        second = np.where(two_phase, 0.01 + 0.29 * frac, t_liq)
        region[two_phase] = 4
        primary = np.stack([pc, second], axis=1)
    elif kind == "wse":
        halite = (layer < nz // 2) & (i < nx // 2)
        region[halite] = 5
        third = np.where(halite, 0.02, 0.1)
        primary = np.stack([pc, np.full_like(pc, 150.0), third], axis=1)
    elif kind == "wsce":
        primary = np.stack([pc, np.full_like(pc, 150.0),
                            np.full_like(pc, 0.05),
                            np.full_like(pc, 2.0e5)], axis=1)
    else:
        primary = pc[:, None]
    return primary, region


def eos_model_config(kind, nx, ny, nz, steps=3, size=1.0e4, solver=None):
    """The EOS model `kind` ("we", "wse", "wsce" or "w") as a whole JSON
    model: adaptive stepping from `size` for `steps` steps with the
    schema's default solver (f64 Jacobian, f64 BiCGStab, block-Jacobi)
    unless `solver` replaces time.step.solver. "we" has no eos and no
    thermodynamics section."""
    (dx, dy, dz), _ = flagship_spacing(nx, ny, nz)
    n = nx * ny * nz
    top0 = n - nx * ny
    primary, region = eos_initial_state(kind, nx, ny, nz)
    cfg = {"title": f"EOS {kind} model {nx} x {ny} x {nz}"}
    if kind == "wse":
        cfg["thermodynamics"] = "ifc67"
        cfg["eos"] = {"name": "wse",
                      "permeability_modifier": {"type": "power"}}
    elif kind != "we":
        cfg["eos"] = {"name": kind}
    cfg.update({
        "mesh": {"type": "rectangular", "dx": dx, "dy": dy, "dz": dz},
        "rock": {
            "types": [{"name": "res", "permeability": [5e-14, 5e-14, 2e-14],
                       "porosity": 0.1}],
            "relative_permeability": {"type": "corey", "slr": 0.3,
                                      "ssr": 0.1},
            "capillary_pressure": {"type": "van_genuchten", "P0": 1.0e4,
                                   "lambda": 0.45, "slr": 1e-3},
        },
        "initial": {"primary": primary.tolist(), "region": region.tolist()},
        "boundaries": [{
            "primary": primary[-1].tolist(), "region": int(region[-1]),
            "faces": {"cells": list(range(top0, n)),
                      "normal": [0.0, 0.0, 1.0]},
        }],
        "source": [
            {"cell": top0 - nx * ny + nx * (ny // 2) + nx // 2,
             "deliverability": {
                 "productivity": 1e-12,
                 "pressure": 0.5 * EOS_STATES[kind]["p_top"]},
             "direction": "production"},
            {"cell": nx * (ny // 2) + nx // 4, "rate": 20.0,
             "enthalpy": 500.0e3},
        ],
        "time": {"step": {
            "size": size, "adapt": {"on": True},
            "maximum": {"number": steps, "tries": 10},
        }},
        "output": {"frequency": 0, "initial": False, "final": True,
                   "fields": {"flux": ["water"]}},
    })
    if solver is not None:
        cfg["time"]["step"]["solver"] = solver
    return cfg


# phase 9: a production field on the default-EOS model of phase 8 (a).
# Producers on a square grid of columns (8 x 8 at full size) in the
# lowest two-phase layer, in 4 groups with separators and steam
# limiters under a field group; two reinjectors, each fed by the
# separated water of two groups, to 8 injectors each in the bottom
# layer; recharge on the sides, a make-up injector, two liquid tracers
# and rock controls
NETWORK_SEPARATOR_P = 0.55e6
# limits and reinjection rates per producer of the node, kg/s: sized so
# that every limiter acts from the first step at any box size
NETWORK_STEAM_LIMIT = 0.1  # steam of a group
NETWORK_FIELD_LIMIT = 0.45  # total of the field group
NETWORK_REINJECT_RATE = 0.125  # each rate output of the first reinjector
NETWORK_TRACERS = [
    {"name": "inj", "phase": "liquid", "decay": 1.0e-9},
    {"name": "arr", "phase": "liquid", "decay": 1.0e-6,
     "activation": 2000.0, "diffusion": 1.0e-9},
]


def network_model_config(nx, ny, nz, steps=3, size=1.0e4):
    """The production-field model of phase 9 on an nx x ny x nz box:
    eos_model_config("we", ...) with its sources replaced by a source
    network (the keys of the JAX package's _parse_source and
    _parse_network), a tracer section, rock controls and output of the
    source, group, reinjector and tracer fields every step. The well
    grid is g x g columns, g = min(8, nx, ny) rounded down to even."""
    cfg = eos_model_config("we", nx, ny, nz, steps=steps, size=size)
    primary, _ = eos_initial_state("we", nx, ny, nz)
    g = max(2, min(8, nx, ny) // 2 * 2)
    layer = nz - max(1, nz // 4)  # the lowest two-phase layer

    def cell(i, j, k):
        return i + nx * (j + ny * k)

    cols = [(int((2 * a + 1) * nx // (2 * g)), int((2 * b + 1) * ny // (2 * g)))
            for b in range(g) for a in range(g)]
    sources, prod_cells = [], []
    for w, (i, j) in enumerate(cols):
        c = cell(i, j, layer)
        p0 = float(primary[c, 0])
        if w % 2 == 0:
            deliv = {"productivity": 2.0e-12, "pressure": "initial"}
            src = {"name": f"p{w}", "cell": c, "deliverability": deliv,
                   "direction": "production"}
        else:
            # productivity from an initial rate against a falling
            # reference pressure
            deliv = {"pressure": [[0.0, 0.8 * p0], [1.0e5, 0.7 * p0]]}
            src = {"name": f"p{w}", "cell": c, "rate": -2.0,
                   "deliverability": deliv, "direction": "production"}
        sources.append(src)
        prod_cells.append(c)
    per = len(cols) // 4
    groups = [{"name": f"g{k}",
               "in": [f"p{w}" for w in range(k * per, (k + 1) * per)],
               "separator": {"pressure": NETWORK_SEPARATOR_P},
               "limiter": {"steam": NETWORK_STEAM_LIMIT * per}}
              for k in range(4)]
    groups.append({"name": "field", "in": ["g0", "g1", "g2", "g3"],
                   "scaling": "progressive",
                   "limiter": {"total": NETWORK_FIELD_LIMIT * len(cols)}})
    for name, members in (("north", ["g0", "g1"]), ("south", ["g2", "g3"])):
        groups.append({"name": name, "in": members,
                       "separator": {"pressure": NETWORK_SEPARATOR_P}})
    # 16 injectors on a 4 x 4 grid of the bottom layer
    inj_cells = [cell(int((2 * a + 1) * nx // 8), int((2 * b + 1) * ny // 8),
                      0) for b in range(4) for a in range(4)]
    inj_cell_set = set(inj_cells)
    for k, c in enumerate(inj_cells):
        sources.append({"name": f"i{k}", "cell": c,
                        "tracer": {"inj": 1.0e-4}})
    reinject = [
        {"name": "reinj_a", "in": "north", "overflow": "reinj_b",
         "water": [{"out": f"i{k}", "rate": NETWORK_REINJECT_RATE * per}
                   for k in range(8)]},
        {"name": "reinj_b", "in": "south",
         "water": [{"out": f"i{k}", "proportion": 0.1}
                   for k in range(8, 16)]},
    ]
    # recharge in 8 side cells, 4 on each x side
    for k in range(8):
        i = 0 if k < 4 else nx - 1
        j = (k % 4) * ny // 4
        sources.append({"name": f"rch{k}", "cell": cell(i, j, k % nz),
                        "recharge": {"coefficient": 1.0e-6,
                                     "pressure": "initial"}})
    sources.append({"name": "makeup", "cell": cell(nx // 2, ny // 2, 0),
                    "rate": [[0.0, 5.0], [1.0e5, 10.0]],
                    "enthalpy": 4.0e5})
    cfg["title"] = f"production field model {nx} x {ny} x {nz}"
    cfg["source"] = sources
    cfg["network"] = {"group": groups, "reinject": reinject}
    cfg["tracer"] = [dict(t) for t in NETWORK_TRACERS]
    cfg["initial"]["tracer"] = [0.0, 1.0e-3]
    res = cfg["rock"]["types"][0]
    cfg["rock"]["types"] = [
        res,
        {"name": "prod", "cells": prod_cells,
         "permeability": [[0.0, 5e-14, 5e-14, 2e-14],
                          [1.0e5, 1e-13, 1e-13, 4e-14]],
         "porosity": 0.1},
        {"name": "inj", "cells": sorted(inj_cell_set),
         "permeability": [5e-14, 5e-14, 2e-14],
         "porosity": [[0.0, 0.1], [1.0e5, 0.12]]},
    ]
    cfg["output"] = {
        "frequency": 1, "initial": False, "final": False,
        "fields": {
            "flux": ["water"],
            "source": ["natural_cell_index", "component", "rate",
                       "enthalpy", "water_rate", "steam_rate", "tracer_flow"],
            "network_group": ["rate", "enthalpy", "water_rate",
                              "steam_rate"],
            "network_reinject": ["water_rate", "output_water_rate",
                                 "overflow_water_rate"],
        },
    }
    return cfg


# phase 10: unstructured models read from mesh files. The meshes are made
# here and written in the formats the port reads; the port itself has no
# mesh writer, as the JAX package has none
WEDGE_DX = 50.0  # plan squares, m
WEDGE_DZ = 40.0  # layers, m
# the flagship's plan area (6.4 km x 3.2 km) and depth (1.28 km):
# 128 x 64 squares of 2 triangles, 32 layers = 524,288 wedges
WEDGE_FIELD = (128, 64, 32)
WEDGE_REDUCED = (48, 32, 16)  # 49,152 wedges, the bench's reduced count
GMSH_TYPES = {"line": 1, "triangle": 2, "quad": 3, "tetra": 4,
              "hexahedron": 5, "wedge": 6, "pyramid": 7}
EXODUS_TYPES = {"triangle": "TRI3", "quad": "QUAD4", "tetra": "TETRA4",
                "hexahedron": "HEX8", "wedge": "WEDGE6",
                "pyramid": "PYRAMID5"}


def plan_rcm_order(tris):
    """Reverse Cuthill-McKee order of plan triangles [T, 3] over their
    shared edges (scipy.sparse.csgraph): order[k] is the triangle that
    takes in-layer number k."""
    import scipy.sparse as sp
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    t = len(tris)
    edges = np.sort(tris[:, [0, 1, 1, 2, 2, 0]].reshape(-1, 2), axis=1)
    owner = np.repeat(np.arange(t), 3)
    key = edges[:, 0] * (int(tris.max()) + 1) + edges[:, 1]
    srt = np.argsort(key, kind="stable")
    same = key[srt][1:] == key[srt][:-1]
    a, b = owner[srt][:-1][same], owner[srt][1:][same]
    adj = sp.coo_matrix((np.ones(2 * len(a)), (np.r_[a, b], np.r_[b, a])),
                        shape=(t, t)).tocsr()
    return np.asarray(reverse_cuthill_mckee(adj, symmetric_mode=True),
                      np.int64)


def wedge_mesh(nx, ny, nz, dx=WEDGE_DX, dz=WEDGE_DZ, order="rcm"):
    """A layered triangulation: nx x ny plan squares of side dx, each
    split into 2 triangles with the diagonal alternating square by
    square, extruded over nz layers of dz (the top at z = 0). Cells are
    numbered layer by layer from the bottom; within a layer the plan
    triangles come in reverse Cuthill-McKee order (order "rcm", a
    bandwidth-reducing renumbering that keeps neighbours close but gives
    no constant-offset bands) or in square order ("squares", which the
    band route takes). Returns (vertices [nv, 3], wedges [2 nx ny nz, 6],
    pos) with pos[t] the in-layer number of plan triangle
    t = 2 (i + nx j) + h (h = 0, 1)."""
    nvx, nvy = nx + 1, ny + 1
    X, Y = np.meshgrid(np.arange(nvx) * dx, np.arange(nvy) * dx,
                       indexing="xy")
    plan = np.stack([X.ravel(), Y.ravel()], axis=1)
    z = -nz * dz + np.arange(nz + 1) * dz
    verts = np.concatenate([np.column_stack([plan, np.full(len(plan), zk)])
                            for zk in z])
    j, i = (a.ravel() for a in np.meshgrid(np.arange(ny), np.arange(nx),
                                           indexing="ij"))
    v00, v10 = j * nvx + i, j * nvx + i + 1
    v01, v11 = v00 + nvx, v10 + nvx
    a = ((i + j) % 2 == 0)[:, None]
    t0 = np.where(a, np.stack([v00, v10, v11], 1), np.stack([v00, v10, v01], 1))
    t1 = np.where(a, np.stack([v00, v11, v01], 1), np.stack([v10, v11, v01], 1))
    tris = np.stack([t0, t1], axis=1).reshape(-1, 3)
    if order == "rcm":
        perm = plan_rcm_order(tris)
    elif order == "squares":
        perm = np.arange(len(tris))
    else:
        raise ValueError(f"unknown plan order {order!r}")
    pos = np.empty_like(perm)
    pos[perm] = np.arange(len(perm))
    layer = tris[perm]
    nplan = nvx * nvy
    wedges = np.concatenate([np.column_stack([layer + k * nplan,
                                              layer + (k + 1) * nplan])
                             for k in range(nz)])
    return verts, wedges.astype(np.int64), pos


def tet_box(nx, ny, nz, h=1.0):
    """An nx x ny x nz box of cubes of side h (the top at z = 0), each
    cube split into the 6 tetrahedra along its main diagonal (the same
    split in every cube, so faces match). Cells are numbered cube by
    cube (x fastest, the top layer last), 6 per cube. Returns (vertices,
    tetrahedra [6 nx ny nz, 4], top) with top the tetrahedra that have a
    face on the top of the box."""
    nvx, nvy = nx + 1, ny + 1
    kk, jj, ii = np.meshgrid(np.arange(nz + 1), np.arange(nvy),
                             np.arange(nvx), indexing="ij")
    verts = np.stack([ii.ravel() * h, jj.ravel() * h,
                      (kk.ravel() - nz) * h], axis=1).astype(np.float64)
    k, j, i = (a.ravel() for a in np.meshgrid(
        np.arange(nz), np.arange(ny), np.arange(nx), indexing="ij"))

    def vid(a, b, c):
        return ((k + c) * nvy + (j + b)) * nvx + (i + a)

    perms = ((0, 1, 2), (0, 2, 1), (1, 0, 2), (1, 2, 0), (2, 0, 1),
             (2, 1, 0))
    tets = []
    for p in perms:
        step = [np.zeros(3, int)]
        for axis in p[:2]:
            e = step[-1].copy()
            e[axis] = 1
            step.append(e)
        tets.append(np.stack([vid(*s) for s in step] + [vid(1, 1, 1)], 1))
    tets = np.stack(tets, axis=1).reshape(-1, 4)
    ncube = nx * ny * nz
    top = [6 * c + q for c in range(ncube - nx * ny, ncube)
           for q, p in enumerate(perms) if p[0] == 2]
    return verts, tets.astype(np.int64), top


def hex_box(nx, ny, nz, widths):
    """The vertices and hexahedra of rectangular_mesh's 3-D box (cell
    widths (dx, dy, dz), origin 0), cells in natural order."""
    edges = [np.concatenate([[0.0], np.cumsum(w)]) for w in widths]
    nvx, nvy = nx + 1, ny + 1
    kk, jj, ii = np.meshgrid(np.arange(nz + 1), np.arange(nvy),
                             np.arange(nvx), indexing="ij")
    verts = np.stack([edges[0][ii.ravel()], edges[1][jj.ravel()],
                      edges[2][kk.ravel()]], axis=1)
    k, j, i = (a.ravel() for a in np.meshgrid(
        np.arange(nz), np.arange(ny), np.arange(nx), indexing="ij"))

    def vid(a, b, c):
        return ((k + c) * nvy + (j + b)) * nvx + (i + a)

    conn = np.stack([vid(0, 0, 0), vid(1, 0, 0), vid(1, 1, 0), vid(0, 1, 0),
                     vid(0, 0, 1), vid(1, 0, 1), vid(1, 1, 1), vid(0, 1, 1)],
                    axis=1)
    return verts, conn.astype(np.int64)


def write_gmsh(path, verts, blocks, version="4.1", binary=True):
    """Write vertices [nv, 2 or 3] and cell blocks [(type, connectivity
    0-based)] as a gmsh file: format 2.2 or 4.1, ASCII or binary
    (little-endian; 4.1 with 8-byte size_t). Node tags are the vertex
    numbers + 1, element tags count from 1 in block order."""
    v3 = np.zeros((len(verts), 3))
    v3[:, : verts.shape[1]] = verts
    nn = len(v3)
    ntot = sum(len(c) for _, c in blocks)
    dim = 3 if any(t in ("tetra", "hexahedron", "wedge", "pyramid")
                   for t, _ in blocks) else 2
    tags = np.arange(1, nn + 1)
    out = [f"$MeshFormat\n{version} {int(binary)} 8\n".encode()]
    if binary:
        out.append(np.int32(1).tobytes() + b"\n")
    out.append(b"$EndMeshFormat\n$Nodes\n")

    def text(rows, fmt):
        return ("\n".join(fmt % tuple(r) for r in rows.tolist()) + "\n"
                ).encode()

    if version == "2.2":
        out.append(f"{nn}\n".encode())
        if binary:
            rec = np.zeros(nn, np.dtype([("id", "<i4"), ("x", "<f8", 3)]))
            rec["id"], rec["x"] = tags, v3
            out += [rec.tobytes(), b"\n"]
        else:
            out.append(text(np.column_stack([tags, v3]).astype(object),
                            "%d %.17g %.17g %.17g"))
        out.append(f"$EndNodes\n$Elements\n{ntot}\n".encode())
        first = 1
        for t, c in blocks:
            ids = np.arange(first, first + len(c))
            first += len(c)
            if binary:
                out.append(np.array([GMSH_TYPES[t], len(c), 2],
                                    "<i4").tobytes())
                rec = np.column_stack([ids, np.zeros((len(c), 2), int),
                                       c + 1]).astype("<i4")
                out.append(rec.tobytes())
            else:
                rec = np.column_stack([ids, np.full(len(c), GMSH_TYPES[t]),
                                       np.full(len(c), 2),
                                       np.zeros((len(c), 2), int), c + 1])
                out.append(text(rec, " ".join(["%d"] * rec.shape[1])))
        out.append((b"\n" if binary else b"") + b"$EndElements\n")
    else:
        if binary:
            out += [np.array([1, nn, 1, nn], "<u8").tobytes(),
                    np.array([dim, 1, 0], "<i4").tobytes(),
                    np.array([nn], "<u8").tobytes(),
                    tags.astype("<u8").tobytes(), v3.astype("<f8").tobytes()]
        else:
            out.append(f"1 {nn} 1 {nn}\n{dim} 1 0 {nn}\n".encode())
            out.append(text(tags[:, None], "%d"))
            out.append(text(v3.astype(object), "%.17g %.17g %.17g"))
        out.append(b"$EndNodes\n$Elements\n")
        if binary:
            out.append(np.array([len(blocks), ntot, 1, ntot],
                                "<u8").tobytes())
        else:
            out.append(f"{len(blocks)} {ntot} 1 {ntot}\n".encode())
        first = 1
        for t, c in blocks:
            rec = np.column_stack([np.arange(first, first + len(c)), c + 1])
            first += len(c)
            if binary:
                out += [np.array([dim, 1, GMSH_TYPES[t]], "<i4").tobytes(),
                        np.array([len(c)], "<u8").tobytes(),
                        rec.astype("<u8").tobytes()]
            else:
                out.append(f"{dim} 1 {GMSH_TYPES[t]} {len(c)}\n".encode())
                out.append(text(rec, " ".join(["%d"] * rec.shape[1])))
        out.append(b"$EndElements\n")
    with open(path, "wb") as f:
        f.write(b"".join(out))


def write_exodus(path, verts, blocks):
    """Write vertices and cell blocks as an ExodusII file in classic
    NetCDF-3 (scipy.io.netcdf_file): coordx/coordy[/coordz] and one
    1-based connect<i> per block with its elem_type."""
    from scipy.io import netcdf_file

    with netcdf_file(path, "w", version=2) as f:
        nd = verts.shape[1]
        f.createDimension("num_nodes", len(verts))
        f.createDimension("num_dim", nd)
        f.createDimension("num_elem", sum(len(c) for _, c in blocks))
        f.createDimension("num_el_blk", len(blocks))
        for name, col in zip(("coordx", "coordy", "coordz"), verts.T):
            v = f.createVariable(name, "d", ("num_nodes",))
            v[:] = col
        for b, (t, c) in enumerate(blocks, start=1):
            f.createDimension(f"num_el_in_blk{b}", len(c))
            f.createDimension(f"num_nod_per_el{b}", c.shape[1])
            v = f.createVariable(f"connect{b}", "i",
                                 (f"num_el_in_blk{b}", f"num_nod_per_el{b}"))
            v[:] = c + 1
            v.elem_type = EXODUS_TYPES[t]


def mesh_file_config(filename, ncol, nz, dz, producer, injector, top,
                     steps=3, size=1.0e4, solver=None, monitor=False):
    """Phase 8 (a)'s default-EOS model (eos_model_config("we")) on a mesh
    read from `filename` whose cells come layer by layer, ncol per layer
    of thickness dz, from the bottom: its per-layer initial state, the
    `top` cells held by a boundary with normal [0, 0, 1], the producer
    and injector cells given, and time.step.solver replaced by `solver`
    (nonlinear.monitor set by `monitor`)."""
    cfg = eos_model_config("we", ncol, 1, nz, steps=steps, size=size,
                           solver=solver)
    primary, region = eos_initial_state("we", ncol, 1, nz, dz=dz)
    cfg["title"] = f"default-EOS model on {os.path.basename(filename)}"
    cfg["mesh"] = {"filename": filename}
    cfg["initial"] = {"primary": primary.tolist(), "region": region.tolist()}
    cfg["boundaries"] = [{"primary": primary[-1].tolist(),
                          "region": int(region[-1]),
                          "faces": {"cells": [int(c) for c in top],
                                    "normal": [0.0, 0.0, 1.0]}}]
    cfg["source"][0]["cell"] = int(producer)
    cfg["source"][1]["cell"] = int(injector)
    if monitor:
        step = cfg["time"]["step"]
        step.setdefault("solver", {}).setdefault("nonlinear", {})[
            "monitor"] = True
    return cfg


def wedge_model_config(filename, nx, ny, nz, pos, **kw):
    """mesh_file_config on wedge_mesh(nx, ny, nz): the producer under the
    top layer and the injector in the bottom layer, at phase 8 (a)'s plan
    positions."""
    ncol = 2 * nx * ny

    def cell(i, j, layer):
        return layer * ncol + pos[2 * (i + nx * j)]

    return mesh_file_config(
        filename, ncol, nz, WEDGE_DZ, cell(nx // 2, ny // 2, nz - 2),
        cell(nx // 4, ny // 2, 0), range((nz - 1) * ncol, nz * ncol), **kw)


class MemoryOutput:
    """Output of a run kept in memory, for the runs that hook their
    Simulation before it runs (model_run's sim_hook): the write
    signature of sim/output.py HDF5Output; each record keeps the time,
    the interior pressures, the water flux, the source and network
    fields and the interior tracers on the host."""

    filename = None
    face_group = True  # flux output is on

    def __init__(self, sim):
        self.n = sim.mesh.num_interior_cells
        self.times, self.pressure, self.flux_water = [], [], []
        self.source_data, self.tracer = [], []

    def write(self, index, time, fluid, source_data=None, tracer=None,
              fluxes=None):
        self.times.append(float(time))
        self.pressure.append(fluid.pressure[: self.n].cpu().numpy())
        self.flux_water.append(np.asarray(fluxes)[:, 0].copy())
        self.source_data.append(dict(source_data or {}))
        self.tracer.append(None if tracer is None
                           else tracer[: self.n].cpu().numpy())

    def close(self):
        pass


def model_run(workdir, size, method="beuler", steps=6, device=None,
              log=log, checkpoint=CHECKPOINT, config=None, name=None,
              sim_hook=None):
    """Write the model JSON into workdir and run it through the port's
    entry points (device None: the CUDA device). The model is the
    flagship's model_config, or `config` (with checkpoint None where it
    has none). It runs through cli.run_json, which writes <name>.h5 and
    <name>.yaml in workdir; the HDF5 file is read back with the port's
    reader (utils/hdf5.py). A run that needs sim_hook(sim) called on its
    Simulation before it runs (phase 9's rock record, phase 10's timed
    set-up and fd check) runs through Simulation(config) + Timestepper
    with the in-memory MemoryOutput instead: the CLI takes no hook, and
    gets none for this. Returns (Timestepper, output times, wall
    seconds, which entry point ran); on the in-memory path the
    Timestepper's `output` is the MemoryOutput. Raises if the run
    aborted, took another number of steps, wrote times that do not
    increase or miss the checkpoint, a flux_water of another shape than
    [records, faces], ended in a non-finite state, or left a log that
    does not end with the timestepper's end."""
    from waiwera_tpu_torch import cli
    from waiwera_tpu_torch.utils import hdf5

    if config is None:
        config = model_config(*size, method=method, steps=steps,
                              checkpoint=checkpoint)
    name = name or f"model_{method}_{'x'.join(map(str, size))}"
    fn = os.path.join(workdir, name + ".json")
    with open(fn, "w") as f:
        json.dump(config, f)
    log_fn = os.path.join(workdir, name + ".yaml")
    h5 = os.path.join(workdir, name + ".h5")
    t0 = time.perf_counter()
    if sim_hook is None:
        entry = "cli.run_json"
        ts = cli.run_json(fn, device=device,
                          overrides=["output.filename=" + json.dumps(h5)])
        with hdf5.File(h5) as f:
            times = f["time"][:, 0].tolist()
            nflux = (f["face_fields/flux_water"].shape
                     if "face_fields/flux_water" in f else None)
        if nflux not in (None, (len(times), ts.sim.mesh.num_faces)):
            raise RuntimeError(f"{name}: flux_water has shape {nflux}")
    else:
        from waiwera_tpu_torch.sim.simulation import Simulation
        from waiwera_tpu_torch.sim.timestepper import Timestepper
        from waiwera_tpu_torch.utils.config import TrackedConfig
        from waiwera_tpu_torch.utils.logging import Logger

        entry = "Simulation + Timestepper (in-memory output, sim_hook)"
        with open(fn) as f:
            config = TrackedConfig(json.load(f))
        sim = Simulation(config, device=device)
        sim_hook(sim)
        out = MemoryOutput(sim)
        logger = Logger(filename=log_fn)
        try:
            ts = Timestepper(config, sim, output=out, logger=logger)
            config.defaults.log_to(logger)
            ts.run()
        finally:
            logger.close()
        times = out.times
        if any(len(fx) != sim.mesh.num_faces for fx in out.flux_water):
            raise RuntimeError("flux_water of another length than the faces")
    wall = time.perf_counter() - t0
    if ts.aborted or ts.taken != steps:
        raise RuntimeError(f"{name}: aborted {ts.aborted}, {ts.taken} steps "
                           f"of {steps}")
    if not all(b > a for a, b in zip(times, times[1:])):
        raise RuntimeError(f"{name}: output times {times} do not increase")
    if checkpoint is not None and checkpoint not in times:
        raise RuntimeError(f"{name}: checkpoint {checkpoint} not in {times}")
    n = ts.sim.mesh.num_cells
    npv = ts.sim.eos.num_primary_variables
    if tuple(ts.final_y.shape) != (n, npv) or not bool(
            torch.isfinite(ts.final_y).all()):
        raise RuntimeError(f"{name}: final state {tuple(ts.final_y.shape)} "
                           "or not finite")
    with open(log_fn) as f:
        last = f.read().splitlines()[-1]
    if not last.startswith("- [info, timestepper, end, "):
        raise RuntimeError(f"{name}: the log ends with {last!r}")
    st = ts.stats
    # the step program follows from the configuration alone
    from waiwera_tpu_torch.sim.simulation import step_program_mode

    want = step_program_mode(ts.sim.system, ts.newton_params)
    if st["step_program"] != want:
        raise RuntimeError(f"{name}: step program {st['step_program']}, "
                           f"configured {want}")
    syncs = st["host_syncs_step"] + st["host_syncs_timestepper"]
    refused = sum(not ok for _, ok in ts.tried)
    with open(log_fn) as f:
        reductions = sum("[warn, timestep, reduction" in ln for ln in f)
    written = ""
    if sim_hook is None:
        mb = os.path.getsize(h5) / 1e6
        written = (f", {mb:.3f} MB written at "
                   f"{mb / max(st['output_seconds'], 1e-9):.1f} MB/s")
    log(f"{name} through {entry}: wall {wall:.2f} s, run loop "
        f"{sum(st['step_seconds']):.2f} s, per accepted step "
        f"{[round(x, 3) for x in st['step_seconds']]} s, accepted sizes "
        f"{[s for s, _, _ in ts.accepted]}, tries {st['tries']} (refused "
        f"{refused}, logged reductions {reductions}), Newton "
        f"{st['newton_iterations']}, BiCGStab {st['linear_iterations']}, "
        f"matvecs {st['matvecs']}, host syncs per try "
        f"{syncs / st['tries']:.1f}"
        f" (of which the timestepper adds "
        f"{st['host_syncs_timestepper'] / st['tries']:.2f}), step program "
        f"{st['step_program']} ({st['graph_captures']} captures in "
        f"{st['graph_capture_seconds']:.2f} s, {st['graph_replays']} "
        f"replays, {st['masked_krylov_iterations']} masked BiCGStab "
        f"iterations), output "
        f"{st['output_seconds']:.3f} s over {len(times)} records at {times}"
        f"{written}")
    return ts, times, wall, entry


def check_output_file(path, ts, times):
    """Phase 7's checks on a run's HDF5 file, read with the port's
    reader: the times written (the last the final time), cell_index the
    natural order, every cell field [records, interior cells] and finite,
    face_fields/flux_water [records, faces], and the last record's
    pressure equal, bit for bit, to the host copy of the final state's.
    Returns (records, MB of the file, MB of its records: the growing
    datasets, which the Timestepper's output_seconds cover; the
    constants are written at set-up)."""
    from waiwera_tpu_torch.utils import hdf5

    sim = ts.sim
    n = sim.mesh.num_interior_cells
    with hdf5.File(path) as f:
        t = f["time"][...]
        nrec = len(times)
        if t.shape != (nrec, 1) or t[:, 0].tolist() != list(times) or \
                t[-1, 0] != ts.final_time:
            raise RuntimeError(f"{path}: times {t[:, 0]} against {times}, "
                               f"final {ts.final_time}")
        if not np.array_equal(f["cell_index"][...],
                              np.arange(n, dtype=np.int64)[:, None]):
            raise RuntimeError(f"{path}: cell_index is not the natural order")
        cf = f["cell_fields"]
        for name in cf.keys():
            ds = cf[name]
            if ds.shape != (nrec, n) or ds.dtype != np.float64 or \
                    not np.isfinite(ds[...]).all():
                raise RuntimeError(f"{path}: cell_fields/{name} "
                                   f"{ds.shape} {ds.dtype} or not finite")
        flux = f["face_fields/flux_water"]
        if flux.shape != (nrec, sim.mesh.num_faces):
            raise RuntimeError(f"{path}: flux_water {flux.shape}")
        last = cf["fluid_pressure"][-1]
        grown = ["time"] + [f"{g}/{k}" for g in ("cell_fields",
                                                 "face_fields",
                                                 "source_fields")
                            if g in f for k in f[g].keys()]
        record_bytes = sum(f[k].size * f[k].dtype.itemsize for k in grown
                           if f[k].shape[:1] == (nrec,))
    final = sim.eos.unscale(ts.final_y, ts.final_region)[:n, 0].cpu().numpy()
    if not np.array_equal(last, final):
        raise RuntimeError(f"{path}: the last record's pressure differs from "
                           "the final state's by up to "
                           f"{np.abs(last - final).max()}")
    return nrec, os.path.getsize(path) / 1e6, record_bytes / 1e6


def restart_run(workdir, ts, path, size=FLAGSHIP, steps=2, device=None,
                log=log):
    """The model_config model of `size` restarted through cli.run_json
    from the HDF5 file `path` of run `ts` (initial.filename; time.start
    its final time, the first try its last accepted step's size) for
    `steps` steps. Raises unless the primaries the
    restart read equal the first run's final primaries bit for bit (f64,
    host copy), its initial state (scaled where it runs) equals the first
    run's final state carried through the same scaling, and its own file
    checks out (check_output_file). Returns (Timestepper, seconds of the
    restart's read, check_output_file's (records, MB, record MB))."""
    from waiwera_tpu_torch.sim.simulation import Simulation

    n = ts.sim.mesh.num_interior_cells
    cfg = model_config(*size, steps=steps)
    cfg["title"] = "restart"
    cfg["initial"] = {"filename": path}
    cfg["time"]["start"] = ts.final_time
    cfg["time"]["step"]["size"] = ts.accepted[-1][0]  # the last step's
    del cfg["output"]["checkpoint"]
    plain = Simulation._initial_from_file
    read = {}

    def timed_read(sim, ic):
        _sync(sim.device)
        t0 = time.perf_counter()
        read["primary"], read["region"] = out = plain(sim, ic)
        read["s"] = time.perf_counter() - t0
        return out

    Simulation._initial_from_file = timed_read
    try:
        ts2, times, _, _ = model_run(workdir, size, steps=steps,
                                     device=device, log=log, checkpoint=None,
                                     config=cfg, name="model_restart")
    finally:
        Simulation._initial_from_file = plain
    eos = ts.sim.eos
    final = eos.unscale(ts.final_y, ts.final_region)
    if not (np.array_equal(read["primary"], final[:n].cpu().numpy())
            and np.array_equal(read["region"],
                               ts.final_region[:n].cpu().numpy())):
        raise RuntimeError("restart: the primaries read differ from the "
                           "first run's final primaries")
    carried = eos.scale(final, ts.final_region)
    if not (torch.equal(ts2.sim.y0[:n], carried[:n])
            and torch.equal(ts2.sim.region0[:n], ts.final_region[:n])):
        raise RuntimeError("restart: the initial state differs from the "
                           "first run's final state")
    written = check_output_file(os.path.join(workdir, "model_restart.h5"),
                                ts2, times)
    return ts2, read["s"], written


def flagship_io_run(workdir, counters, log=log):
    """Phase 7's flagship run through cli.run_json with its HDF5 file
    checked (check_output_file), then its restart (restart_run), each
    with the kernel counts set to 0 just before and read just after;
    dia_spmv launches must equal each run's Krylov matvecs > 0. Returns
    (launches of both runs, the first run's wall, its entry point, the
    output seconds, MB and MB/s of both runs and the restart's read
    seconds)."""
    for c in counters.values():
        c.count = 0
    ts, times, run_wall, entry = model_run(workdir, FLAGSHIP, log=log)
    run_counts = {k: c.count for k, c in counters.items()}
    if ts.sim.device.type != "cuda":
        raise RuntimeError(f"the model run took {ts.sim.device}")
    if ts.stats["step_program"] != "graph":
        raise RuntimeError(f"the model run's step program is "
                           f"{ts.stats['step_program']}")
    if tuple(ts.final_y.shape) != (FLAGSHIP_ROWS, 3):
        raise RuntimeError(f"final state {tuple(ts.final_y.shape)}")
    if run_counts["dia_spmv"] <= 0 or \
            run_counts["dia_spmv"] != ts.stats["matvecs"]:
        raise RuntimeError(
            f"model run: kernel launches {run_counts['dia_spmv']} != "
            f"Krylov matvecs {ts.stats['matvecs']}")
    # the wge flagship's Jacobians all come from the cell-chain kernel
    if run_counts.get("wge_cell_jvp", 0) != ts.stats["newton_iterations"]:
        raise RuntimeError(
            f"model run: wge_cell_jvp launches "
            f"{run_counts.get('wge_cell_jvp')} != Jacobians "
            f"{ts.stats['newton_iterations']}")
    h5 = os.path.join(workdir, "model_beuler_128x64x64.h5")
    nrec, mb, rec_mb = check_output_file(h5, ts, times)
    out_s = ts.stats["output_seconds"]
    io = {"output_s": out_s, "file_mb": mb, "record_mb": rec_mb,
          "record_mb_per_s": rec_mb / out_s}
    log(f"model run: {ts.final_y.numel()} unknowns, launches {run_counts}, "
        f"final time {ts.final_time:.6g} s; HDF5 output {out_s:.3f} s for "
        f"{nrec} records of {rec_mb:.3f} MB ({rec_mb / out_s:.1f} MB/s), "
        f"file {mb:.3f} MB; read back, the last pressure equal to the final "
        "state's bit for bit")
    # the restart from that file, 2 steps, through cli.run_json
    for c in counters.values():
        c.count = 0
    ts2, read_s, (nrec2, mb2, rec_mb2) = restart_run(workdir, ts, h5, log=log)
    restart_counts = {k: c.count for k, c in counters.items()}
    if ts2.stats["step_program"] != "graph":
        raise RuntimeError(f"the restart's step program is "
                           f"{ts2.stats['step_program']}")
    if restart_counts["dia_spmv"] <= 0 or \
            restart_counts["dia_spmv"] != ts2.stats["matvecs"]:
        raise RuntimeError(
            f"restart: kernel launches {restart_counts['dia_spmv']} != "
            f"Krylov matvecs {ts2.stats['matvecs']}")
    for k, n in restart_counts.items():
        run_counts[k] += n
    out2_s = ts2.stats["output_seconds"]
    io.update({"restart_read_s": read_s, "restart_output_s": out2_s,
               "restart_file_mb": mb2, "restart_record_mb": rec_mb2,
               "restart_record_mb_per_s": rec_mb2 / out2_s})
    log(f"restart: read {read_s:.3f} s, initial primaries equal to the "
        f"first run's final ones bit for bit, {ts2.taken} steps, launches "
        f"{restart_counts} = matvecs {ts2.stats['matvecs']}; HDF5 output "
        f"{out2_s:.3f} s for {nrec2} records of {rec_mb2:.3f} MB "
        f"({rec_mb2 / out2_s:.1f} MB/s), file {mb2:.3f} MB")
    return run_counts, run_wall, entry, io


def check_bench(res, counts):
    """The main path's checks on the bench record and kernel counts."""
    op = res["operating_point"]
    if op["settle_accepted"] < 2:
        raise RuntimeError(f"flagship settle: {op['settle_accepted']} "
                           "accepted")
    if not op["y_finite"] or op["y_shape"] != [FLAGSHIP_ROWS, 3]:
        raise RuntimeError(f"flagship solution: finite {op['y_finite']}, "
                           f"shape {op['y_shape']}")
    # bjacobi sections: every Krylov matvec launched the kernel, the
    # step ran as replayed CUDA graphs
    for key in ("operating_point", "reduced_operating_point",
                "minc_operating_point"):
        o = res[key]
        if o["step_program"] != "graph":
            raise RuntimeError(f"{key}: step program {o['step_program']}")
        if o["spmv_launches"] <= 0 or o["spmv_launches"] != o["krylov_matvecs"]:
            raise RuntimeError(f"{key}: kernel launches {o['spmv_launches']} "
                               f"!= Krylov matvecs {o['krylov_matvecs']}")
    o = res["dtype_table"]["f64_operating_point"]
    if o["step_program"] != "graph":
        raise RuntimeError(f"f64 step: step program {o['step_program']}")
    if o["spmv_launches"] <= 0 or o["spmv_launches"] != o["krylov_matvecs"]:
        raise RuntimeError(f"f64 step: kernel launches {o['spmv_launches']}"
                           f" != Krylov matvecs {o['krylov_matvecs']}")
    # the preconditioner sweep's line and cpr steps ran as replayed CUDA
    # graphs (ROADMAP A18.3)
    for pc in ("line", "cpr"):
        o = res["pc_sweep"][pc].get("operating_point")
        if o is None or o["step_program"] != "graph":
            raise RuntimeError(f"pc sweep {pc}: {res['pc_sweep'][pc]}")
    if res["minc_spmv_path"] != "hybrid-dia":
        raise RuntimeError(f"MINC step took {res['minc_spmv_path']}")
    frac = res["spmv_roofline_fraction"]
    if not 0.0 < frac <= 1.05:
        raise RuntimeError(f"spmv_roofline_fraction {frac}")
    if not 0.0 < res["measured_bandwidth_gb_s"] < 1.05 * 3350.0:
        raise RuntimeError(f"measured bandwidth "
                           f"{res['measured_bandwidth_gb_s']} GB/s")
    for name, n in counts.items():
        if n <= 0 and name != "stream_scalar":
            raise RuntimeError(f"kernel {name} was not launched on the "
                               "main path")
    # the bandwidth's buffers are fresh allocations: every call takes the
    # vector kernel, and the scalar one never runs
    if counts["stream_scalar"] != 0:
        raise RuntimeError(f"the main path launched the scalar stream "
                           f"kernel {counts['stream_scalar']} times")


# phase 8: (label, EOS model, size, steps, time.step.solver or None for
# the schema's default f64 solver)
BENCH_SOLVER = {"nonlinear": {"minimum": {"iterations": 1}},
                "linear": {"dtype": "float32", "jacobian_dtype": "float32",
                           "preconditioner": {"type": "bjacobi"}}}


def eos_runs():
    from waiwera_tpu_torch.bench import REDUCED

    return (("a", "we", FLAGSHIP, 4, None),
            ("b", "wse", REDUCED, 3, BENCH_SOLVER),
            ("c", "wsce", REDUCED, 3, None),
            ("c", "w", REDUCED, 3, None))


def jacobian_seconds(ts, reps=2):
    """Best of `reps` synchronised calls of System.jacobian_parts at the
    run's final state, in the run's Jacobian dtype (after the run's
    calls, so warm)."""
    from waiwera_tpu_torch.solver.system import MethodCoeffs

    sim = ts.sim
    dtype = (torch.float32 if ts.newton_params.jacobian_dtype == "float32"
             else torch.float64)
    lhs, _, _ = sim.lhs_at(ts.final_y, ts.final_region)
    coeffs = MethodCoeffs(c_lhs=1.0, dt_eff=1.0e4, const=-lhs)
    best = float("inf")
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sim.system.jacobian_parts(ts.final_y, ts.final_region, sim.rock,
                                  coeffs, 0.0, 1.0e4, tangent_dtype=dtype)
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t0)
    return best


def eos_model_run(workdir, label, kind, size, steps, solver, counters,
                  log=log):
    """Run (label) of phase 8: the EOS model `kind` as a JSON file
    through the port's entry points on the card, with every kernel count
    set to 0 just before and read just after. Raises unless the run took
    the card, and launches of the kernel of the run's linear dtype equal
    its Krylov matvecs > 0. Returns (Timestepper, launches, record)."""
    for c in counters.values():
        c.count = 0
    cfg = eos_model_config(kind, *size, steps=steps, solver=solver)
    name = f"eos_{kind}_{'x'.join(map(str, size))}"
    ts, _, wall, entry = model_run(workdir, size, steps=steps, log=log,
                                   checkpoint=None, config=cfg, name=name)
    counts = {k: c.count for k, c in counters.items()}
    if ts.sim.device.type != "cuda":
        raise RuntimeError(f"{name} took {ts.sim.device}")
    kernel = ("dia_spmv" if ts.newton_params.linear_dtype == "float32"
              else "dia_spmv_f64")
    matvecs = ts.stats["matvecs"]
    if counts[kernel] <= 0 or counts[kernel] != matvecs:
        raise RuntimeError(f"{name}: {kernel} launches {counts[kernel]} != "
                           f"Krylov matvecs {matvecs}")
    jac_s = jacobian_seconds(ts)
    changed = int((ts.sim.region0 != ts.final_region).sum())
    st = ts.stats
    rec = {"run": label, "eos": ts.sim.eos.name,
           "thermodynamics": ts.sim.thermo.name, "size": list(size),
           "unknowns": ts.final_y.numel(), "entry": entry, "wall_s": wall,
           "run_loop_s": sum(st["step_seconds"]), "tries": st["tries"],
           "steps": ts.taken, "newton": st["newton_iterations"],
           "bicgstab": st["linear_iterations"], "matvecs": matvecs,
           "kernel": kernel, "launches": counts,
           "jacobian_dtype": ts.newton_params.jacobian_dtype,
           "jacobian_parts_s": jac_s, "regions_changed": changed,
           "final_regions": sorted(set(ts.final_region.cpu().tolist()))}
    log(f"phase 8 run ({label}) {json.dumps(rec)}")
    return ts, counts, rec


def eos_phase(workdir, counters, log=log):
    """Phase 8: runs (a)-(c) of eos_runs() on the card, then the 5 x 4 x 3
    default-EOS model on the card and on the CPU (d). Returns (records,
    launches summed over the phase's card runs, run (c) "w"'s tries and
    final state on the host, which phase 10 (c) is held to)."""
    records = []
    total = {k: 0 for k in counters}
    w_run = None
    for label, kind, size, steps, solver in eos_runs():
        ts, counts, rec = eos_model_run(workdir, label, kind, size, steps,
                                        solver, counters, log)
        if label == "a":
            if tuple(ts.final_y.shape) != (FLAGSHIP_ROWS, 2):
                raise RuntimeError(f"run (a): final state "
                                   f"{tuple(ts.final_y.shape)}")
            if rec["regions_changed"] <= 0:
                raise RuntimeError("run (a): no cell changed region")
        records.append(rec)
        for k, n in counts.items():
            total[k] += n
        if kind == "w":
            w_run = (list(ts.tried), ts.final_y.cpu())
        del ts
        torch.cuda.empty_cache()
    # (d) the small default-EOS model on the card and on the CPU
    cfg = eos_model_config("we", 5, 4, 3, steps=3)
    pair = []
    for dev in (None, "cpu"):
        for c in counters.values():
            c.count = 0
        ts, _, _, _ = model_run(workdir, (5, 4, 3), steps=3, device=dev,
                                log=lambda m: None,
                                checkpoint=None, config=cfg,
                                name=f"eos_we_small_{dev or 'card'}")
        if dev is None:
            n = counters["dia_spmv_f64"].count
            if n <= 0 or n != ts.stats["matvecs"]:
                raise RuntimeError(f"run (d): dia_spmv_f64 launches {n} != "
                                   f"Krylov matvecs {ts.stats['matvecs']}")
            for k, c in counters.items():
                total[k] += c.count
        pair.append(ts)
    card, cpu = pair
    if [c for _, c in card.tried] != [c for _, c in cpu.tried]:
        raise RuntimeError("run (d): tries differ between the card and the "
                           f"CPU: {card.tried} {cpu.tried}")
    np.testing.assert_allclose([d for d, _ in card.tried],
                               [d for d, _ in cpu.tried], rtol=1e-12)
    if not torch.equal(card.final_region.cpu(), cpu.final_region):
        raise RuntimeError("run (d): final regions differ")
    torch.testing.assert_close(card.final_y.cpu(), cpu.final_y, rtol=2e-5,
                               atol=2e-5)
    log(f"phase 8 run (d): {len(card.tried)} tries and {card.taken} steps "
        "agree between the card and the CPU")
    return records, total, w_run


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def flows_seconds(ts, reps=3):
    """Best of `reps` synchronised calls of the network's
    flows(collect=) at the run's final state over its last step."""
    net = ts.sim.sources
    t1 = ts.final_time
    t0 = t1 - ts.accepted[-1][0]
    best = float("inf")
    for _ in range(reps):
        _sync(ts.sim.device)
        w0 = time.perf_counter()
        net.flows(ts.final_fluid, t0, t1, collect={})
        _sync(ts.sim.device)
        best = min(best, time.perf_counter() - w0)
    return best


def check_network_run(ts, rock_seen):
    """Phase 9's checks on a production-field run: every output record's
    group limits and reinjector balances, the tracers, the tracer solves
    and the rock controls. Raises on the first that fails."""
    net = ts.sim.sources
    out = ts.output
    gnames = [g.name for g in net.groups]
    limits = {g.name: g.limiter for g in net.groups if g.limiter is not None}
    for rec, x in zip(out.source_data, out.tracer):
        steam = rec["network_group_steam_rate"]
        total = rec["network_group_rate"]
        for name, lim in limits.items():
            k = gnames.index(name)
            for value, entry in ((steam[k], lim.steam), (total[k], lim.total)):
                if entry is not None and abs(value) > entry[0] * (1 + 1e-9):
                    raise RuntimeError(f"group {name}: flow {value} over "
                                       f"its limit {entry[0]}")
        if not np.all(rec["network_reinject_output_water_rate"]
                      <= rec["network_reinject_water_rate"] * (1 + 1e-9)):
            raise RuntimeError(f"a reinjector injects more than it "
                               f"receives: {rec}")
        if x is None or not np.isfinite(x).all() or x.min() < -1e-12:
            raise RuntimeError("tracer field not finite or negative: min "
                               f"{None if x is None else x.min()}")
    conv = ts.stats["tracer_converged"]
    if sum(conv) < ts.taken:
        raise RuntimeError(f"tracer solves converged {conv} for "
                           f"{ts.taken} steps")
    if len(rock_seen) < 2 or bool(torch.equal(rock_seen[0], rock_seen[1])):
        raise RuntimeError("rock_for gave the same permeability at the "
                           "first two tries")


def network_phase(workdir, counters, log=log):
    """Phase 9: the production-field model (network_model_config) at the
    flagship size on the card, then at 5 x 4 x 3 on the card and on the
    CPU. Returns (record, launches of the card run at full size)."""
    from waiwera_tpu_torch.sim.simulation import Simulation

    cfg = network_model_config(*FLAGSHIP, steps=3)
    rock_seen = []

    def hook(sim):
        # each try's rock: the producers' permeability, kept on the card
        prod = sim.rock_controls[0][1][0]
        plain = Simulation.rock_for

        def rock_for(t):
            rock = plain(sim, t)
            rock_seen.append(rock.permeability[prod].clone())
            return rock

        sim.rock_for = rock_for

    for c in counters.values():
        c.count = 0
    ts, _, wall, entry = model_run(workdir, FLAGSHIP, steps=3, log=log,
                                   checkpoint=None, config=cfg,
                                   name="network_field", sim_hook=hook)
    counts = {k: c.count for k, c in counters.items()}
    if ts.sim.device.type != "cuda":
        raise RuntimeError(f"phase 9 took {ts.sim.device}")
    if tuple(ts.final_y.shape) != (FLAGSHIP_ROWS, 2):
        raise RuntimeError(f"phase 9: final state {tuple(ts.final_y.shape)}")
    matvecs = ts.stats["matvecs"]
    if counts["dia_spmv_f64"] <= 0 or counts["dia_spmv_f64"] != matvecs:
        raise RuntimeError(f"phase 9: dia_spmv_f64 launches "
                           f"{counts['dia_spmv_f64']} != Krylov matvecs "
                           f"{matvecs}")
    check_network_run(ts, rock_seen)
    st = ts.stats
    if st["tracer_program"] != "graph":
        raise RuntimeError(f"phase 9: tracer program {st['tracer_program']}")
    nsolve = len(st["tracer_iterations"])
    rec = {
        "size": list(FLAGSHIP), "unknowns": ts.final_y.numel(),
        "sources": ts.sim.sources.num_sources,
        "groups": len(ts.sim.sources.groups),
        "reinjectors": len(ts.sim.sources.reinjectors),
        "tracers": ts.sim.tracers.num_tracers, "entry": entry,
        "wall_s": wall, "run_loop_s": sum(st["step_seconds"]),
        "step_s": st["step_seconds"], "tries": st["tries"],
        "steps": ts.taken, "newton": st["newton_iterations"],
        "bicgstab": st["linear_iterations"], "matvecs": matvecs,
        "launches": counts,
        "gmres_iterations_per_tracer_solve": st["tracer_iterations"],
        "tracer_solve_s_per_step": st["tracer_seconds"] / max(nsolve, 1),
        "tracer_host_syncs_per_solve": st["host_syncs_tracer"]
        / max(nsolve, 1),
        "step_program": st["step_program"],
        "tracer_program": st["tracer_program"],
        "tracer_graph_captures": st["tracer_graph_captures"],
        "tracer_graph_capture_seconds": st["tracer_graph_capture_seconds"],
        "flows_collect_s": flows_seconds(ts),
        "jacobian_parts_s": jacobian_seconds(ts),
        "jacobian_parts_s_phase8a_without_network": "0.17-0.19",
        "host_syncs_per_try": (st["host_syncs_step"]
                               + st["host_syncs_timestepper"]) / st["tries"],
        "host_syncs_per_try_phase8a": 156.5,
        "accepted_sizes": [a for a, _, _ in ts.accepted],
        "output_records": len(ts.output.times),
    }
    log(f"phase 9 run {json.dumps(rec)}")
    del ts
    torch.cuda.empty_cache()

    # the same network on a 5 x 4 x 3 box, on the card and on the CPU
    small = network_model_config(5, 4, 3, steps=3)
    pair = []
    for dev in (None, "cpu"):
        ts, _, _, _ = model_run(workdir, (5, 4, 3), steps=3, device=dev,
                                log=lambda m: None,
                                checkpoint=None, config=small,
                                name=f"network_small_{dev or 'card'}")
        pair.append(ts)
    card, cpu = pair
    if [c for _, c in card.tried] != [c for _, c in cpu.tried]:
        raise RuntimeError("phase 9 small: tries differ between the card and "
                           f"the CPU: {card.tried} {cpu.tried}")
    np.testing.assert_allclose([d for d, _ in card.tried],
                               [d for d, _ in cpu.tried], rtol=1e-12)
    torch.testing.assert_close(card.final_y.cpu(), cpu.final_y, rtol=2e-5,
                               atol=2e-5)
    xmax = float(cpu.final_tracer.abs().max())
    torch.testing.assert_close(card.final_tracer.cpu(), cpu.final_tracer,
                               rtol=1e-6, atol=1e-6 * xmax)
    log(f"phase 9 small: {len(card.tried)} tries and {card.taken} steps "
        "agree between the card and the CPU, tracers within 1e-6 of "
        f"max|x| = {xmax:.6g}")
    return rec, counts


# phase 10: the solvers of each run
LGMRES_ASM = {"linear": {"type": "lgmres", "preconditioner": {"type": "asm"}}}
BCGSL_ASM = {"linear": {"type": "bcgsl", "preconditioner": {"type": "asm"}}}
LGMRES_LU = {"linear": {"type": "lgmres", "preconditioner": {"type": "lu"}}}
# 5 x 4 x 3 cubes of 6 tetrahedra each: 720 unknowns under we. The cubes
# are 20 m (the flagship's layer thickness): in 1 m cubes phase 8 (a)'s
# 20 kg/s injector refuses 6 of the first 9 tries
TET_BOX = (5, 4, 3)
TET_SIDE = 20.0


class LineCount:
    """A text stream that passes everything on to `out` and counts the
    lines that start with `prefix` (the nonlinear monitor's reports)."""

    def __init__(self, out, prefix="newton it "):
        self.out, self.prefix = out, prefix
        self.count = 0
        self._line = ""

    def write(self, text):
        self.out.write(text)
        self._line += text
        *done, self._line = self._line.split("\n")
        self.count += sum(ln.startswith(self.prefix) for ln in done)
        return len(text)

    def flush(self):
        self.out.flush()


@contextlib.contextmanager
def timed_calls(targets, sink):
    """Wrap each (owner, attribute) callable so that each call adds its
    seconds (host clock, the card synchronised) to sink[attribute];
    restored on exit."""
    saved = [(owner, name, getattr(owner, name)) for owner, name in targets]

    def timed(fn, name):
        def call(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                if torch.cuda.is_available():
                    torch.cuda.synchronize()
                sink[name] = sink.get(name, 0.0) + time.perf_counter() - t0
        return call

    for owner, name, fn in saved:
        setattr(owner, name, timed(fn, name))
    try:
        yield sink
    finally:
        for owner, name, fn in saved:
            setattr(owner, name, fn)


def route(system):
    """The linear operator's route of a System: band, hybrid or ell."""
    if system.dia is not None:
        return "band"
    return "hybrid" if system.hybrid is not None else "ell"


def mesh_file_run(workdir, label, cfg, counters, write_s, fd=False,
                  device=None, log=log):
    """One run of phase 10: the JSON model `cfg` (its mesh a file) through
    the port's entry points with the kernel counts set to 0 just before
    and read just after, the set-up split by timed calls, the monitor's
    lines counted and, with fd, jacobian_fd_error at the initial state
    (4 probes) before the run. Returns (Timestepper, record)."""
    from waiwera_tpu_torch.mesh import exodus, gmsh
    from waiwera_tpu_torch.sim import simulation
    from waiwera_tpu_torch.solver.fdcheck import jacobian_fd_error
    from waiwera_tpu_torch.solver.system import MethodCoeffs

    if cfg["mesh"]["filename"].endswith(".exo"):
        reader, read_name = exodus, "read_exodus"
    else:
        reader, read_name = gmsh, "read_gmsh"
    fd_out = {}

    def hook(sim):
        if fd:
            _sync(sim.device)
            t0 = time.perf_counter()
            size = cfg["time"]["step"]["size"]
            lhs, _, _ = sim.lhs_at(sim.y0, sim.region0)
            coeffs = MethodCoeffs(c_lhs=1.0, dt_eff=size, const=-lhs)
            fd_out["error"] = jacobian_fd_error(
                sim.system, sim.y0, sim.region0, sim.rock, coeffs, 0.0, size,
                num_probes=4)
            _sync(sim.device)
            fd_out["s"] = time.perf_counter() - t0

    split = {}
    out = LineCount(sys.stdout)
    steps = cfg["time"]["step"]["maximum"]["number"]
    for c in counters.values():
        c.count = 0
    with timed_calls([(reader, read_name), (reader, "build_mesh"),
                      (simulation, "System"),
                      (simulation.Simulation, "__init__")], split), \
            contextlib.redirect_stdout(out):
        ts, _, wall, entry = model_run(
            workdir, None, steps=steps, device=device,
            log=log, checkpoint=None, config=cfg,
            name=f"mesh_file_{label}_{device or 'card'}", sim_hook=hook)
    counts = {k: c.count for k, c in counters.items()}
    st = ts.stats
    sysm = ts.sim.system
    rec = {
        "run": label, "device": str(ts.sim.device),
        "mesh_file": os.path.basename(cfg["mesh"]["filename"]),
        "route": route(sysm), "cells": ts.sim.mesh.num_interior_cells,
        "unknowns": ts.sim.mesh.num_interior_cells * sysm.npv,
        "linear": ts.newton_params.linear_method,
        "preconditioner": ts.newton_params.linear_pc,
        "setup_s": {
            "file_write": write_s,
            "read": split[read_name] - split["build_mesh"],
            "build_mesh": split["build_mesh"],
            "system": split["System"],
            "initial_state": split["__init__"] - split[read_name]
            - split["System"],
        },
        "wall_s": wall - fd_out.get("s", 0.0),
        "run_loop_s": sum(st["step_seconds"]), "step_s": st["step_seconds"],
        "tries": st["tries"], "refused": sum(not ok for _, ok in ts.tried),
        "steps": ts.taken, "newton": st["newton_iterations"],
        "krylov": st["linear_iterations"], "matvecs": st["matvecs"],
        "host_syncs_per_try": (st["host_syncs_step"]
                               + st["host_syncs_timestepper"]) / st["tries"],
        "fd_error": fd_out.get("error"), "fd_s": fd_out.get("s"),
        "monitor_lines": out.count,
        "dia_spmv_f64_launches": counts["dia_spmv_f64"], "launches": counts,
    }
    if ts.newton_params.monitor and out.count != st["tries"] + \
            st["newton_iterations"]:
        raise RuntimeError(f"phase 10 ({label}): {out.count} monitor lines "
                           f"for {st['tries']} tries and "
                           f"{st['newton_iterations']} Newton iterations")
    kernel = "dia_spmv_f64"
    if device is not None:
        pass  # no kernel off the card
    elif rec["route"] == "band":
        if counts[kernel] <= 0 or counts[kernel] != st["matvecs"]:
            raise RuntimeError(f"phase 10 ({label}): {kernel} launches "
                               f"{counts[kernel]} != Krylov matvecs "
                               f"{st['matvecs']}")
    elif any(counts.values()):
        raise RuntimeError(f"phase 10 ({label}) on the {rec['route']} "
                           f"route launched {counts}")
    log(f"phase 10 run ({label}) {json.dumps(rec)}")
    return ts, rec


def same_meshes(a, b):
    """Raise unless two meshes agree: every floating field at rtol 1e-12
    (atol 1e-12 of its largest entry), face_cells and the other integer
    fields exactly."""
    for name in ("cell_centroid", "cell_volume", "face_area", "face_normal",
                 "face_centroid", "face_distance", "face_distance12",
                 "face_gravity_normal", "exterior_face_centroid",
                 "exterior_face_normal", "exterior_face_area"):
        x, y = getattr(a, name), getattr(b, name)
        np.testing.assert_allclose(x, y, rtol=1e-12,
                                   atol=1e-12 * np.abs(y).max(),
                                   err_msg=name)
    for name in ("face_cells", "face_permeability_direction",
                 "exterior_face_cell", "is_ghost"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name),
                                      err_msg=name)


def build_mesh_paths(path, device, log=log):
    """build_mesh of one gmsh file with numpy on the host and on
    `device` (mesh/geometry.py) in turn, each timed: the face order and
    every integer field must be equal, the geometry within rtol 1e-12,
    but for the permeability direction of a face whose two largest
    normal components tie (argmax then follows round-off, as between
    the two packages). Returns {"numpy": s, "device": s}."""
    from waiwera_tpu_torch.mesh import gmsh

    split, meshes = {}, {}
    for which, dev in (("numpy", None), ("device", device)):
        sink = {}
        with timed_calls([(gmsh, "build_mesh")], sink):
            meshes[which] = gmsh.read_gmsh(path, device=dev)
        split[which] = sink["build_mesh"]
    a, b = meshes["device"], meshes["numpy"]
    for name in ("face_cells", "exterior_face_cell", "is_ghost"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name),
                                      err_msg=name)
    for name in ("cell_centroid", "cell_volume", "face_area", "face_normal",
                 "face_centroid", "face_distance", "face_distance12",
                 "face_gravity_normal", "exterior_face_centroid",
                 "exterior_face_normal", "exterior_face_area"):
        y = getattr(b, name)
        np.testing.assert_allclose(getattr(a, name), y, rtol=1e-12,
                                   atol=1e-12 * np.abs(y).max(),
                                   err_msg=name)
    pa, pb = a.face_permeability_direction, b.face_permeability_direction
    diff = np.flatnonzero(pa != pb)
    n = np.abs(b.face_normal[diff])
    np.testing.assert_allclose(n[np.arange(len(diff)), pa[diff]],
                               n[np.arange(len(diff)), pb[diff]], rtol=1e-12)
    log(f"phase 10 (a): build_mesh {split['numpy']:.3f} s with numpy, "
        f"{split['device']:.3f} s on {device}; face order equal, geometry "
        f"within rtol 1e-12 ({len(diff)} tied permeability directions "
        "differ)")
    return split


def same_run(a, b, what, rtol=2e-5):
    """Raise unless two runs, each (tries, final state), took the same
    tries (sizes to rtol 1e-12) and reached final states within rtol,
    atol `rtol`."""
    if [ok for _, ok in a[0]] != [ok for _, ok in b[0]]:
        raise RuntimeError(f"{what}: tries differ: {a[0]} {b[0]}")
    np.testing.assert_allclose([d for d, _ in a[0]], [d for d, _ in b[0]],
                               rtol=1e-12)
    torch.testing.assert_close(a[1].cpu(), b[1].cpu(), rtol=rtol, atol=rtol)


def tet_box_config(workdir):
    """Phase 10 (d)'s model: TET_BOX cubes of 6 tetrahedra each from a
    gmsh 4.1 binary file it writes in `workdir`, lgmres + lu, the
    monitor on. Returns (config, the file's write seconds)."""
    verts, tets, top = tet_box(*TET_BOX, h=TET_SIDE)
    tet = os.path.join(workdir, "tet_box.msh")
    t0 = time.perf_counter()
    write_gmsh(tet, verts, [("tetra", tets)], version="4.1", binary=True)
    write_s = time.perf_counter() - t0
    nx, ny, nz = TET_BOX
    ncol = 6 * nx * ny

    def cell(i, j, k, q=0):
        return 6 * (i + nx * (j + ny * k)) + q

    cfg = mesh_file_config(tet, ncol, nz, TET_SIDE,
                           cell(nx // 2, ny // 2, nz - 2),
                           cell(nx // 4, ny // 2, 0), top, steps=3,
                           solver=LGMRES_LU, monitor=True)
    return cfg, write_s


def mesh_file_phase(workdir, counters, w_run, log=log):
    """Phase 10: models read from mesh files. (a) the wedge field at
    WEDGE_FIELD from gmsh 4.1 binary, lgmres + asm, monitor on, with the
    Jacobian's finite-difference check first; (b) the same construction
    at WEDGE_REDUCED written as exodus (NetCDF-3) and gmsh 2.2 ASCII,
    which read to equal geometry, run from the exodus file with bcgsl +
    asm; (c) phase 8 (c) "w"'s box from gmsh 4.1 ASCII, held to that run
    (w_run: its tries and final state); (d) the tetrahedral TET_BOX with
    lgmres + lu, monitor on, on the card and on the CPU. Returns
    (records, launches summed over the card runs)."""
    from waiwera_tpu_torch.bench import REDUCED
    from waiwera_tpu_torch.mesh.exodus import read_exodus
    from waiwera_tpu_torch.mesh.gmsh import read_gmsh

    records, total = [], {k: 0 for k in counters}

    def add(rec):
        records.append(rec)
        for k, n in rec["launches"].items():
            total[k] += n

    # (a) the wedge field at full size
    nx, ny, nz = WEDGE_FIELD
    verts, wedges, pos = wedge_mesh(nx, ny, nz)
    path = os.path.join(workdir, "wedge_field.msh")
    t0 = time.perf_counter()
    write_gmsh(path, verts, [("wedge", wedges)], version="4.1", binary=True)
    write_s = time.perf_counter() - t0
    cfg = wedge_model_config(path, nx, ny, nz, pos, steps=3,
                             solver=LGMRES_ASM, monitor=True)
    ts, rec = mesh_file_run(workdir, "a", cfg, counters, write_s, fd=True,
                            log=log)
    rec["file_bytes"] = os.path.getsize(path)
    if rec["route"] != "ell" or ts.sim.system.bands is not None:
        raise RuntimeError(f"phase 10 (a) took the {rec['route']} route")
    rec["build_mesh_s"] = build_mesh_paths(path, ts.sim.device, log=log)
    if not rec["fd_error"] < 1e-5:
        raise RuntimeError(f"phase 10 (a): fd error {rec['fd_error']}")
    if rec["unknowns"] != 2 * 2 * nx * ny * nz:
        raise RuntimeError(f"phase 10 (a): {rec['unknowns']} unknowns")
    add(rec)
    del ts, verts, wedges
    torch.cuda.empty_cache()

    # (b) the reduced wedge field from exodus, and the same cells from
    # gmsh 2.2 ASCII
    nx, ny, nz = WEDGE_REDUCED
    verts, wedges, pos = wedge_mesh(nx, ny, nz)
    exo = os.path.join(workdir, "wedge_reduced.exo")
    msh = os.path.join(workdir, "wedge_reduced.msh")
    t0 = time.perf_counter()
    write_exodus(exo, verts, [("wedge", wedges)])
    write_s = time.perf_counter() - t0
    write_gmsh(msh, verts, [("wedge", wedges)], version="2.2", binary=False)
    same_meshes(read_exodus(exo), read_gmsh(msh))
    log("phase 10 (b): the exodus and gmsh 2.2 ASCII files read to equal "
        "geometry")
    cfg = wedge_model_config(exo, nx, ny, nz, pos, steps=3, solver=BCGSL_ASM)
    ts, rec = mesh_file_run(workdir, "b", cfg, counters, write_s, log=log)
    if rec["route"] != "ell":
        raise RuntimeError(f"phase 10 (b) took the {rec['route']} route")
    if ts.stats["step_program"] != "graph":
        raise RuntimeError(f"phase 10 (b): step program "
                           f"{ts.stats['step_program']}")
    add(rec)
    del ts

    # (c) phase 8 (c) "w"'s box from a gmsh 4.1 ASCII file
    (dx, dy, dz), _ = flagship_spacing(*REDUCED)
    verts, hexes = hex_box(*REDUCED, (dx, dy, dz))
    box = os.path.join(workdir, "box_w.msh")
    t0 = time.perf_counter()
    write_gmsh(box, verts, [("hexahedron", hexes)], version="4.1",
               binary=False)
    write_s = time.perf_counter() - t0
    cfg = eos_model_config("w", *REDUCED, steps=3)
    cfg["mesh"] = {"filename": box}
    ts, rec = mesh_file_run(workdir, "c", cfg, counters, write_s, log=log)
    if rec["route"] != "band":
        raise RuntimeError(f"phase 10 (c) took the {rec['route']} route")
    if ts.stats["step_program"] != "graph":
        raise RuntimeError(f"phase 10 (c): step program "
                           f"{ts.stats['step_program']}")
    same_run((ts.tried, ts.final_y), w_run,
             "phase 10 (c) against phase 8 (c) w")
    add(rec)
    del ts

    # (d) the tetrahedral box with lgmres + lu on the card and the CPU
    cfg, write_s = tet_box_config(workdir)
    pair = []
    for dev in (None, "cpu"):
        ts, rec = mesh_file_run(workdir, "d", cfg, counters, write_s,
                                device=dev, log=log)
        if dev is None:
            add(rec)
            if ts.stats["step_program"] != "graph":
                raise RuntimeError(f"phase 10 (d): step program "
                                   f"{ts.stats['step_program']}")
        else:
            records.append(rec)
        pair.append(ts)
    same_run(*[(p.tried, p.final_y) for p in pair],
             "phase 10 (d) card against CPU")
    log(f"phase 10 (d): {len(pair[0].tried)} tries and {pair[0].taken} "
        "steps agree between the card and the CPU")
    return records, total


def scatter_cost(reps=10, k=20, log=log):
    """ROADMAP C15: the fixed-order scatter-sum of the flagship box's
    faces (no boundary) against the two index_adds it replaced, ms per
    call on the card (host clock over k synchronised calls, best of
    reps): rows [N, 3] f64 (the residual's inflows) and element-major
    [9, N] f32 (the f32 Jacobian's diagonal), with the largest
    difference of the two sums."""
    from waiwera_tpu_torch.mesh.device import mesh_arrays
    from waiwera_tpu_torch.mesh.rect import rectangular_mesh

    widths, origin = flagship_spacing(*FLAGSHIP)
    m = mesh_arrays(rectangular_mesh(*widths, origin=origin), "cuda")
    cl, cr = m.face_cells[:, 0], m.face_cells[:, 1]
    nf, n = len(cl), m.num_cells
    gen = torch.Generator(device="cuda").manual_seed(0)

    def best_ms(fn):
        fn()
        torch.cuda.synchronize()
        best = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            for _ in range(k):
                fn()
            torch.cuda.synchronize()
            best = min(best, (time.perf_counter() - t0) / k * 1e3)
        return best

    rec = {"faces": nf, "cells": n}
    for name, dim, rows, dtype in (("rows_f64", 0, 3, torch.float64),
                                   ("element_major_f32", 1, 9,
                                    torch.float32)):
        shape = (2 * nf, rows) if dim == 0 else (rows, 2 * nf)
        v = torch.randn(shape, generator=gen, device="cuda", dtype=dtype)
        base = torch.zeros((n, rows) if dim == 0 else (rows, n),
                           device="cuda", dtype=dtype)

        def old():
            return base.index_add(dim, cl, v.narrow(dim, 0, nf)).index_add(
                dim, cr, v.narrow(dim, nf, nf))

        def new():
            return m.face_sum.add(base, v, dim)

        rec[name] = {"index_add_ms": best_ms(old),
                     "segment_sum_ms": best_ms(new),
                     "max_abs_diff": float((old() - new()).abs().max())}
    log(f"C15 scatter cost {json.dumps(rec)}")
    return rec


@contextlib.contextmanager
def scatter_mode(mode, calls=None):
    """ROADMAP C15's A/B switch: inside, every SegmentSum.add sums with
    one index_add over the same index (mode "index_add", the scatter the
    fixed-order sums replaced; the faces took two then) or as shipped
    ("segment_sum"); calls, where given, gets one entry per add, the
    ops it dispatches as shipped (a cat, a pad and a gather and an add
    per slot)."""
    from unittest import mock

    from waiwera_tpu_torch.ops.segment import SegmentSum

    shipped = SegmentSum.add
    index_of = {}

    def index(seg):
        # the entry index per row, read back from the slot table once
        key = id(seg)
        if key not in index_of:
            idx = torch.empty(seg.size, dtype=torch.int64,
                              device=seg.slots[0].index.device)
            rows = torch.arange(seg.num_rows, device=idx.device)
            for slot in seg.slots:
                real = slot.index < seg.size
                idx[slot.index[real]] = rows[real]
            index_of[key] = (seg, idx)
        return index_of[key][1]

    def add(seg, out, values, dim=0):
        if calls is not None:
            calls.append(2 + 2 * len(seg.slots))
        if mode == "index_add":
            return out.index_add(dim, index(seg), values)
        return shipped(seg, out, values, dim)

    with mock.patch.object(SegmentSum, "add", add):
        yield


def scatter_step_cost(pairs=12, size=FLAGSHIP, device=None, log=log):
    """ROADMAP C15's cost on the bench's settled flagship step: the
    settle protocol of bench.time_step, then `pairs` pairs of timed
    steps from the settled state, the fixed-order sums ("segment_sum")
    and index_add in turn (ABBA order, host clock to a synchronise, one
    warm call of each first), with the medians and quartiles of each and
    the SegmentSum.add calls and their ops in one step. The step runs
    eagerly on the card."""
    from unittest import mock

    from waiwera_tpu_torch import bench

    dev = torch.device(device or "cuda")
    sim = bench.build_sim(*size, device=dev)
    # eager: the A/B switch patches SegmentSum.add in Python, which a
    # captured graph would not see
    step = bench.make_step(sim, eager=True)
    times = {"segment_sum": [], "index_add": []}
    calls = []

    def ab(run, device, reps):
        for mode in times:
            with scatter_mode(mode):
                run()
        with scatter_mode("segment_sum", calls):
            run()
        for k in range(pairs):
            order = list(times) if k % 2 == 0 else list(times)[::-1]
            for mode in order:
                with scatter_mode(mode):
                    _sync(dev)
                    t0 = time.perf_counter()
                    run()
                    _sync(dev)
                    times[mode].append(time.perf_counter() - t0)
        return min(times["segment_sum"])

    with mock.patch.object(bench, "timeit", ab):
        bench.time_step(sim, step, reps=1)
    rec = {"size": list(size), "pairs": pairs,
           "dt_timed": bench.time_step.last_info["dt_timed"],
           "segment_sum_adds_per_step": len(calls),
           "segment_sum_ops_per_step": sum(calls)}
    for mode, ts in times.items():
        q1, med, q3 = statistics.quantiles(ts, n=4)
        rec[mode] = {"median_s": statistics.median(ts), "q1_s": q1,
                     "q3_s": q3, "s": ts}
    rec["median_change"] = (rec["segment_sum"]["median_s"]
                            / rec["index_add"]["median_s"] - 1.0)
    log(f"C15 step cost {json.dumps(rec)}")
    return rec


def determinism_check(workdir, counters, runs=2, log=log, ranks_runs=()):
    """ROADMAP C15: phase 8 (c) "w" and the production field of phase 9
    at 48 x 32 x 32 (its group sums, separators and tracer solves),
    each `runs` times in the default mode and `runs` times under
    torch.use_deterministic_algorithms(True, warn_only=True), with their
    Krylov iterations, matvecs and wall; the ops that warn in the
    deterministic mode are listed; and ranks_runs, the records of phase
    11 (b)'s repeated run over ranks. Raises if the runs of one model
    differ in tries, Newton or Krylov iterations, matvecs or tracer
    iterations. Returns the records."""
    from waiwera_tpu_torch.bench import REDUCED

    records = []
    for rec in ranks_runs:
        log(f"C15 run {json.dumps(rec)}")
        records.append(rec)
    if len({(r["tries"], r["newton"], r["krylov"], r["matvecs"],
             tuple(r["tracer_iterations"])) for r in ranks_runs}) > 1:
        raise RuntimeError(f"C15: the runs over ranks differ: {ranks_runs}")
    for model, cfg in (("w", eos_model_config("w", *REDUCED, steps=3)),
                       ("network", network_model_config(*REDUCED,
                                                        steps=3))):
        counts, first_y = set(), None
        for mode in ["default"] * runs + ["deterministic"] * runs:
            with warnings.catch_warnings(record=True) as seen:
                warnings.simplefilter("always")
                torch.use_deterministic_algorithms(mode == "deterministic",
                                                   warn_only=True)
                try:
                    ts, _, wall, _ = model_run(
                        workdir, REDUCED, steps=3,
                        log=lambda m: None, checkpoint=None, config=cfg,
                        name=f"c15_{model}_{mode}_{len(records)}")
                finally:
                    torch.use_deterministic_algorithms(False)
            st = ts.stats
            if first_y is None:
                first_y = ts.final_y.clone()
            rec = {"model": model, "mode": mode,
                   "krylov": st["linear_iterations"],
                   "matvecs": st["matvecs"],
                   "newton": st["newton_iterations"], "tries": st["tries"],
                   "tracer_iterations": st["tracer_iterations"],
                   "max_abs_y_diff_to_first": float(
                       (ts.final_y - first_y).abs().max()),
                   "wall_s": wall, "run_loop_s": sum(st["step_seconds"]),
                   "nondeterministic_ops": sorted({
                       str(w.message)[:100] for w in seen
                       if "does not have a deterministic" in str(w.message)})}
            log(f"C15 run {json.dumps(rec)}")
            records.append(rec)
            counts.add((rec["tries"], rec["newton"], rec["krylov"],
                        rec["matvecs"], tuple(rec["tracer_iterations"])))
            del ts
        if len(counts) != 1:
            raise RuntimeError(f"C15: the runs of {model} differ: "
                               f"{sorted(counts)}")
    return records


# phase 12: the try as replayed CUDA graphs against the same try eagerly
GRAPH_ROUNDS = 6
GRAPH_REFUSE_DT = 3.0e6  # phase 12 (c)'s first step size: refused tries
GRAPH_BDF2_DTS = (1.0e4, 3.0e4)  # phase 12 (d)'s first step sizes


def release():
    """Drop what earlier phases left: their Systems hold graph pools."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()


def _same_state(a, b, what):
    """Bitwise equality of two tensors (or pytrees of tensors)."""
    from torch.utils import _pytree as pytree

    for x, y in zip(pytree.tree_leaves(a), pytree.tree_leaves(b)):
        if isinstance(x, torch.Tensor) and not torch.equal(x, y):
            d = (x.double() - y.double()).abs().max().item()
            raise RuntimeError(f"{what}: graph and eager differ (max "
                               f"|diff| {d:.3e})")


def _settle(sim, step, settle=4, log=log):
    """The bench's settle protocol (retry ladder from 1e5 s, `settle`
    accepted steps at a held dt) with `step`; returns the step's inputs
    at the settled state and the held dt."""
    lhs, fluid, _ = sim.lhs_at(sim.y0, sim.region0)
    fx = sim.initial_fluxes(sim.y0, sim.region0)
    y, region, temp, lhs2 = sim.y0, sim.region0, fluid.temperature, lhs
    t, dt, dt_last, first = 0.0, 1.0e5, 1.0e5, 1.0
    accepted = tries = 0
    while accepted < settle:
        tries += 1
        if tries > 15 + 5 * settle:
            raise RuntimeError("phase 12: the flagship did not settle")
        res, f_new, l_new, fx_new = step(
            y, region, temp, lhs, lhs2, t, dt, dt_last, first,
            fluid_last=fluid, fluxes_last=fx)
        if res.converged and not res.failed:
            y, region, temp = res.y, res.region, f_new.temperature
            lhs2, lhs, fluid, fx = lhs, l_new, f_new, fx_new
            t, dt_last, first = t + dt, dt, 0.0
            accepted += 1
        else:
            dt *= 0.2
    log(f"phase 12 (a): settled after {tries} tries at dt {dt:g} s, "
        f"t {t:g} s")
    return (y, region, temp, lhs, lhs2, t, dt, dt_last, first,
            fluid, fx)


def graph_flagship(log=log, rounds=GRAPH_ROUNDS):
    """Phase 12 (a) and (b): the flagship's settled step through the
    graph program and eagerly, from one state in one process: equal
    counts, every output bitwise equal; then both timed in turns."""
    from waiwera_tpu_torch import bench
    from waiwera_tpu_torch.solver import krylov

    sim = build_sim(*FLAGSHIP, "cuda")
    graph, eager = make_step(sim), make_step(sim, eager=True)
    if (graph.program_mode, eager.program_mode) != ("graph", "eager"):
        raise RuntimeError(f"phase 12: step programs {graph.program_mode}, "
                           f"{eager.program_mode}")
    torch.cuda.synchronize()
    reserved0 = torch.cuda.memory_reserved()
    (y, region, temp, lhs, lhs2, t, dt, dt_last, first, fluid,
     fx) = _settle(sim, graph, log=log)
    # the settle ran through the graph program only: what it reserved is
    # the graph pool and the warm-ups' cached blocks
    torch.cuda.synchronize()
    settle_reserved = torch.cuda.memory_reserved() - reserved0

    def call(step, h=dt):
        return step(y, region, temp, lhs, lhs2, t, h, dt_last, first,
                    fluid_last=fluid, fluxes_last=fx)

    out_g, out_e = call(graph), call(eager)
    if not (out_g[0].converged and not out_g[0].failed):
        dt *= 0.2  # the bench's one rung down
        out_g, out_e = call(graph, dt), call(eager, dt)
    rg, re_ = out_g[0], out_e[0]
    counts = [(r.converged, r.failed, r.iterations, r.linear_iterations,
               r.matvecs, r.masked_iterations) for r in (rg, re_)]
    if counts[0] != counts[1]:
        raise RuntimeError(f"phase 12 (a): counts differ {counts}")
    _same_state((rg.y, rg.region, rg.max_residual) + tuple(out_g[1:]),
                (re_.y, re_.region, re_.max_residual) + tuple(out_e[1:]),
                "phase 12 (a) flagship step")
    chunks = (rg.linear_iterations + rg.masked_iterations) // krylov.CHUNK
    if rg.host_syncs > 1 + chunks + 2 * rg.iterations:
        raise RuntimeError(f"phase 12 (a): {rg.host_syncs} host syncs for "
                           f"{rg.iterations} Newton iterations and {chunks} "
                           "chunks")
    log(f"phase 12 (a): graph and eager flagship steps bitwise equal: "
        f"Newton {rg.iterations}, BiCGStab {rg.linear_iterations}, masked "
        f"{rg.masked_iterations}, matvecs {rg.matvecs}, chunks {chunks}; "
        f"host syncs graph {rg.host_syncs}, eager {re_.host_syncs}")

    # (b) in turns, the order reversed every other round
    times = {"graph": [], "eager": []}
    syncs = {}
    steps = {"graph": graph, "eager": eager}
    for r in range(rounds):
        for name in (("graph", "eager") if r % 2 == 0
                     else ("eager", "graph")):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = call(steps[name], dt)[0]
            torch.cuda.synchronize()
            times[name].append(time.perf_counter() - t0)
            syncs[name] = res.host_syncs
    q = {n: statistics.quantiles(v, n=4, method="inclusive")
         for n, v in times.items()}
    rec = {
        "graph_s": q["graph"][1], "graph_q1_s": q["graph"][0],
        "graph_q3_s": q["graph"][2], "eager_s": q["eager"][1],
        "eager_q1_s": q["eager"][0], "eager_q3_s": q["eager"][2],
        "graph_over_eager": q["graph"][1] / q["eager"][1],
        "host_syncs_graph": syncs["graph"], "host_syncs_eager": syncs["eager"],
        "graph_capture_seconds": graph.stats()["graph_capture_seconds"],
        "graph_captures": graph.stats()["graph_captures"],
        "newton": rg.iterations, "bicgstab": rg.linear_iterations,
        "masked": rg.masked_iterations, "dt": dt, "rounds": rounds,
        "settle_reserved_gb": settle_reserved / 1e9,
        "reserved_gb": torch.cuda.memory_reserved() / 1e9,
        "card": bench.card(),
    }
    log(f"phase 12 (b) {json.dumps(rec)}")
    rec["split"] = {n: step_split(steps[n], lambda s: call(s, dt))
                    for n in ("graph", "eager")}
    log(f"phase 12 (b) split {json.dumps(rec['split'])}")
    rec["chunk_sweep"] = chunk_sweep(sim, call, dt, rg, log=log,
                                     rounds=rounds)
    settled = (y, region, temp, lhs, lhs2, t, dt, dt_last, first, fluid, fx)
    return rec, sim, settled


def piece_split(prof):
    """{piece: {"ms", "n"}}: each piece's device ms (the union of the
    intervals of the device ops its launches made) and its launches, in
    a torch.profiler trace of the card (perfbench/lib/spans.py)."""
    from torch.autograd import DeviceType

    from perfbench.lib import spans

    res = spans.split(prof.profiler.kineto_results.events(), DeviceType.CUDA)
    return {k: {"ms": 1e3 * v["device_s"], "n": v["launches"]}
            for k, v in res["pieces"].items()}


def step_split(step, call):
    """One step's device time by piece (piece_split of the step under
    torch.profiler: ms and launches per piece) against the host-clock
    wall of the same step run without the profiler. Their sum over the
    wall is the device's busy share of the step."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    call(step)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        call(step)
        torch.cuda.synchronize()
    pieces = piece_split(prof)
    busy = sum(p["ms"] for p in pieces.values()) / 1e3
    return {"wall_s": wall, "pieces_s": busy, "pieces_share": busy / wall,
            "pieces": pieces}


GRAPH_CHUNKS = (4, 8, 16)  # krylov.CHUNK values timed in phase 12 (b)


def chunk_sweep(sim, call, dt, ref, log=log, rounds=GRAPH_ROUNDS):
    """The settled flagship step through the graph program at each
    krylov.CHUNK of GRAPH_CHUNKS (a program each), timed in turns: the
    same iterations and y bit for bit at every chunk size (masked
    iterations change nothing), other masked counts and host reads."""
    from waiwera_tpu_torch.solver import krylov

    saved = krylov.CHUNK
    steps = {}
    out = {}
    try:
        for k in GRAPH_CHUNKS:
            krylov.CHUNK = k
            steps[k] = make_step(sim)
            res = call(steps[k], dt)[0]
            if (res.iterations, res.linear_iterations) != (
                    ref.iterations, ref.linear_iterations) or \
                    not torch.equal(res.y, ref.y):
                raise RuntimeError(f"phase 12 (b): chunk {k} differs")
            out[k] = {"masked": res.masked_iterations,
                      "matvecs": res.matvecs, "host_syncs": res.host_syncs,
                      "capture_s": steps[k].stats()["graph_capture_seconds"],
                      "times": []}
        for r in range(rounds):
            for k in (GRAPH_CHUNKS if r % 2 == 0 else GRAPH_CHUNKS[::-1]):
                krylov.CHUNK = k
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                call(steps[k], dt)
                torch.cuda.synchronize()
                out[k]["times"].append(time.perf_counter() - t0)
    finally:
        krylov.CHUNK = saved
    for k, o in out.items():
        q = statistics.quantiles(o.pop("times"), n=4, method="inclusive")
        o.update(s=q[1], q1_s=q[0], q3_s=q[2])
    log(f"phase 12 (b) chunk sweep {json.dumps(out)}")
    return out


class _QuietLog:
    def write(self, *a, **k):
        pass


def graph_twins(config, first_dts, log=log, label=""):
    """Timestepper runs of `config` at each first step size, all on one
    Simulation through the graph program (so the later runs replay the
    first one's captures), and the same runs eagerly on another: the
    same tries, counts and final state bit for bit. Returns the graph
    runs' stats."""
    from waiwera_tpu_torch.sim.simulation import Simulation
    from waiwera_tpu_torch.sim.timestepper import Timestepper

    runs = {}
    for mode in ("graph", "eager"):
        sim = Simulation(json.loads(json.dumps(config)))
        sim._eager_step = mode == "eager"
        runs[mode] = []
        for dt in first_dts:
            cfg = json.loads(json.dumps(config))
            cfg["time"]["step"]["size"] = dt
            ts = Timestepper(cfg, sim, logger=_QuietLog())
            t0 = time.perf_counter()
            if not ts.run():
                raise RuntimeError(f"phase 12 {label}: {mode} run aborted")
            runs[mode].append((ts, time.perf_counter() - t0))
    out = []
    for (g, wg), (e, we) in zip(runs["graph"], runs["eager"]):
        if (g.stats["step_program"], e.stats["step_program"]) != (
                "graph", "eager"):
            raise RuntimeError(f"phase 12 {label}: programs "
                               f"{g.stats['step_program']}, "
                               f"{e.stats['step_program']}")
        if g.tried != e.tried:
            raise RuntimeError(f"phase 12 {label}: tries differ {g.tried} "
                               f"{e.tried}")
        keys = ("tries", "newton_iterations", "linear_iterations", "matvecs",
                "masked_krylov_iterations", "host_syncs_step")
        if [g.stats[k] for k in keys[:-1]] != [e.stats[k] for k in keys[:-1]]:
            raise RuntimeError(f"phase 12 {label}: counts differ "
                               f"{[(k, g.stats[k], e.stats[k]) for k in keys]}")
        _same_state((g.final_y, g.final_region), (e.final_y, e.final_region),
                    f"phase 12 {label} final state")
        rec = {"first_dt": g.tried[0][0],
               "tries": g.stats["tries"],
               "refused": sum(not ok for _, ok in g.tried),
               "newton": g.stats["newton_iterations"],
               "bicgstab": g.stats["linear_iterations"],
               "masked": g.stats["masked_krylov_iterations"],
               "graph_captures": g.stats["graph_captures"],
               "graph_capture_seconds": g.stats["graph_capture_seconds"],
               "graph_replays": g.stats["graph_replays"],
               "host_syncs_per_try_graph": g.stats["host_syncs_per_try"],
               "host_syncs_per_try_eager": e.stats["host_syncs_per_try"],
               "wall_graph_s": wg, "wall_eager_s": we}
        log(f"phase 12 {label} {json.dumps(rec)}")
        out.append(rec)
    return out


# phase 12 (e)-(f): timed rounds of graph and eager runs, after a first
# run in each mode (the graph run's captures, either's first-run set-up)
GRAPH_MODEL_ROUNDS = 3


def _run_record(ts, wall):
    """The counts, times and final state of one Timestepper run of phase
    12 (e)-(f)."""
    st = ts.stats
    net = ts.sim.sources
    flows = None
    if net is not None and net.num_sources:
        dt = ts.accepted[-1][0]
        flows = net.flows(ts.final_fluid, ts.final_time - dt,
                          ts.final_time)[0]
    return {
        "tried": list(ts.tried), "wall_s": wall,
        "run_loop_s": sum(st["step_seconds"]),
        "counts": {k: st[k] for k in (
            "tries", "newton_iterations", "linear_iterations", "matvecs",
            "masked_krylov_iterations", "tracer_iterations",
            "tracer_converged", "host_syncs_tracer")},
        "state": (ts.final_y, ts.final_region, ts.final_tracer, flows),
        "stats": st,
    }


def graph_model_turns(config, label, log=log, rounds=GRAPH_MODEL_ROUNDS,
                      monitor_lines=False, device=None,
                      split=("graph", "eager")):
    """Timestepper runs of `config` through the graph program (one
    Simulation, so that later runs replay the first one's captures) and
    eagerly (another): a first run in each mode, then `rounds` timed
    rounds in turns, the order reversed every other round. Every run's
    tries, counts (flow and tracer iterations, matvecs) and final state
    (y, regions, tracers, the network's flows over the last step) are
    bitwise equal to the first graph run's; on the card, one more run in
    each mode of `split` through profiled_run (the graph run under the
    profiler). Returns each mode's timed runs, its first run under mode
    + "_first" and its profiled run under mode + "_split" (device None:
    the CUDA device)."""
    from waiwera_tpu_torch.ops import dia
    from waiwera_tpu_torch.sim.simulation import Simulation
    from waiwera_tpu_torch.sim.timestepper import Timestepper

    kernels = (("dia_spmv", dia.dia_spmv_launches),
               ("dia_spmv_f64", dia.dia_spmv_f64_launches))
    sims = {}
    for mode in ("graph", "eager"):
        sims[mode] = Simulation(json.loads(json.dumps(config)),
                                device=device)
        sims[mode]._eager_step = mode == "eager"
    runs = {"graph": [], "eager": []}
    first = {}
    for r in range(rounds + 1):
        for mode in (("graph", "eager") if r % 2 == 0
                     else ("eager", "graph")):
            ts = Timestepper(json.loads(json.dumps(config)), sims[mode],
                             logger=_QuietLog())
            lines = LineCount(sys.stdout)
            for _, c in kernels:
                c.count = 0
            _sync(sims[mode].device)
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(lines):
                if not ts.run():
                    raise RuntimeError(f"phase 12 {label}: {mode} run "
                                       "aborted")
            _sync(sims[mode].device)
            rec = _run_record(ts, time.perf_counter() - t0)
            rec["monitor_lines"] = lines.count
            # the band SpMV's launches: a replay adds its graph's
            rec["counts"]["launches"] = {k: c.count for k, c in kernels}
            if r == 0:
                first[mode] = rec
            else:
                runs[mode].append(rec)
            del ts
    ref = first["graph"]
    for mode, recs in runs.items():
        for i, rec in enumerate([first[mode]] + recs):
            if rec["stats"]["step_program"] != mode or (
                    rec["counts"]["tracer_iterations"]
                    and rec["stats"]["tracer_program"] != mode):
                raise RuntimeError(
                    f"phase 12 {label}: {mode} run {i} ran the programs "
                    f"{rec['stats']['step_program']}, "
                    f"{rec['stats']['tracer_program']}")
            if rec["tried"] != ref["tried"] or rec["counts"] != ref["counts"]:
                raise RuntimeError(
                    f"phase 12 {label}: {mode} run {i} differs: "
                    f"{rec['tried']} {rec['counts']} against "
                    f"{ref['tried']} {ref['counts']}")
            if monitor_lines and (rec["monitor_lines"] == 0 or rec[
                    "monitor_lines"] != ref["monitor_lines"]):
                raise RuntimeError(f"phase 12 {label}: monitor lines "
                                   f"{rec['monitor_lines']}, "
                                   f"{ref['monitor_lines']}")
            _same_state(rec["state"], ref["state"],
                        f"phase 12 {label} {mode} run {i} final state")
    for mode, sim in sims.items():
        if sim.device.type == "cuda" and mode in split:
            # the kernel table of the graph run only: the same kernels
            # run eagerly
            runs[mode + "_split"] = profiled_run(sim, config,
                                                 profile=mode == "graph")
    for mode in ("graph", "eager"):
        runs[mode + "_first"] = first[mode]
    del sims
    release()
    return runs


def kernel_profile(fn, top=12, kernels=True):
    """fn() once under torch.profiler (CPU and CUDA activities): its wall
    (host clock, the card synchronised) and each piece's device ms and
    launches (piece_split); with kernels, the device's busy seconds (the
    sum of the kernels' self device time) and share of the wall, and the
    `top` kernels by device time (name, calls, ms). Returns (fn's value,
    record)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rec = {"wall_s": wall, "pieces": piece_split(prof)}
    if not kernels:
        return out, rec
    # the device side of the port's spans is no kernel
    kern = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]
    busy = sum(e.self_device_time_total for e in kern) / 1e6
    kern.sort(key=lambda e: -e.self_device_time_total)
    return out, {
        **rec, "device_busy_s": busy, "busy_share": busy / wall,
        "top": [(e.key[:70], e.count, e.self_device_time_total / 1e3)
                for e in kern[:top]]}


def profiled_run(sim, config, profile=True):
    """One more Timestepper run of `config` on `sim` under kernel_profile
    (with profile, its kernel table too): {"pieces" (the device ms and
    launches of each piece of its tries and tracer steps), "run_loop_s"
    (, "profile")}."""
    from waiwera_tpu_torch.sim.timestepper import Timestepper

    ts = Timestepper(json.loads(json.dumps(config)), sim, logger=_QuietLog())
    with open(os.devnull, "w") as null, contextlib.redirect_stdout(null):
        ok, prof = kernel_profile(ts.run, kernels=profile)
    if not ok:
        raise RuntimeError("phase 12: the profiled run aborted")
    out = {"pieces": prof.pop("pieces"),
           "run_loop_s": sum(ts.stats["step_seconds"])}
    if profile:
        out["profile"] = prof
    return out


def _quartiles(values):
    return statistics.quantiles(values, n=4, method="inclusive")


def graph_production_field(log=log, rounds=GRAPH_MODEL_ROUNDS):
    """Phase 12 (e): phase 9's production field (network_model_config at
    FLAGSHIP, 3 steps) through graphs and eagerly in turns (flow tries
    and the tracer step): bitwise equal with equal counts; the tracer
    solve's seconds per step in both modes, its host reads per solve and
    its captures."""
    from waiwera_tpu_torch import bench

    cfg = network_model_config(*FLAGSHIP, steps=3)
    cfg.pop("output", None)
    runs = graph_model_turns(cfg, "(e)", log=log, rounds=rounds)
    rec = {"size": list(FLAGSHIP), "rounds": rounds, "card": bench.card()}

    def tracer_per_step(s):
        return s["tracer_seconds"] / len(s["tracer_iterations"])

    for mode in ("graph", "eager"):
        recs = runs[mode]
        st = [r["stats"] for r in recs]
        first = runs[mode + "_first"]["stats"]
        per_step = [tracer_per_step(s) for s in st]
        loop = [r["run_loop_s"] for r in recs]
        rec[mode] = {
            "tracer_solve_s_per_step": per_step,
            "tracer_solve_s_per_step_median": _quartiles(per_step)[1],
            "run_loop_s": loop,
            "run_loop_s_median": _quartiles(loop)[1],
            "tracer_host_syncs_per_solve": st[0]["host_syncs_tracer"]
            / len(st[0]["tracer_iterations"]),
            "tracer_graph_captures": [s["tracer_graph_captures"]
                                      for s in st],
            "graph_captures": [s["graph_captures"] for s in st],
            "host_syncs_per_try": [
                (s["host_syncs_step"] + s["host_syncs_timestepper"])
                / s["tries"] for s in st],
            # the first run: the graph run's captures included
            "first_run": {
                "tracer_solve_s_per_step": tracer_per_step(first),
                "run_loop_s": runs[mode + "_first"]["run_loop_s"],
                "tracer_graph_captures": first["tracer_graph_captures"],
                "tracer_graph_capture_seconds": first[
                    "tracer_graph_capture_seconds"],
                "graph_captures": first["graph_captures"],
                "graph_capture_seconds": first["graph_capture_seconds"]},
        }
    c = runs["graph"][0]["counts"]
    rec.update(tries=c["tries"], newton=c["newton_iterations"],
               bicgstab=c["linear_iterations"], matvecs=c["matvecs"],
               gmres_iterations_per_tracer_solve=c["tracer_iterations"])
    # the timed rounds' medians: replays against eager runs
    rec["tracer_graph_over_eager"] = (
        rec["graph"]["tracer_solve_s_per_step_median"]
        / rec["eager"]["tracer_solve_s_per_step_median"])
    rec["run_loop_graph_over_eager"] = (rec["graph"]["run_loop_s_median"]
                                        / rec["eager"]["run_loop_s_median"])
    if rec["graph"]["first_run"]["tracer_graph_captures"] != 3 or any(
            rec["graph"]["tracer_graph_captures"]):
        raise RuntimeError(
            "phase 12 (e): tracer captures "
            f"{rec['graph']['first_run']['tracer_graph_captures']} in the "
            f"first run, {rec['graph']['tracer_graph_captures']} after")
    log(f"phase 12 (e) {json.dumps(rec)}")
    rec["split"] = {m: runs[m + "_split"] for m in ("graph", "eager")}
    log(f"phase 12 (e) split {json.dumps(rec['split'])}")
    return rec


def write_wedge_field(workdir):
    """Phase 10 (a)'s wedge field (WEDGE_FIELD) as a gmsh 4.1 binary
    file in `workdir`: (path, the plan positions)."""
    verts, wedges, pos = wedge_mesh(*WEDGE_FIELD)
    path = os.path.join(workdir, "wedge_field_p12.msh")
    write_gmsh(path, verts, [("wedge", wedges)], version="4.1", binary=True)
    return path, pos


def graph_wedge_field(path, pos, log=log, rounds=GRAPH_MODEL_ROUNDS):
    """Phase 12 (f): phase 10 (a)'s wedge field (write_wedge_field's
    file, the ELL route, lgmres + asm, the monitor on, 3 steps)
    through graphs and eagerly in turns: bitwise equal with equal counts
    and monitor lines; the run loops, host reads per try, capture
    seconds and LGMRES cycles."""
    from waiwera_tpu_torch import bench

    nx, ny, nz = WEDGE_FIELD
    cfg = wedge_model_config(path, nx, ny, nz, pos, steps=3,
                             solver=LGMRES_ASM, monitor=True)
    cfg.pop("output", None)
    runs = graph_model_turns(cfg, "(f)", log=log, rounds=rounds,
                             monitor_lines=True)
    c = runs["graph"][0]["counts"]
    restart = 30  # NewtonParams.linear_restart, the model's default
    cycles, rem = divmod(c["matvecs"] - c["newton_iterations"], restart + 1)
    if rem:
        raise RuntimeError(f"phase 12 (f): matvecs {c['matvecs']} are not "
                           f"1 + 31 cycles per solve")
    rec = {"wedges": 2 * nx * ny * nz, "rounds": rounds, "card": bench.card(),
           "tries": c["tries"], "newton": c["newton_iterations"],
           "lgmres_iterations": c["linear_iterations"],
           "lgmres_cycles": cycles, "matvecs": c["matvecs"],
           "monitor_lines": runs["graph"][0]["monitor_lines"]}
    for mode in ("graph", "eager"):
        recs = runs[mode]
        st = [r["stats"] for r in recs]
        loop = [r["run_loop_s"] for r in recs]
        first = runs[mode + "_first"]
        rec[mode] = {
            "run_loop_s": loop, "run_loop_s_median": _quartiles(loop)[1],
            "wall_s": [r["wall_s"] for r in recs],
            "host_syncs_per_try": [
                (s["host_syncs_step"] + s["host_syncs_timestepper"])
                / s["tries"] for s in st],
            "graph_captures": [s["graph_captures"] for s in st],
            # the first run: the graph run's captures included
            "first_run": {
                "run_loop_s": first["run_loop_s"],
                "wall_s": first["wall_s"],
                "graph_captures": first["stats"]["graph_captures"],
                "graph_capture_seconds": first["stats"][
                    "graph_capture_seconds"]},
        }
    # the timed rounds' medians: replays against eager runs
    rec["run_loop_graph_over_eager"] = (rec["graph"]["run_loop_s_median"]
                                        / rec["eager"]["run_loop_s_median"])
    if any(rec["graph"]["graph_captures"]) or not rec["graph"][
            "first_run"]["graph_captures"]:
        raise RuntimeError(
            "phase 12 (f): graph captures "
            f"{rec['graph']['first_run']['graph_captures']} in the first "
            f"run, {rec['graph']['graph_captures']} after")
    log(f"phase 12 (f) {json.dumps(rec)}")
    rec["split"] = {m: runs[m + "_split"] for m in ("graph", "eager")}
    log(f"phase 12 (f) split {json.dumps(rec['split'])}")
    return rec


def model_turns_record(runs, label):
    """The timed rounds of graph_model_turns as a record: per mode the
    run loops and their median, host reads per try and captures, and the
    first runs apart (the graph run's captures included); the ratio of
    the medians (replays against eager runs)."""
    rec = {}
    for mode in ("graph", "eager"):
        st = [r["stats"] for r in runs[mode]]
        loop = [r["run_loop_s"] for r in runs[mode]]
        first = runs[mode + "_first"]
        rec[mode] = {
            "run_loop_s": loop, "run_loop_s_median": _quartiles(loop)[1],
            "host_syncs_per_try": [
                (s["host_syncs_step"] + s["host_syncs_timestepper"])
                / s["tries"] for s in st],
            "graph_captures": [s["graph_captures"] for s in st],
            "first_run": {
                "run_loop_s": first["run_loop_s"],
                "graph_captures": first["stats"]["graph_captures"],
                "graph_capture_seconds": first["stats"][
                    "graph_capture_seconds"]},
        }
    rec["run_loop_graph_over_eager"] = (rec["graph"]["run_loop_s_median"]
                                        / rec["eager"]["run_loop_s_median"])
    if any(rec["graph"]["graph_captures"]) or not rec["graph"][
            "first_run"]["graph_captures"]:
        raise RuntimeError(
            f"phase 12 {label}: graph captures "
            f"{rec['graph']['first_run']['graph_captures']} in the first "
            f"run, {rec['graph']['graph_captures']} after")
    c = runs["graph"][0]["counts"]
    rec.update(tries=c["tries"], newton=c["newton_iterations"],
               krylov=c["linear_iterations"], matvecs=c["matvecs"],
               masked=c["masked_krylov_iterations"],
               launches=c["launches"])
    return rec


def cuda_events(fn):
    """fn() once under torch.profiler: the number of device events
    (kernels, copies and fills) it ran, and their names."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kern = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    return sum(e.count for e in kern), [e.key for e in kern]


def pc_kernels(sim, pc, settled):
    """The kernels one factorisation (the operator and preconditioner
    built from the Jacobian's parts, as a try's Krylov start piece does)
    and one application of preconditioner `pc` launch at the settled
    flagship state, f32 as the bench runs them: each captured as a CUDA
    graph and counted under torch.profiler over one replay, and over one
    eager call of the same code."""
    from waiwera_tpu_torch.solver.program import CudaGraphs, Program
    from waiwera_tpu_torch.solver.system import MethodCoeffs

    y, region, _, lhs, _, t, dt, _, _, _, _ = settled
    system = sim.system
    coeffs = MethodCoeffs(c_lhs=1.0, dt_eff=dt, const=-lhs)
    parts = system.jacobian_parts(y, region, sim.rock, coeffs, t, t + dt,
                                  tangent_dtype=torch.float32)
    gen = torch.Generator(device=sim.device).manual_seed(0)
    r = torch.randn(tuple(y.shape), generator=gen, device=sim.device)

    def factor(p):
        return system.linear_operator_from_parts(
            p, pc, dtype=torch.float32)[1]

    prog = Program(CudaGraphs(sim.device))
    p_s, r_s = prog.stage("in", (parts, r))
    apply = prog.run("factor", factor, p_s)
    z = prog.run("apply", apply, r_s)
    if not torch.equal(z, apply(r_s)):
        raise RuntimeError(f"phase 12 (g): {pc}'s replayed apply differs "
                           "from its eager call")
    out = {}
    for what, fn in (("factor", lambda: prog.run("factor", factor, p_s)),
                     ("apply", lambda: prog.run("apply", apply, r_s))):
        out[f"{what}_kernels_replay"] = cuda_events(fn)[0]
    out["factor_kernels_eager"] = cuda_events(lambda: factor(parts))[0]
    out["apply_kernels_eager"] = cuda_events(lambda: apply(r))[0]
    return out


GRAPH_PC_ROUNDS = 3  # phase 12 (g)'s timed rounds per preconditioner


def graph_line_cpr(sim, settled, log=log, rounds=GRAPH_PC_ROUNDS):
    """Phase 12 (g): from the flagship state (a) settled (band route, f32
    Jacobian and BiCGStab, as the bench runs them) one step with line
    and one with cpr through graphs and eagerly: the same Newton,
    BiCGStab, matvec and masked counts and dia_spmv launches, y,
    regions, fluid, balances and fluxes bitwise equal; then `rounds`
    rounds in turns, the order reversed every other round; the medians
    and their ratio, host reads per try, capture seconds and the kernels
    of one factorisation and one application (pc_kernels)."""
    from waiwera_tpu_torch import bench
    from waiwera_tpu_torch.ops import dia

    y, region, temp, lhs, lhs2, t, dt, dt_last, first, fluid, fx = settled
    out = {}
    for pc in ("line", "cpr"):
        steps = {"graph": make_step(sim, pc),
                 "eager": make_step(sim, pc, eager=True)}
        if (steps["graph"].program_mode, steps["eager"].program_mode) != (
                "graph", "eager"):
            raise RuntimeError(f"phase 12 (g) {pc}: step programs "
                               f"{steps['graph'].program_mode}, "
                               f"{steps['eager'].program_mode}")

        def call(step):
            return step(y, region, temp, lhs, lhs2, t, dt, dt_last, first,
                        fluid_last=fluid, fluxes_last=fx)

        outs, launches, first_s = {}, {}, {}
        for mode in ("graph", "eager"):
            dia.dia_spmv_launches.count = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs[mode] = call(steps[mode])
            torch.cuda.synchronize()
            first_s[mode] = time.perf_counter() - t0
            launches[mode] = dia.dia_spmv_launches.count
        rg, re_ = outs["graph"][0], outs["eager"][0]
        counts = [(r.converged, r.failed, r.iterations, r.linear_iterations,
                   r.matvecs, r.masked_iterations, r.host_syncs, n)
                  for r, n in ((rg, launches["graph"]),
                               (re_, launches["eager"]))]
        if counts[0] != counts[1]:
            raise RuntimeError(f"phase 12 (g) {pc}: counts differ {counts}")
        _same_state((rg.y, rg.region, rg.max_residual)
                    + tuple(outs["graph"][1:]),
                    (re_.y, re_.region, re_.max_residual)
                    + tuple(outs["eager"][1:]),
                    f"phase 12 (g) {pc} step")
        times = {"graph": [], "eager": []}
        for r in range(rounds):
            for mode in (("graph", "eager") if r % 2 == 0
                         else ("eager", "graph")):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = call(steps[mode])[0]
                torch.cuda.synchronize()
                times[mode].append(time.perf_counter() - t0)
                if res.matvecs != rg.matvecs or not torch.equal(res.y, rg.y):
                    raise RuntimeError(f"phase 12 (g) {pc}: {mode} round "
                                       f"{r} differs from the first step")
        med = {m: statistics.median(v) for m, v in times.items()}
        rec = {
            "pc": pc, "dt": dt, "converged": rg.converged,
            "newton": rg.iterations, "bicgstab": rg.linear_iterations,
            "masked": rg.masked_iterations, "matvecs": rg.matvecs,
            "dia_spmv_launches": launches["graph"],
            "host_syncs_per_try": rg.host_syncs,
            "graph_s": times["graph"], "eager_s": times["eager"],
            "graph_s_median": med["graph"], "eager_s_median": med["eager"],
            "graph_over_eager": med["graph"] / med["eager"],
            "first_step_s": first_s,
            "graph_captures": steps["graph"].stats()["graph_captures"],
            "graph_capture_seconds": steps["graph"].stats()[
                "graph_capture_seconds"],
            "rounds": rounds, "card": bench.card(),
            **pc_kernels(sim, pc, settled),
        }
        log(f"phase 12 (g) {json.dumps(rec)}")
        rec["split"] = {m: step_split(steps[m], call)
                        for m in ("graph", "eager")}
        log(f"phase 12 (g) {pc} split {json.dumps(rec['split'])}")
        out[pc] = rec
        del steps, outs
    return out


def graph_bcgsl_field(path, pos, log=log, rounds=GRAPH_MODEL_ROUNDS):
    """Phase 12 (h): the wedge field of (f) with phase 10 (b)'s solver,
    bcgsl + asm (ELL route, the monitor on, 3 steps), through graphs and
    eagerly in turns: bitwise equal with equal counts and monitor lines;
    the run loops, host reads per try and BiCGStab(l) chunks."""
    from waiwera_tpu_torch import bench
    from waiwera_tpu_torch.solver import krylov, newton

    nx, ny, nz = WEDGE_FIELD
    cfg = wedge_model_config(path, nx, ny, nz, pos, steps=3,
                             solver=BCGSL_ASM, monitor=True)
    cfg.pop("output", None)
    runs = graph_model_turns(cfg, "(h)", log=log, rounds=rounds,
                             monitor_lines=True, split=("graph",))
    rec = model_turns_record(runs, "(h)")
    if any(rec["launches"].values()):
        raise RuntimeError(f"phase 12 (h) on the ELL route launched "
                           f"{rec['launches']}")
    ell = newton.NewtonParams().linear_ell
    per_chunk = 2 * ell * max(1, krylov.CHUNK // ell)  # matvecs a chunk
    chunks, rem = divmod(rec["matvecs"], per_chunk)
    if rem:
        raise RuntimeError(f"phase 12 (h): matvecs {rec['matvecs']} are not "
                           f"{per_chunk} per chunk")
    rec.update(wedges=2 * nx * ny * nz, rounds=rounds, card=bench.card(),
               ell=ell, bcgsl_chunks=chunks,
               monitor_lines=runs["graph"][0]["monitor_lines"])
    log(f"phase 12 (h) {json.dumps(rec)}")
    rec["split"] = {m: runs.get(m + "_split") for m in ("graph", "eager")}
    log(f"phase 12 (h) split {json.dumps(rec['split'])}")
    return rec


LU_BOX = (16, 16, 16)  # phase 12 (i): 13,056 unknowns with the ghost layer


def lu_factor_cost(cfg, reps=5):
    """precond.lu's factorisation of the model's first Jacobian on the
    card (densify at the kept positions, lu_factor_ex): the median
    seconds of `reps` calls (the card synchronised), its unknowns, the
    linear-algebra backend PyTorch prefers and the device kernels of one
    factorisation whose names say which library ran it."""
    from waiwera_tpu_torch.sim.simulation import Simulation
    from waiwera_tpu_torch.solver import precond
    from waiwera_tpu_torch.solver.system import MethodCoeffs

    sim = Simulation(json.loads(json.dumps(cfg)))
    system = sim.system
    lhs, _, _ = sim.lhs_at(sim.y0, sim.region0)
    size = cfg["time"]["step"]["size"]
    coeffs = MethodCoeffs(c_lhs=1.0, dt_eff=size, const=-lhs)
    parts = system.jacobian_parts(sim.y0, sim.region0, sim.rock, coeffs,
                                  0.0, size)
    mat = system.assemble_bsr(parts)

    def factor():
        return precond.lu(mat, positions=system.lu_positions)

    factor()
    secs = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        factor()
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    # the library's kernels: cuSOLVER's getrf and MAGMA's name
    # themselves; the trailing updates are cuBLAS gemms
    _, names = cuda_events(factor)
    libs = sorted({k[:60] for k in names if any(
        w in k.lower() for w in ("getrf", "magma", "laswp", "trsm"))})
    gemms = sum("gemm" in k.lower() for k in names)
    return {"unknowns": system.mesh.num_cells * system.npv,
            "route": route(system), "dtype": str(mat.data.dtype),
            "factor_s": secs, "factor_s_median": statistics.median(secs),
            "preferred_linalg_library": str(
                torch.backends.cuda.preferred_linalg_library()),
            "library_kernels": libs, "gemm_kernels": gemms}


def graph_lu(workdir, log=log, rounds=GRAPH_MODEL_ROUNDS):
    """Phase 12 (i): lu at its largest size: phase 10 (d)'s tetrahedral
    box (lgmres + lu, the monitor on, 3 steps) and LU_BOX of the
    flagship model on the band route with f64 bcgs + lu (2 steps), each
    through graphs and eagerly in turns, bitwise equal with equal
    counts; the box's factorisation per Jacobian (lu_factor_cost)."""
    from waiwera_tpu_torch import bench

    tet, _ = tet_box_config(workdir)
    tet.pop("output", None)
    runs = graph_model_turns(tet, "(i) tetrahedra", log=log, rounds=rounds,
                             monitor_lines=True, split=("graph",))
    rec = {"tetrahedra": model_turns_record(runs, "(i) tetrahedra")}
    box = model_config(*LU_BOX, steps=2)
    box.pop("output")
    box["time"]["step"]["solver"]["linear"] = {
        "type": "bcgs", "preconditioner": {"type": "lu"}}
    runs_b = graph_model_turns(box, "(i) box", log=log, rounds=rounds,
                               split=("graph",))
    rec["box"] = model_turns_record(runs_b, "(i) box")
    rec["box"]["size"] = list(LU_BOX)
    rec["box"]["factorisation"] = lu_factor_cost(box)
    if rec["box"]["factorisation"]["route"] != "band":
        raise RuntimeError("phase 12 (i): the box took the "
                           f"{rec['box']['factorisation']['route']} route")
    # every Krylov matvec of the box launched the f64 band SpMV kernel
    if rec["box"]["launches"]["dia_spmv_f64"] != rec["box"]["matvecs"]:
        raise RuntimeError(f"phase 12 (i): launches "
                           f"{rec['box']['launches']} for "
                           f"{rec['box']['matvecs']} matvecs")
    rec.update(rounds=rounds, card=bench.card())
    log(f"phase 12 (i) {json.dumps(rec)}")
    rec["split"] = {"tetrahedra": {m: runs.get(m + "_split")
                                   for m in ("graph", "eager")},
                    "box": {m: runs_b.get(m + "_split")
                            for m in ("graph", "eager")}}
    log(f"phase 12 (i) split {json.dumps(rec['split'])}")
    return rec


ROW_GATHER_SHAPES = (  # (rows, width, dtype) of the Krylov loops' gathers
    (557_056, 2, torch.float64),  # the wedge field's ELL and DILU
    (532_480, 2, torch.float64),  # the production field's tracers
    (557_056, 4, torch.float64),  # 2 x 2 f64 blocks
    (532_480, 3, torch.float32),  # the flagship's f32 rows
)


def row_gather_cost(m=1_300_000, log=log):
    """PyTorch's row gathers (x[index], index_select) against
    ops/segment.py RowGather at the Krylov loops' shapes: `m` rows of an
    index near the diagonal (a face list), paired_ms in turns (CUDA
    events); the results must be equal bit for bit. Returns the
    record."""
    from waiwera_tpu_torch.ops.segment import RowGather

    gen = torch.Generator(device="cuda").manual_seed(0)
    rec = []
    for n, b, dtype in ROW_GATHER_SHAPES:
        x = torch.randn((n, b), generator=gen, device="cuda", dtype=dtype)
        near = torch.randint(-50, 50, (m,), generator=gen, device="cuda")
        index = (torch.arange(m, device="cuda") * n // m + near).clamp(0, n - 1)
        rows = RowGather(index)
        if not torch.equal(rows(x), x[index]):
            raise RuntimeError("RowGather differs from x[index]")
        t = paired_ms({"index": lambda: x[index],
                       "index_select": lambda: x.index_select(0, index),
                       "row_gather": lambda: rows(x)}, rounds=6)
        nbytes = m * (b * x.element_size() * 2 + 8)
        rec.append({"rows": n, "width": b, "dtype": str(dtype), "index": m,
                    **{k + "_ms": v[1] for k, v in t.items()},
                    "bound_ms": nbytes / PEAK_BYTES_S * 1e3})
    log(f"phase 12 row gathers {json.dumps(rec)}")
    return rec


def graph_phase(log=log):
    """Phase 12: (a)-(b) graph_flagship; (c) phase 7's 48 x 32 x 32 JSON
    model from a first step size that is refused; (d) two BDF2 runs at
    other first step sizes through one captured program; (e) phase 9's
    production field and (f) phase 10 (a)'s wedge field through graphs
    and eagerly in turns; (g) line and cpr from (a)'s settled flagship;
    (h) the wedge field with bcgsl + asm; (i) lu on the tetrahedral box
    and on a band-route box."""
    from waiwera_tpu_torch import bench

    t0 = time.perf_counter()
    flag, sim, settled = graph_flagship(log=log)
    line_cpr = graph_line_cpr(sim, settled, log=log)
    del sim, settled
    release()
    cfg = model_config(*bench.REDUCED, steps=3)
    cfg.pop("output")
    refused = graph_twins(cfg, (GRAPH_REFUSE_DT,), log=log, label="(c)")
    if refused[0]["refused"] < 1:
        raise RuntimeError("phase 12 (c): no try was refused")
    cfg = model_config(*bench.REDUCED, method="bdf2", steps=3)
    cfg.pop("output")
    bdf2 = graph_twins(cfg, GRAPH_BDF2_DTS, log=log, label="(d)")
    release()
    field = graph_production_field(log=log)
    with tempfile.TemporaryDirectory() as workdir:
        path, pos = write_wedge_field(workdir)
        wedge = graph_wedge_field(path, pos, log=log)
        bcgsl = graph_bcgsl_field(path, pos, log=log)
        lu = graph_lu(workdir, log=log)
    gathers = row_gather_cost(log=log)
    log(f"phase 12 (graph program) {time.perf_counter() - t0:.2f} s")
    return {"flagship": flag, "line_cpr": line_cpr, "refused": refused,
            "bdf2": bdf2, "production_field": field, "wedge_field": wedge,
            "bcgsl": bcgsl, "lu": lu, "row_gathers": gathers}


# phase 11: the multi-device run, ranks sharing the card through gloo
RANKS = 4
MULTI_RTOL_A = (1e-8, 1e-10)  # tests/test_parallel.py:193-196
MULTI_RTOL = 2e-5  # tests/test_parallel.py:387-403


def ranks_run(labels, cfgs, devices, log=log):
    """Each config over len(devices) ranks in turn, in one spawn of the
    ranks (parallel/launch.py, parallel/runs.py run_configs). Logs each
    run's and rank's set-up, run loop, host syncs per try, collectives,
    launches and matvecs. Returns (per config the ranks' results, the
    wall seconds of the spawn)."""
    from waiwera_tpu_torch.parallel import launch, runs

    t0 = time.perf_counter()
    per_rank = launch.run(runs.run_configs, devices, cfgs)
    wall = time.perf_counter() - t0
    out = []
    for k, label in enumerate(labels):
        res = [r[k] for r in per_rank]
        for r, x in enumerate(res):
            st = x["stats"]
            syncs = (st["host_syncs_step"] + st["host_syncs_timestepper"]
                     + st["host_syncs_tracer"])
            log(f"phase 11 ({label}) rank {r} on {devices[r]}: set-up "
                f"{x['setup_seconds']:.2f} s, run loop "
                f"{x['run_seconds']:.2f} s, tries {st['tries']}, Newton "
                f"{st['newton_iterations']}, Krylov "
                f"{st['linear_iterations']}, matvecs {st['matvecs']}, host "
                f"syncs per try {syncs / st['tries']:.1f}, collectives "
                f"{x['collectives']} taking "
                f"{ {k: round(v, 3) for k, v in x['collective_seconds'].items()} }"
                f" s, launches {x['launches']}, route {x['route']}")
            if not x["ok"]:
                raise RuntimeError(f"phase 11 ({label}): rank {r} aborted")
            if st["step_program"] != "eager":
                raise RuntimeError(f"phase 11 ({label}): rank {r} ran the "
                                   f"step program {st['step_program']}")
            if not np.array_equal(x["y"], res[0]["y"]):
                raise RuntimeError(f"phase 11 ({label}): ranks 0 and {r} "
                                   "hold different global states")
        log(f"phase 11 ({label}): every rank ran its tries eagerly (a "
            "distributed System: no graph program covers ranks, ROADMAP "
            "A18.5)")
        out.append(res)
    return out, wall


def against_one_rank(label, res, ts1, rtol, atol=0.0, tracers=False):
    """The ranks' run against the same model on one rank: the same tries
    (sizes to rtol 1e-12) and Newton iterations, y (and the tracers)
    within rtol / atol."""
    r0 = res[0]
    if [c for _, c in r0["tried"]] != [c for _, c in ts1.tried]:
        raise RuntimeError(f"phase 11 ({label}): tries {r0['tried']} against "
                           f"one rank's {ts1.tried}")
    np.testing.assert_allclose([d for d, _ in r0["tried"]],
                               [d for d, _ in ts1.tried], rtol=1e-12)
    if r0["stats"]["newton_iterations"] != ts1.stats["newton_iterations"]:
        raise RuntimeError(
            f"phase 11 ({label}): Newton {r0['stats']['newton_iterations']} "
            f"against one rank's {ts1.stats['newton_iterations']}")
    np.testing.assert_allclose(r0["y"], ts1.final_y.cpu().numpy(), rtol=rtol,
                               atol=atol, err_msg=f"phase 11 ({label}) y")
    if tracers:
        x1 = ts1.final_tracer.cpu().numpy()
        np.testing.assert_allclose(r0["tracer"], x1, rtol=rtol,
                                   atol=1e-6 * float(np.abs(x1).max()),
                                   err_msg=f"phase 11 ({label}) tracers")


def check_rank_launches(label, res, kernel):
    """On every rank the kernel's launches equal the rank's Krylov
    matvecs, and are more than 0."""
    for r, x in enumerate(res):
        n, mv = x["launches"][kernel], x["stats"]["matvecs"]
        if n <= 0 or n != mv:
            raise RuntimeError(f"phase 11 ({label}) rank {r}: {kernel} "
                               f"launches {n} != matvecs {mv}")


def dataset_names(group, prefix=""):
    """The paths of every dataset under an HDF5 group read with the
    port's reader, sorted."""
    from waiwera_tpu_torch.utils import hdf5

    out = []
    for key in group.keys():
        obj = group[key]
        if isinstance(obj, hdf5.Group):
            out += dataset_names(obj, prefix + key + "/")
        else:
            out.append(prefix + key)
    return sorted(out)


CLI_RANKS_RTOL = 1e-8  # phase 11 (a)'s bar, held on every dataset


def cli_ranks_run(workdir, device="cuda", ranks=2, log=log):
    """Phase 11 (e): phase 8 (d)'s 5 x 4 x 3 default-EOS model for 2
    steps through cli.run_json over `ranks` ranks sharing `device` (gloo
    on a card), rank 0 writing the HDF5 file through utils/hdf5.py, read
    back with the port's reader and held against the same model's file
    from one rank: the same datasets, shapes and dtypes, each within
    rtol 1e-8 and atol 1e-8 of its largest magnitude. Returns the wall
    seconds of the run over ranks."""
    from waiwera_tpu_torch import cli
    from waiwera_tpu_torch.utils import hdf5

    on_card = torch.device(device).type == "cuda"
    cfg = eos_model_config("we", 5, 4, 3, steps=2)
    name = "cli_ranks_1"
    model_run(workdir, (5, 4, 3), steps=2,
              device=None if on_card else device, log=lambda m: None,
              checkpoint=None, config=cfg, name=name)
    h5 = os.path.join(workdir, f"cli_ranks_{ranks}.h5")
    shared = ["cuda:0" if on_card else device] * ranks
    t0 = time.perf_counter()
    res = cli.run_json(os.path.join(workdir, name + ".json"), device=device,
                       num_devices=ranks, devices=shared,
                       overrides=["output.filename=" + json.dumps(h5)])
    wall = time.perf_counter() - t0
    if res.aborted or res.taken != 2:
        raise RuntimeError(f"phase 11 (e): aborted {res.aborted}, "
                           f"{res.taken} steps of 2")
    with hdf5.File(os.path.join(workdir, name + ".h5")) as f1, \
            hdf5.File(h5) as f2:
        names = dataset_names(f1)
        if dataset_names(f2) != names:
            raise RuntimeError(f"phase 11 (e): datasets {dataset_names(f2)} "
                               f"against one rank's {names}")
        for nm in names:
            a, b = f1[nm][...], f2[nm][...]
            if a.shape != b.shape or a.dtype != b.dtype:
                raise RuntimeError(f"phase 11 (e): {nm} {b.shape} {b.dtype} "
                                   f"against {a.shape} {a.dtype}")
            np.testing.assert_allclose(
                b, a, rtol=CLI_RANKS_RTOL,
                atol=CLI_RANKS_RTOL * float(np.abs(a).max()),
                err_msg=f"phase 11 (e) {nm}")
    log(f"phase 11 (e): cli.run_json over {ranks} ranks on {shared}, wall "
        f"{wall:.2f} s; rank 0's HDF5 file ({len(names)} datasets, "
        f"{os.path.getsize(h5) / 1e6:.3f} MB) within rtol {CLI_RANKS_RTOL} "
        "of one rank's")
    return wall


def multi_rank_phase(workdir, device="cuda", flagship=FLAGSHIP,
                     reduced=None, wedge=WEDGE_REDUCED, log=log):
    """Phase 11: the multi-device run, RANKS ranks sharing one device
    (gloo), each against the same model on one rank of that device.
    (a) phase 8 (a)'s default-EOS model at `flagship`, bjacobi, 2 steps;
    (b) phase 9's production field at `reduced` with asm (the local DILU,
    restricted additive Schwarz), 3 steps, twice (the counts must
    repeat); (c) phase 10 (b)'s wedge model at `wedge` from gmsh 4.1
    binary, lgmres + asm, 3 steps; (e) cli_ranks_run, the CLI over 2
    ranks sharing the device with rank 0 writing the HDF5 file; (d)
    where there are 2 cards or more, (a) over NCCL with one rank per
    card. Returns (launches summed over
    every rank of every run, the two runs of (b) as C15 records)."""
    from waiwera_tpu_torch.bench import REDUCED

    reduced = reduced or REDUCED
    on_card = torch.device(device).type == "cuda"
    total = {"dia_spmv": 0, "dia_spmv_f64": 0, "stream_scale": 0,
             "stream_scalar": 0}

    def add(res):
        for x in res:
            for k, n in x["launches"].items():
                total[k] += n

    def one_rank(label, cfg, steps):
        return model_run(workdir, None, steps=steps,
                         device=None if on_card else device,
                         log=log, checkpoint=None, config=cfg,
                         name=f"ranks1_{label}")[0]

    shared = [device] * RANKS
    # (a) the flagship, 2 steps; (b) the production field with asm, twice;
    # (c) the wedge model from gmsh on the ELL route: one spawn
    cfg_a = eos_model_config("we", *flagship, steps=2)
    cfg_b = network_model_config(*reduced, steps=3)
    cfg_b["time"]["step"]["solver"] = {
        "linear": {"preconditioner": {"type": "asm"}}}
    nx, ny, nz = wedge
    verts, wedges, pos = wedge_mesh(nx, ny, nz)
    path = os.path.join(workdir, "wedge_ranks.msh")
    write_gmsh(path, verts, [("wedge", wedges)], version="4.1", binary=True)
    cfg_c = wedge_model_config(path, nx, ny, nz, pos, steps=3,
                               solver=LGMRES_ASM)
    (res_a, res_b1, res_b2, res_c), wall = ranks_run(
        ["a", "b1", "b2", "c"], [cfg_a, cfg_b, cfg_b, cfg_c], shared, log=log)
    log(f"phase 11: {RANKS} ranks on {device}, one spawn for (a)-(c), wall "
        f"{wall:.2f} s")
    for res in (res_a, res_b1, res_b2, res_c):
        add(res)

    if res_a[0]["route"] != "bands":
        raise RuntimeError(f"phase 11 (a) took the {res_a[0]['route']} route")
    if on_card:
        check_rank_launches("a", res_a, "dia_spmv_f64")
    ts1 = one_rank("a", cfg_a, 2)
    against_one_rank("a", res_a, ts1, *MULTI_RTOL_A)
    log(f"phase 11 (a): run loop {res_a[0]['run_seconds']:.2f} s on "
        f"{RANKS} ranks against {sum(ts1.stats['step_seconds']):.2f} s on "
        f"one; tries, Newton and y (rtol {MULTI_RTOL_A[0]}) equal to one "
        "rank's")
    del ts1

    runs = []
    for res in (res_b1, res_b2):
        st = res[0]["stats"]
        runs.append({"model": f"network {RANKS} ranks", "mode": "default",
                     "krylov": st["linear_iterations"],
                     "matvecs": st["matvecs"],
                     "newton": st["newton_iterations"], "tries": st["tries"],
                     "tracer_iterations": st["tracer_iterations"],
                     "run_loop_s": res[0]["run_seconds"]})
    ts1 = one_rank("b", cfg_b, 3)
    against_one_rank("b", res_b2, ts1, MULTI_RTOL, atol=0.0, tracers=True)
    log(f"phase 11 (b): tries, Newton, y and tracers (rtol {MULTI_RTOL}) "
        f"equal to one rank's; counts (krylov, matvecs) "
        f"{[(r['krylov'], r['matvecs']) for r in runs]}")
    del ts1

    if res_c[0]["route"] != "ell":
        raise RuntimeError(f"phase 11 (c) took the {res_c[0]['route']} route")
    ts1 = one_rank("c", cfg_c, 3)
    against_one_rank("c", res_c, ts1, MULTI_RTOL)
    log(f"phase 11 (c): {nx * ny * nz * 2} wedges over {RANKS} ranks; "
        f"tries, Newton and y (rtol {MULTI_RTOL}) equal to one rank's")
    del ts1

    # (e) the CLI over 2 ranks sharing the device, rank 0 writing HDF5
    cli_ranks_run(workdir, device, log=log)

    # (d) NCCL, one rank per card
    cards = torch.cuda.device_count() if on_card else 0
    if cards >= 2:
        d = min(RANKS, cards)
        (res,), wall = ranks_run(["d"], [cfg_a],
                                 [f"cuda:{i}" for i in range(d)], log=log)
        check_rank_launches("d", res, "dia_spmv_f64")
        add(res)
        ts1 = one_rank("d", cfg_a, 2)
        against_one_rank("d", res, ts1, *MULTI_RTOL_A)
        log(f"phase 11 (d): {d} ranks over NCCL, wall {wall:.2f} s")
        del ts1
    else:
        log(f"phase 11 (d): not run, for want of a second card ({cards} "
            "CUDA device)")
    return total, runs


# phase 13: the Jacobian's cell chain as the kernel csrc/wge_cell_jvp.cu
# against its plain chain. Transcendental calls a row makes in the
# kernel: region 1 (liquid) IF97 region 1's two sums (68 exp, 2 log) and
# the viscosity (1 exp); region 2 (vapour) IF97 region 2's sums (95 exp,
# 3 log), the viscosity and air's mixture viscosity (1 exp, 1 log);
# region 4 both and the saturation line
WGE_TRANSCENDENTALS = {1: 71, 2: 100, 4: 171}
# H100 SXM special-function units: 16 per SM and clock, 132 SMs, 1.98 GHz
MUFU_PER_S = 16 * 132 * 1.98e9


def _graph_of(fn):
    """fn captured as a CUDA graph after a warm-up run on a side stream:
    (graph, its output)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    return graph, out


def _field_errors(got, plain, truth):
    """{field: (kernel's, plain's)} largest error over the field's largest
    magnitude, against the f64 truth."""
    def err(a, t):
        return float((a.double() - t).abs().max()
                     / t.abs().max().clamp_min(1e-300))
    return {k: (err(got[k], truth[k]), err(plain[k], truth[k]))
            for k in truth}


def wge_cell_phase(size=FLAGSHIP, log=log, rounds=12):
    """Phase 13: the flagship's tries from 1e5 s (retry ladder, 2 steps
    accepted) as graphs, with the kernel's launches equal to their Newton
    iterations (one Jacobian each); at the boiling state they reach, the
    kernel against the plain chain (every field's f32 error at most twice
    the plain f32 chain's against the plain f64 chain, equal phases), and
    each part of the f32 Jacobian replayed as a CUDA graph in turns (CUDA
    events): the plain cell chain, the kernel, the kernel with the source
    tangents, jacobian_parts on each route and the band pack with
    block-Jacobi; the cell chains also eagerly. Returns the record."""
    from waiwera_tpu_torch import bench
    from waiwera_tpu_torch.ops import wge_cell
    from waiwera_tpu_torch.solver.system import MethodCoeffs

    sim = build_sim(*size, "cuda")
    system = sim.system
    if not system.cell_kernel:
        raise RuntimeError("phase 13: the flagship took the plain chain")
    wge_cell.wge_cell_jvp_launches.count = 0
    tries = run_steps(sim, make_step(sim), accept=2)
    newton = sum(int(r.iterations) for _, r, _ in tries)
    launches = wge_cell.wge_cell_jvp_launches.count
    if launches != newton or launches == 0:
        raise RuntimeError(f"phase 13: {launches} kernel launches for "
                           f"{newton} Jacobians")
    last = [r for _, r, _ in tries if r.converged and not r.failed][-1]
    y, region = last.y, last.region
    regions = {r: int((region == r).sum()) for r in (1, 2, 3, 4)}
    if regions[4] == 0:
        raise RuntimeError(f"phase 13: no boiling cell ({regions})")
    rock, f32 = sim.rock, torch.float32
    rock32 = rock.to(f32)
    coeffs = MethodCoeffs(c_lhs=1.0, dt_eff=1.0e4, const=torch.zeros_like(y))
    t0, t1 = 0.0, 1.0e4

    def plain_cells():
        return system.cell_jvp(y.to(f32), region, rock.to(f32), t0, t1)

    def kernel_cells():
        return wge_cell.cell_jvp(system._cell_params, y, region, rock,
                                 system.mesh.is_ghost, f32)

    def kernel_and_sources():
        c = kernel_cells()
        return c, system.source_jvp(c.fluid(region), c.d_fluid, t0, t1)

    def parts(kernel):
        def fn():
            system.cell_kernel = kernel
            try:
                return system.jacobian_parts(y, region, rock, coeffs, t0, t1,
                                             tangent_dtype=f32)
            finally:
                system.cell_kernel = True
        return fn

    # the kernel against the plain chain at this state
    names = [k for k, _ in wge_cell.LAYOUT[:-1]]

    def fields(fluid, cond, d_fluid, d_cond, dL):
        out = dict(zip(names, fluid.float_fields()))
        out.update({f"d_{k}": v for k, v in zip(names, d_fluid)})
        out.update(conductivity=cond, d_conductivity=d_cond, dL=dL)
        return out

    truth = fields(*system.cell_jvp(y, region, rock, t0, t1)[:5])
    plain = system.cell_jvp(y.to(f32), region, rock32, t0, t1)
    k = kernel_cells()
    errs = _field_errors(fields(k.fluid(region), k.cond, k.d_fluid, k.d_cond,
                                k.dL), fields(*plain[:5]), truth)
    del truth
    worst = max(errs, key=lambda f: errs[f][0] / max(errs[f][1], 1e-300))
    bad = {f: e for f, e in errs.items() if not e[0] <= 2.0 * e[1]}
    if bad:
        raise RuntimeError(f"phase 13: kernel errors above twice the plain "
                           f"chain's: {bad}")
    if not torch.equal(k.phase_composition, plain[0].phase_composition):
        raise RuntimeError("phase 13: phase compositions differ")
    del plain, k
    release()

    graphs = {}
    for name, fn in (("plain_cell_chain", plain_cells),
                     ("kernel", kernel_cells),
                     ("kernel_and_sources", kernel_and_sources),
                     ("jacobian_plain", parts(False)),
                     ("jacobian_kernel", parts(True))):
        graphs[name] = _graph_of(fn)
    j_parts = graphs["jacobian_kernel"][1]
    graphs["band_pack_bjacobi"] = _graph_of(
        lambda: system.linear_operator_from_parts(j_parts, "bjacobi",
                                                  dtype=f32))
    replayed = paired_ms({n: g.replay for n, (g, _) in graphs.items()},
                         rounds=rounds, k=5)
    eager = paired_ms({"plain_cell_chain": plain_cells,
                       "kernel": kernel_cells}, rounds=6, k=3)
    del graphs, j_parts
    release()

    n = y.shape[0]
    # reads: y (f64 x 3), region (int32), five rock fields (f64), ghost;
    # writes: 24 primal and 3 x 27 tangent f32 values, phases (int32)
    nbytes = n * (24 + 4 + 40 + 1) + n * (24 * 4 + 3 * 27 * 4 + 4)
    calls = sum(WGE_TRANSCENDENTALS.get(r, 0) * c for r, c in regions.items())
    bound_bytes_ms = nbytes / PEAK_BYTES_S * 1e3
    bound_mufu_ms = calls / MUFU_PER_S * 1e3
    med = {name: t[1] for name, t in replayed.items()}
    rec = {
        "size": list(size), "rows": n, "regions": regions,
        "tries": len(tries), "newton": newton, "launches": launches,
        "replayed_ms": replayed, "eager_ms": eager,
        "split_plain_ms": {
            "cell_chain": med["plain_cell_chain"],
            "face_chain_and_assembly": med["jacobian_plain"]
            - med["plain_cell_chain"],
            "band_pack_bjacobi": med["band_pack_bjacobi"]},
        "split_kernel_ms": {
            "cell_chain": med["kernel_and_sources"],
            "face_chain_and_assembly": med["jacobian_kernel"]
            - med["kernel_and_sources"],
            "band_pack_bjacobi": med["band_pack_bjacobi"]},
        "bytes": nbytes, "transcendentals": calls,
        "bound_bytes_ms": bound_bytes_ms, "bound_mufu_ms": bound_mufu_ms,
        "bound_ms": max(bound_bytes_ms, bound_mufu_ms),
        "roofline_share": max(bound_bytes_ms, bound_mufu_ms) / med["kernel"],
        "worst_field": [worst, *errs[worst]],
        "card": bench.card(),
    }
    log(f"phase 13 (wge_cell_jvp) {json.dumps(rec)}")
    return rec


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    only = argv[argv.index("--phase") + 1] if "--phase" in argv else None
    if only not in (None, "12", "13"):
        raise SystemExit(f"chip_smoke: --phase {only}: only 12 and 13 run "
                         "alone")
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available()"
                         " is false)")
    from waiwera_tpu_torch import bench
    from waiwera_tpu_torch.ops import cuda_build, dia, stream, wge_cell
    from waiwera_tpu_torch.solver.system import MethodCoeffs

    t_all = time.perf_counter()
    device = "cuda"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. the card and the toolchain
    smi = bench.card()
    tools = bench.toolchain()
    log(f"card: {smi}")
    log(f"toolchain: {json.dumps(tools)}")

    # 2. build the kernels from the checkout, in parallel
    t0 = time.perf_counter()
    libs = cuda_build.build_all(["dia_spmv", "stream_scale", "wge_cell_jvp"],
                                extra_flags=("-Xptxas=-v",))
    log(f"built {[os.path.relpath(p, ROOT) for p in libs]} in "
        f"{time.perf_counter() - t0:.2f} s")

    if only is not None:
        if only == "12":
            graph_phase()
        else:
            wge_cell_phase()
        log(f"total {time.perf_counter() - t_all:.1f} s")
        print(smi)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        }}))
        return 0

    # 3. kernels vs plain on random inputs
    rng = np.random.default_rng(0)
    n_small = 100_003
    for dtype in (torch.float32, torch.float64):
        for b in (1, 2, 3, 4):
            offs = sorted({0, 1, -1, 3, -7, int(rng.integers(2, 500)),
                           -int(rng.integers(2, 500)), n_small,
                           -n_small - 5})
            m, x = random_matrix(rng, b, n_small, offs, device, dtype)
            compare_spmv(m, x, f"random b={b}", log)
        m, x = random_matrix(rng, 3, FLAGSHIP_ROWS, FLAGSHIP_OFFSETS, device,
                             dtype)
        compare_spmv(m, x, "random flagship shape", log)
        del m, x
    kstream = compare_stream(log)

    # 4. the main path: the port's bench, every section
    for c in (dia.dia_spmv_launches, dia.dia_spmv_f64_launches,
              stream.stream_scale_launches, stream.stream_scalar_launches):
        c.count = 0
    t0 = time.perf_counter()
    # no device named: the entry point takes the CUDA device by default.
    # The preconditioner sweep holds each pc for 2 accepted steps, not 4,
    # to leave the script's time to the model run of phase 7
    b = bench.Bench(emit=lambda r: None, log=log, sweep_settle=2)
    res = b.run()
    counts = {"dia_spmv": dia.dia_spmv_launches.count,
              "dia_spmv_f64": dia.dia_spmv_f64_launches.count,
              "stream_scale": stream.stream_scale_launches.count,
              "stream_scalar": stream.stream_scalar_launches.count}
    log(f"main path (bench) {time.perf_counter() - t0:.2f} s; launches "
        f"{counts}")
    for name, s in res["section_seconds"].items():
        log(f"bench section {name}: {s:.3f} s")
    check_bench(res, counts)

    release()
    # 5. the kernels on the flagship's first Jacobian, beside cuSPARSE
    sim = build_sim(*FLAGSHIP, device)
    lhs0, _, _ = sim.lhs_at(sim.y0, sim.region0)
    coeffs = MethodCoeffs(c_lhs=1.0, dt_eff=1.0e5, const=-lhs0)
    kern = {}
    for dtype in (torch.float32, torch.float64):
        parts = sim.system.jacobian_parts(
            sim.y0, sim.region0, sim.rock, coeffs, 0.0, 1.0e5,
            tangent_dtype=dtype,
        )
        mj = dia.bands_from_blocks(sim.system.dia, sim.system.band_fill,
                                   *parts, dtype=dtype)
        xj = torch.as_tensor(rng.standard_normal((mj.num_rows, 3)),
                             dtype=dtype, device=device)
        kern[dtype] = compare_spmv(mj, xj, "flagship Jacobian", log,
                                   library=True)
        del parts, mj, xj
    del sim

    # 6. the same small-box steps on the card and on the CPU
    dts = (1.0e4, 1.0e3, 1.0e3)
    small = []
    for dev in (device, "cpu"):
        s = build_sim(5, 4, 3, dev)
        small.append(run_steps(s, make_step(s), dts=dts))
    for (dt, rg, _), (_, rc, _) in zip(*small):
        if (rg.converged, rg.failed, rg.iterations) != (
                rc.converged, rc.failed, rc.iterations):
            raise RuntimeError(f"small box dt {dt}: card and CPU disagree")
        if not torch.equal(rg.region.cpu(), rc.region):
            raise RuntimeError(f"small box dt {dt}: regions disagree")
        torch.testing.assert_close(rg.y.cpu(), rc.y, rtol=2e-5, atol=2e-5)
    log(f"small box: {len(dts)} steps agree between the card and the CPU")

    release()
    # 7. the model run: JSON file -> Simulation(config) -> Timestepper ->
    # output and log, no device named
    counters = {"dia_spmv": dia.dia_spmv_launches,
                "dia_spmv_f64": dia.dia_spmv_f64_launches,
                "stream_scale": stream.stream_scale_launches,
                "stream_scalar": stream.stream_scalar_launches,
                "wge_cell_jvp": wge_cell.wge_cell_jvp_launches}
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as workdir:
        run_counts, run_wall, entry, phase7_io = flagship_io_run(
            workdir, counters)
        tb, _, _, _ = model_run(workdir, bench.REDUCED, method="bdf2",
                                steps=3, checkpoint=CHECKPOINT_SMALL)
        del tb
        pair = []
        for dev in (None, "cpu"):
            tsm, _, _, _ = model_run(workdir, (5, 4, 3), steps=2, device=dev,
                                     log=lambda m: None,
                                     checkpoint=CHECKPOINT_SMALL)
            pair.append(tsm)
    card, cpu = pair
    if [c for _, c in card.tried] != [c for _, c in cpu.tried]:
        raise RuntimeError("small model run: tries differ between the card "
                           f"and the CPU: {card.tried} {cpu.tried}")
    np.testing.assert_allclose([d for d, _ in card.tried],
                               [d for d, _ in cpu.tried], rtol=1e-12)
    torch.testing.assert_close(card.final_y.cpu(), cpu.final_y, rtol=2e-5,
                               atol=2e-5)
    log(f"small model run: {len(card.tried)} tries and {card.taken} steps "
        "agree between the card and the CPU")
    log(f"phase 7 (model run) {time.perf_counter() - t0:.2f} s, of which the "
        f"flagship run {run_wall:.2f} s through {entry}; HDF5 "
        f"{json.dumps(phase7_io)}")

    release()
    # 8. the EOS models: JSON files with their own EOS, thermodynamics
    # and curves through the port's entry points on the card
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as workdir:
        eos_records, eos_counts, w_run = eos_phase(workdir, counters)
    jac_s = {f"{r['run']} {r['eos']}": round(r["jacobian_parts_s"], 4)
             for r in eos_records}
    log(f"phase 8 (EOS models) {time.perf_counter() - t0:.2f} s; launches "
        f"{eos_counts}; jacobian_parts s {jac_s}")
    if eos_counts["dia_spmv_f64"] <= 0:
        raise RuntimeError("phase 8: dia_spmv_f64 was not launched")

    release()
    # 9. the production-field model: the source network, tracers and rock
    # controls at the flagship size through the port's entry points
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as workdir:
        net_record, net_counts = network_phase(workdir, counters)
    log(f"phase 9 (production field) {time.perf_counter() - t0:.2f} s; "
        f"launches {net_counts}")

    release()
    # 10. unstructured models read from mesh files (gmsh, exodus): the
    # wedge field on the ELL route with the BSR DILU, lgmres, bcgsl and lu
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as workdir:
        mesh_records, mesh_counts = mesh_file_phase(workdir, counters, w_run)
        log(f"phase 10 (mesh files) {time.perf_counter() - t0:.2f} s; "
            f"launches {mesh_counts}")
        # 11. the multi-device run: ranks sharing the card
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        rank_counts, rank_runs = multi_rank_phase(workdir)
        log(f"phase 11 (multi-device) {time.perf_counter() - t0:.2f} s; "
            f"launches over every rank {rank_counts}")
        # ROADMAP C15: do card runs repeat their own counts, and what
        # does the fixed-order scatter-sum cost?
        t0 = time.perf_counter()
        c15 = determinism_check(workdir, counters, ranks_runs=rank_runs)
        scatter_cost()
        scatter_step_cost()
    log(f"C15 check {time.perf_counter() - t0:.2f} s; (krylov, matvecs) "
        f"{[(r['model'], r['mode'], r['krylov'], r['matvecs']) for r in c15]}")

    # 12. the try as replayed CUDA graphs against the same try eagerly
    release()
    res["graph_program"] = graph_phase()

    # 13. the Jacobian's cell chain: the kernel against the plain chain
    release()
    res["wge_cell_jvp"] = wge_cell_phase()

    bw = res["measured_bandwidth_gb_s"] * 1e9
    entries = [
        ("dia_spmv", "dia_spmv.cu", "waiwera_tpu/ops/dia.py:982",
         kern[torch.float32]),
        ("dia_spmv_f64", "dia_spmv.cu", "waiwera_tpu/ops/dia.py:982",
         kern[torch.float64]),
        ("stream_scale", "stream_scale.cu", "bench.py:309", kstream),
    ]
    kernels = []
    for name, src, replaces, k in entries:
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": f"waiwera_tpu_torch/csrc/{src}",
            "replaces": replaces,
            "launches": counts[name],
            # stream_scale: its scalar kernel (head, tail, mismatched
            # alignment) beside the vector kernel's launches
            **({"launches_scalar": counts["stream_scalar"]}
               if name == "stream_scale" else {}),
            "launches_model_run": run_counts[name],
            "launches_eos_models": eos_counts[name],
            "launches_network_model": net_counts[name],
            "launches_mesh_file_models": mesh_counts[name],
            "launches_multi_rank": rank_counts[name],
            "max_abs_err": k["max_abs_err"],
            "ms": k["ms"],
            "plain_ms": k["plain_ms"],
            "bound_ms": k["bound_ms"],
            "bound_by": k["bound_by"],
            "library_ms": k["library_ms"],
            # in turns: quartiles of kernel and library, their ratio
            "q1_ms": k["q1_ms"], "q3_ms": k["q3_ms"],
            "library_q1_ms": k["library_q1_ms"],
            "library_q3_ms": k["library_q3_ms"],
            "ratio_to_library": k["ratio_to_library"],
            # the same bytes over the bandwidth the stream kernel measured
            "bound_measured_bw_ms": k["bytes"] / bw * 1e3,
        })
    log(f"total {time.perf_counter() - t_all:.1f} s")
    print(json.dumps(res))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
