"""Benchmark of waiwera_tpu_torch on one CUDA device (counterpart of the
JAX package's bench.py, which stays as it is).

    python3 -m waiwera_tpu_torch.bench [--budget-s S] [--nx NX --ny NY --nz NZ]

Flagship model: bench.py's 3-D box reservoir with EOS wge (water, air,
energy; 3 unknowns per cell), 128 x 64 x 64 cells plus 8,192 top ghost
cells (1,597,440 rows), an atmospheric top boundary, a deliverability
producer and a cold injector. One implicit timestep try is residuals, the
AD block Jacobian, BiCGStab solves and phase transitions, all on the card.

Headline: implicit_timestep_dof_per_s of a settled accepted step. The
step function is driven with the timestepper's retry ladder (dt x0.2 on
failure) until 4 steps are accepted at a fixed dt, then the next
converged step from that state is timed: best of 3 after one warm call,
host clock around work that ends in torch.cuda.synchronize().

Sections, in bench.py's order, each re-printing the whole JSON record:
- stages: f64 residual, f32 Jacobian parts, the linear solve, the
  transition pass, the carried-state initial residual, one Newton body
  (Newton with linear_max_iterations=1) and their sum against the step,
  the last three in the step's mode (graph programs on the card);
- roofline: SpMV nnz/s from the slope between chains of matvec +
  normalise and of normalise alone (CUDA graphs timed with CUDA
  events), bytes
  4 * (nnz + 2 * rows * npv) over the slope against the bandwidth that
  the stream kernel measures (ops/stream.py); below timer noise the
  section records a skip marker;
- reduced box 48 x 32 x 32: the settled step, the f64/f64 dtype table,
  the ELL SpMV rate on a permuted mesh, the MINC step (hybrid band +
  tail operator), a scipy spilu + BiCGStab CPU reference on the same
  Jacobian, and the preconditioner sweep (dilu, line, cpr; a pc whose
  settle fails, or runs past its time cap, records the failure).

A section that raises ends the run with exit code 1 after the record is
printed once more with the error. The bench reads and writes no history
file. Without a CUDA device it exits nonzero unless --device cpu is given.
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

from waiwera_tpu_torch.ops import dia as ops_dia
from waiwera_tpu_torch.ops import stream as ops_stream

FLAGSHIP = (128, 64, 64)
REDUCED = (48, 32, 32)
SETTLE = 4
LINEAR_PC = "bjacobi"  # the production preconditioner; the sweep compares
NOISE_S = 1e-6  # an SpMV faster than 1 us is below timer noise on any mesh
PC_SWEEP = ("dilu", "line", "cpr")
PC_TIME_CAP_S = 120.0  # per preconditioner of the sweep


def flagship_config(nx: int, ny: int, nz: int, minc: bool = False) -> dict:
    """The flagship model of bench.py build_sim; with minc, its
    dual-porosity lower half (production3d-style MINC)."""
    n = nx * ny * nz
    top0 = n - nx * ny  # first cell of the top layer
    config = {
        "eos": {"name": "wge"},
        "initial": {"primary": [5.0e6, 220.0, 1.0e5], "region": 1},
        "rock": {
            "types": [
                {
                    "name": "res",
                    "permeability": [5e-14, 5e-14, 2e-14],
                    "porosity": 0.1,
                }
            ]
        },
        "boundaries": [
            {
                "primary": [1.0e5, 20.0, 1.0e3],
                "region": 1,
                "faces": {
                    "cells": list(range(top0, n)),
                    "normal": [0.0, 0.0, 1.0],
                },
            }
        ],
        "source": [
            {
                "cell": top0 + nx * (ny // 2) + nx // 2,
                "deliverability": {"productivity": 1e-12,
                                   "pressure": 5.0e5},
                "direction": "production",
            },
            {"cell": nx * (ny // 2) + nx // 4, "rate": 20.0,
             "enthalpy": 500.0e3},
        ],
        "time": {"step": {"size": 1.0e5}},
    }
    if minc:
        config["mesh"] = {
            "zones": {
                "lower": {"type": "box", "z": [-20.0 * nz, -10.0 * nz]}
            },
            "minc": {
                "geometry": {
                    "fracture": {"volume": 0.1, "spacing": 50.0},
                    "matrix": {"volume": [0.3, 0.6]},
                },
                "rock": {"zones": ["lower"]},
            },
        }
    return config


def flagship_spacing(nx: int, ny: int, nz: int):
    """Cell widths (dx, dy, dz) and origin of the flagship box."""
    return ([50.0] * nx, [50.0] * ny, [20.0] * nz), [0.0, 0.0, -20.0 * nz]


def build_sim(nx: int, ny: int, nz: int, device=None, minc: bool = False):
    from waiwera_tpu_torch.mesh.rect import rectangular_mesh
    from waiwera_tpu_torch.sim.simulation import Simulation

    widths, origin = flagship_spacing(nx, ny, nz)
    mesh = rectangular_mesh(*widths, origin=origin)
    return Simulation(flagship_config(nx, ny, nz, minc=minc), mesh=mesh,
                      device=device)


def newton_params(pc="bjacobi", linear_dtype="float32",
                  jacobian_dtype="float32", **kw):
    from waiwera_tpu_torch.solver.newton import NewtonParams

    return NewtonParams(max_iterations=8, min_iterations=1,
                        linear_dtype=linear_dtype, linear_pc=pc,
                        jacobian_dtype=jacobian_dtype, **kw)


def make_step(sim, pc="bjacobi", linear_dtype="float32",
              jacobian_dtype="float32", eager=None):
    """The bench's step function: as replayed CUDA graphs on the card
    where the configuration is covered (eager=True runs it eagerly)."""
    return sim.make_step_fn(
        newton_params(pc, linear_dtype, jacobian_dtype), "beuler",
        eager=eager,
    )


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def spmv_launches() -> int:
    """Band SpMV kernel launches so far, f32 and f64."""
    return ops_dia.dia_spmv_launches.count + ops_dia.dia_spmv_f64_launches.count


def timeit(fn, device, reps: int = 3) -> float:
    """Best of `reps` host-clock seconds of fn() ending in a device
    synchronise, after one warm call."""
    fn()
    _sync(device)
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        _sync(device)
        best = min(best, time.perf_counter() - t0)
    return best


class SettleError(RuntimeError):
    """The settle protocol found no settled accepted step."""


def time_step(sim, step, reps=3, settle=SETTLE, max_seconds=None):
    """Seconds of one settled accepted implicit step, and its Newton and
    Krylov iterations (bench.py:time_step).

    The retry ladder (dt x0.2 on failure) finds a step size the model
    accepts, holds it for `settle` accepted steps, then times the next
    converged step from that state (one rung further down if that step
    fails at the held size). Raises SettleError when the settle fails,
    or when it runs past max_seconds. The operating point and the
    counts of the whole call are left in time_step.last_info."""
    device = sim.device
    t_start = time.perf_counter()
    launches0 = spmv_launches()
    graphs0 = step.stats() if hasattr(step, "stats") else {}
    lhs, fluid, _ = sim.lhs_at(sim.y0, sim.region0)
    fx = sim.initial_fluxes(sim.y0, sim.region0)
    y, region, temp = sim.y0, sim.region0, fluid.temperature
    lhs2 = lhs
    t, dt, dt_last, first = 0.0, 1.0e5, 1.0e5, 1.0
    accepted = tries = matvecs = 0
    max_tries = 15 + 5 * settle
    log = []

    def call(dt_try):
        nonlocal matvecs
        out = step(y, region, temp, lhs, lhs2, t, dt_try, dt_last, first,
                   fluid_last=fluid, fluxes_last=fx)
        matvecs += out[0].matvecs
        return out

    def ok(res):
        return res.converged and not res.failed

    while accepted < settle and tries < max_tries:
        if max_seconds is not None and \
                time.perf_counter() - t_start > max_seconds:
            raise SettleError(
                f"bench settle failed: {accepted}/{settle} accepted in "
                f"{tries} tries, past the {max_seconds:.0f} s cap"
            )
        tries += 1
        res, f_new, lhs_new, fx_new = call(dt)
        log.append((dt, res.iterations, res.linear_iterations, ok(res)))
        if ok(res):
            y, region, temp = res.y, res.region, f_new.temperature
            lhs2, lhs = lhs, lhs_new
            fluid, fx = f_new, fx_new
            t += dt
            dt_last = dt
            first = 0.0
            accepted += 1
        else:
            dt *= 0.2
    if accepted < settle:
        raise SettleError(f"bench settle failed: {accepted}/{settle} "
                          f"accepted in {tries} tries")
    res = call(dt)[0]
    if not ok(res):
        # the state can steepen at fixed dt: one rung down the ladder
        dt *= 0.2
        res = call(dt)[0]
        if not ok(res):
            raise SettleError(
                "bench step does not converge at the settled state"
            )

    def run():
        return call(dt)[0]

    t_best = timeit(run, device, reps)
    time_step.last_info = {
        "settle_accepted": accepted,
        "settle_tries": tries,
        "dt_timed": float(dt),
        "sim_time_reached": float(t),
        "tries": [list(e) for e in log],
        "krylov_matvecs": matvecs,
        "spmv_launches": spmv_launches() - launches0,
        "host_syncs_timed_step": res.host_syncs,
        "step_program": getattr(step, "program_mode", "eager"),
        "masked_krylov_iterations": res.masked_iterations,
        # the call's graph captures, their seconds and replays
        **{k: v - graphs0[k] for k, v in
           (step.stats() if graphs0 else {}).items()},
        "y_finite": bool(torch.isfinite(res.y).all()),
        "y_shape": list(res.y.shape),
    }
    return t_best, int(res.iterations), int(res.linear_iterations)


def chain_seconds(fn, k: int, device: torch.device, reps: int = 3) -> float:
    """Best of `reps` timings of k chained fn(i) calls, in seconds.

    On a CUDA device the k calls are captured in one CUDA graph and the
    replay is timed with CUDA events: launched eagerly, a chain of small
    ops keeps the device waiting for the host (~10 us of dispatch per op
    against a few us of work), and the slope would time the host. The
    host clock on the CPU."""
    if device.type == "cuda":
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):  # warm up outside the capture
            for i in range(2):
                fn(i)
        torch.cuda.current_stream(device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for i in range(k):
                fn(i)
        seconds = ops_stream.chain_seconds(lambda i: graph.replay(), 1, reps)
        del graph
        return seconds
    best = float("inf")
    for _ in range(reps + 1):
        t0 = time.perf_counter()
        for i in range(k):
            fn(i)
        best = min(best, time.perf_counter() - t0)
    return best


def slope_seconds(fn, k1, k2, device) -> float:
    return (chain_seconds(fn, k2, device) - chain_seconds(fn, k1, device)) \
        / (k2 - k1)


def roofline_fields(nnz: int, nrows: int, npv: int, per: float,
                    norm_per: float, bandwidth) -> dict:
    """The roofline record from the chain slopes: SpMV seconds are the
    matvec + normalise slope less the normalise slope. Below timer noise
    (< 1 us) the record is a skip marker, not an error (the slope says
    nothing at such a size). bandwidth() is called only when the SpMV
    time is real."""
    spmv_seconds = per - norm_per
    if spmv_seconds < NOISE_S:
        return {"spmv_skipped": (
            f"chain slope {spmv_seconds:.3e} s below timer noise; "
            "roofline needs a larger mesh")}
    spmv_bytes = 4.0 * (nnz + 2 * nrows * npv)
    bw = bandwidth()
    return {
        "spmv_seconds": spmv_seconds,
        "spmv_nnz_per_s": nnz / spmv_seconds,
        "spmv_bytes": spmv_bytes,
        "spmv_roofline_fraction": (spmv_bytes / spmv_seconds) / bw,
        "measured_bandwidth_gb_s": bw / 1e9,
    }


def spmv_roofline(sim) -> dict:
    """The SpMV roofline section on the flagship's first Jacobian (f32
    bands built once), against the stream kernel's bandwidth; chains of
    5 and 55 iterations."""
    from waiwera_tpu_torch.solver.system import MethodCoeffs

    device = sim.device
    system = sim.system
    npv = system.npv
    nrows = system.structure.num_rows
    lhs0, _, _ = sim.lhs_at(sim.y0, sim.region0)
    coeffs = MethodCoeffs(c_lhs=1.0, dt_eff=1.0e5, const=-lhs0)
    parts = system.jacobian_parts(sim.y0, sim.region0, sim.rock, coeffs,
                                  0.0, 1.0e5, tangent_dtype=torch.float32)
    mv, _ = system.linear_operator_from_parts(parts, "none",
                                              dtype=torch.float32)
    bufs = [torch.ones((nrows, npv), dtype=torch.float32, device=device)]

    def normalise(x):
        return x * (1.0 / (torch.max(torch.abs(x)) + 1e-30))

    def spmv_step(i):
        bufs[0] = normalise(mv(bufs[0]))

    def norm_step(i):
        bufs[0] = normalise(bufs[0])

    per = slope_seconds(spmv_step, 5, 55, device)
    norm_per = slope_seconds(norm_step, 5, 55, device)

    def bandwidth():
        return ops_stream.measure_bandwidth(device)

    out = {"spmv_path": ("cuda-dia" if device.type == "cuda" else
                         "torch-dia") if system.bands is not None else "ell"}
    nnz = len(system.structure.indices) * npv * npv
    out.update(roofline_fields(nnz, nrows, npv, per, norm_per, bandwidth))
    return out


def stage_breakdown(sim, linear_pc, step_seconds, iterations, linear_its,
                    masked_its=0) -> dict:
    """Per-stage seconds at the initial state (bench.py:480-623), each
    best of 3 and synchronised, in the step's mode (the C20 repair):
    where step_program_mode says "graph", the carried-state initial
    residual, the linear solve (krylov.bicgstab_solve, the operator built
    inside its first piece) and the capped Newton body run as pieces of
    graph programs over the System's CUDA graphs, as the timed step does
    (their eager times are kept under *_eager_seconds); elsewhere they
    run eagerly. The f64 residual, the Jacobian parts and the transition
    pass are timed eagerly, on their own.

    The stage sum composes the step from the Krylov iterations it
    executes, masked ones included (krylov.CHUNK per chunk):
    r0 + its * body + max(E_step - its * E_body, 0) * t_lin / E_lin,
    where body is the capped Newton iteration less r0, E_step the timed
    step's linear + masked iterations (linear_its + masked_its), E_body
    those of the capped body (one chunk) and E_lin those of the timed
    linear solve."""
    from waiwera_tpu_torch.sim.simulation import (
        step_program_mode,
        system_graphs,
    )
    from waiwera_tpu_torch.solver import krylov
    from waiwera_tpu_torch.solver.program import Program
    from waiwera_tpu_torch.solver.system import method_coeffs, time_tensor

    device = sim.device
    system = sim.system
    eos = sim.eos
    dt = 1.0e5
    lhs0, fluid0, _ = sim.lhs_at(sim.y0, sim.region0)
    coeffs = method_coeffs("beuler", dt, dt, 1.0, lhs0, lhs0)
    t0, t1 = time_tensor(0.0, device), time_tensor(dt, device)
    y0, region0, rock = sim.y0, sim.region0, sim.rock
    mode = step_program_mode(system, newton_params(linear_pc))
    out = {"stage_program": mode}

    def resid():
        return system.residual(y0, region0, rock, coeffs, t0, t1)

    def jac():
        return system.jacobian_parts(y0, region0, rock, coeffs, t0, t1,
                                     tangent_dtype=torch.float32)

    out["residual_f64_seconds"] = timeit(resid, device)
    out["jacobian_parts_seconds"] = timeit(jac, device)
    temp0 = fluid0.temperature

    def trans():
        old = eos.unscale(y0, region0)
        new, new_region, _, _ = eos.transition(old, old * 1.000001, region0,
                                               temp0)
        new, _ = eos.check_primary_variables(new, new_region)
        return eos.scale(new, new_region)

    out["transition_seconds"] = timeit(trans, device)
    r32 = resid()[0].to(torch.float32)
    parts = jac()
    fx0 = sim.initial_fluxes(y0, region0)
    # Newton with the Krylov loop capped at 1 iteration fails after ONE
    # Newton iteration: t = initial residual + one whole body
    cap = newton_params(linear_pc, linear_max_iterations=1)._replace(
        max_iterations=2, min_iterations=2)

    def operator(p, r):
        mv, pc = system.linear_operator_from_parts(p, linear_pc,
                                                   dtype=torch.float32)
        return mv, pc, r

    def stages(graph):
        """(t_r0, t_lin, E_lin, its_lin, t_cap, E_body) through graph
        programs (graph) or eagerly."""
        def program():
            return Program(system_graphs(system)) if graph else Program()

        prog = program()
        r0_in = prog.stage("r0", (fluid0, lhs0, fx0, coeffs, t0, t1))
        t_r0 = timeit(lambda: prog.run("r0", system.residual_from_state,
                                       *r0_in), device)
        prog = program()
        lin_in = prog.stage("lin", (parts, r32))
        lin = []

        def solve():
            lin.append(krylov.bicgstab_solve(prog, operator, *lin_in,
                                             rtol=1e-5, name="lin"))

        t_lin = timeit(solve, device)
        step = sim.make_step_fn(cap, "beuler", eager=not graph)
        capped = []

        def body():
            capped.append(step(y0, region0, temp0, lhs0, lhs0, 0.0, dt, dt,
                               1.0, fluid_last=fluid0, fluxes_last=fx0)[0])

        t_cap = timeit(body, device)
        return (t_r0, t_lin,
                lin[-1].iterations + lin[-1].masked_iterations,
                lin[-1].iterations, t_cap,
                capped[-1].linear_iterations + capped[-1].masked_iterations)

    t_r0, t_lin, e_lin, its_lin, t_cap1, e_body = stages(mode == "graph")
    if mode == "graph":
        eager = stages(False)
        out["initial_residual_eager_seconds"] = eager[0]
        out["linear_solve_eager_seconds"] = eager[1]
        out["newton_body_eager_seconds"] = max(eager[4] - eager[0], 0.0)
    out["initial_residual_seconds"] = t_r0
    out["linear_solve_seconds"] = t_lin
    out["linear_solve_iterations_one"] = its_lin
    out["linear_solve_executed_iterations_one"] = e_lin
    body = max(t_cap1 - t_r0, 0.0)
    out["newton_body_seconds"] = body
    out["newton_body_executed_iterations"] = e_body
    n_it = max(iterations, 1)
    e_step = linear_its + masked_its
    lin_per_it = t_lin / max(e_lin, 1)
    stage_sum = t_r0 + n_it * body + max(e_step - n_it * e_body, 0) \
        * lin_per_it
    out["stage_sum_seconds"] = stage_sum
    out["stage_vs_step"] = stage_sum / step_seconds
    return out


def ell_rate(sim_r, device) -> dict:
    """ELL SpMV nnz/s on the reduced mesh with its cells permuted, so
    the band detection fails (bench.py:741-788): random f32 blocks."""
    from waiwera_tpu_torch.ops import ell as ops_ell
    from waiwera_tpu_torch.solver import bsr as bsr_mod

    npv = sim_r.eos.num_primary_variables
    rng = np.random.default_rng(0)
    n_e = sim_r.mesh.num_interior_cells
    perm = rng.permutation(n_e)
    fc_all = np.asarray(sim_r.mesh.face_cells)
    inner = (fc_all < n_e).all(axis=1)
    st = bsr_mod.build_structure(n_e, perm[fc_all[inner]], npv)
    es = ops_ell.ell_structure(st, device=device)
    nnzb = len(st.indices)
    data = torch.as_tensor(
        rng.standard_normal((nnzb, npv, npv)).astype(np.float32),
        device=device,
    )
    mat = bsr_mod.BSRMatrix(
        structure=st, data=data,
        diag_pos=torch.as_tensor(st.diag_pos, device=device))
    m = ops_ell.to_ell(mat, es, torch.float32)
    bufs = [torch.ones((n_e, npv), dtype=torch.float32, device=device)]

    def ell_step(i):
        y = m.matvec(bufs[0])
        bufs[0] = y * (1.0 / (torch.max(torch.abs(y)) + 1e-30))

    per = slope_seconds(ell_step, 3, 13, device)
    if per < NOISE_S:
        return {"ell_skipped": f"chain slope {per:.3e} s below timer noise"}
    return {"ell_spmv_nnz_per_s": nnzb * npv * npv / per}


def cpu_reference(sim_r, n_flagship, linear_solve_seconds=None) -> dict:
    """scipy spilu + BiCGStab on the reduced model's first f64 Jacobian
    (bench.py:818-890; block-Jacobi when ILU breaks down)."""
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla

    from waiwera_tpu_torch.solver.system import MethodCoeffs

    npv = sim_r.eos.num_primary_variables
    n_r = sim_r.mesh.num_interior_cells
    dt = 1.0e5
    lhs_r, _, _ = sim_r.lhs_at(sim_r.y0, sim_r.region0)
    coeffs = MethodCoeffs(c_lhs=1.0, dt_eff=dt, const=-lhs_r)
    r, _, _, _, mat = sim_r.system.residual_and_jacobian(
        sim_r.y0, sim_r.region0, sim_r.rock, coeffs, 0.0, dt)
    st = mat.structure
    data = mat.data.cpu().numpy()
    A = sp.bsr_matrix((data, st.indices, st.indptr),
                      shape=(st.num_rows * npv, st.num_rows * npv)).tocsc()
    b = -r.cpu().numpy().reshape(-1)
    t0 = time.perf_counter()
    what = "scipy spilu+bicgstab linear solve"
    try:
        ilu = spla.spilu(A, drop_tol=1e-5, fill_factor=10)
        M = spla.LinearOperator(A.shape, ilu.solve)
    except RuntimeError:
        # ILU pivot breakdown: block-Jacobi, the preconditioner of the
        # card's solve
        what = "scipy bjacobi+bicgstab linear solve"
        dinv = np.linalg.inv(data[st.diag_pos])

        def bj(v):
            return np.einsum("nij,nj->ni", dinv,
                             v.reshape(-1, npv)).reshape(-1)

        M = spla.LinearOperator(A.shape, bj)
    cnt = [0]

    def cb(xk):
        cnt[0] += 1

    _, info = spla.bicgstab(A, b, M=M, rtol=1e-5, maxiter=2000, callback=cb)
    out = {"cells": n_r, "what": what,
           "seconds": time.perf_counter() - t0, "iterations": cnt[0],
           "info": int(info)}
    if linear_solve_seconds is not None:
        # the flagship's linear solve scaled to the reduced size
        out["gpu_linear_seconds_scaled"] = (
            linear_solve_seconds * n_r / n_flagship
        )
    return out


def toolchain() -> dict:
    from waiwera_tpu_torch.ops import cuda_build

    try:
        import triton  # noqa: F401

        has_triton = True
    except ImportError:
        has_triton = False
    out = {"torch": torch.__version__, "torch_cuda": torch.version.cuda,
           "triton": has_triton, "nvcc": None, "nvcc_version": None}
    try:
        path = cuda_build.nvcc()
    except FileNotFoundError:
        return out
    ver = subprocess.run([path, "--version"], capture_output=True, text=True)
    out["nvcc"] = path
    out["nvcc_version"] = ver.stdout.strip().splitlines()[-1]
    return out


def card() -> str:
    """nvidia-smi's name and power limit of the card, or None."""
    if shutil.which("nvidia-smi") is None:
        return None
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip()


class Bench:
    """Runs the sections in order into self.result; emit() is called
    after each with the whole record."""

    def __init__(self, device=None, size=FLAGSHIP, budget_s=None,
                 emit=None, log=None, sweep_settle=SETTLE):
        """sweep_settle: accepted steps each preconditioner of the sweep
        is held for before its step is timed (the other sections always
        hold SETTLE); a caller short of time gives fewer."""
        from waiwera_tpu_torch.sim.simulation import resolve_device

        self.device = resolve_device(device)
        self.size = tuple(size)
        self.budget_s = budget_s
        self.sweep_settle = sweep_settle
        self.emit = emit or (lambda result: None)
        self.log = log or (lambda msg: None)
        self.t_start = time.time()
        self.result = {}
        self.section_seconds = {}

    def over_budget(self, reserve: float) -> bool:
        return self.budget_s is not None and \
            time.time() - self.t_start > self.budget_s - reserve

    def section(self, name: str, fn, reserve: float = 0.0):
        """Run one section: record its keys and wall seconds, re-emit.
        Under an explicit budget a section that cannot fit is marked
        skipped. An exception propagates after the record is emitted
        with it."""
        if self.over_budget(reserve):
            self.result[f"{name}_skipped"] = "skipped: time budget"
            self.emit(self.result)
            return None
        t0 = time.perf_counter()
        try:
            out = fn()
        except Exception as e:
            self.result[f"{name}_error"] = repr(e)
            self.section_seconds[name] = time.perf_counter() - t0
            self.result["section_seconds"] = dict(self.section_seconds)
            self.emit(self.result)
            raise
        self.section_seconds[name] = time.perf_counter() - t0
        if isinstance(out, dict):
            self.result.update(out)
        self.result["section_seconds"] = dict(self.section_seconds)
        self.log(f"# section {name}: {self.section_seconds[name]:.3f} s")
        self.emit(self.result)
        return out

    def run(self) -> dict:
        linear_pc = LINEAR_PC
        res = self.result
        res.update({"device": str(self.device),
                    "card": card() if self.device.type == "cuda" else None,
                    "toolchain": toolchain()})
        nx, ny, nz = self.size
        n = nx * ny * nz
        state = {}

        def headline():
            sim = build_sim(nx, ny, nz, self.device)
            npv = sim.eos.num_primary_variables
            step_seconds, its, lin_its = time_step(sim, make_step(sim,
                                                                  linear_pc))
            state.update(sim=sim, step_seconds=step_seconds, its=its,
                         lin_its=lin_its, masked=time_step.last_info[
                             "masked_krylov_iterations"])
            return {
                "metric": "implicit_timestep_dof_per_s",
                "value": n * npv / step_seconds,
                "unit": "dof/s",
                "cells": n,
                "unknowns": n * npv,
                "eos": "wge",
                "newton_iterations": its,
                "linear_iterations": lin_its,
                "linear_pc": linear_pc,
                "step_seconds": step_seconds,
                "operating_point": time_step.last_info,
                "timing_note": (
                    "settled accepted step: fixed-dt retry-ladder warm-up "
                    "(4 accepted), then the next converged step, best of 3 "
                    "after one warm call, host clock up to "
                    "torch.cuda.synchronize()"
                ),
            }

        self.section("headline", headline)
        sim = state["sim"]
        self.section("stage", lambda: stage_breakdown(
            sim, linear_pc, state["step_seconds"], state["its"],
            state["lin_its"], state["masked"]), reserve=180.0)
        self.section("spmv", lambda: spmv_roofline(sim), reserve=150.0)
        del state["sim"], sim

        rx, ry, rz = REDUCED if n >= np.prod(REDUCED) else (nx, ny, nz)
        n_r = rx * ry * rz

        def reduced():
            sim_r = build_sim(rx, ry, rz, self.device)
            state["sim_r"] = sim_r
            t, it, li = time_step(sim_r, make_step(sim_r, linear_pc), reps=2)
            state["t_mixed"] = t
            return {"reduced_cells": n_r, "reduced_step_seconds": t,
                    "reduced_linear_iterations": li,
                    "reduced_operating_point": time_step.last_info,
                    "pc_sweep": {linear_pc: {"step_seconds": t, "newton": it,
                                             "linear_iterations": li}}}

        self.section("reduced", reduced, reserve=120.0)
        if "sim_r" not in state:  # skipped for the time budget
            res["bench_wall_seconds"] = time.time() - self.t_start
            self.emit(res)
            return res
        sim_r = state["sim_r"]

        def dtype_table():
            t64, it, li = time_step(sim_r, make_step(
                sim_r, linear_pc, "float64", "float64"), reps=2)
            return {"dtype_table": {
                "cells": n_r,
                "mixed_f32_step_seconds": state["t_mixed"],
                "full_f64_step_seconds": t64,
                "f64_over_mixed": t64 / state["t_mixed"],
                "f64_newton": it, "f64_linear_iterations": li,
                "f64_operating_point": time_step.last_info,
            }}

        self.section("dtype", dtype_table, reserve=90.0)
        self.section("ell", lambda: ell_rate(sim_r, self.device),
                     reserve=90.0)

        def minc():
            sim_m = build_sim(rx, ry, rz, self.device, minc=True)
            sys_m = sim_m.system
            t, it, li = time_step(sim_m, make_step(sim_m, linear_pc), reps=2)
            npv = sim_m.eos.num_primary_variables
            return {
                "minc_cells": int(sim_m.mesh.num_cells),
                "minc_step_seconds": t,
                "minc_dof_per_s": sim_m.mesh.num_cells * npv / t,
                "minc_newton": it,
                "minc_linear_iterations": li,
                "minc_spmv_path": ("dia" if sys_m.dia is not None else
                                   "hybrid-dia" if sys_m.hybrid is not None
                                   else "ell"),
                "minc_tail_faces": int(sys_m._tail_cl.numel()),
                "minc_operating_point": time_step.last_info,
            }

        self.section("minc", minc, reserve=120.0)
        self.section("cpu_reference", lambda: {"cpu_reference": cpu_reference(
            sim_r, n, res.get("linear_solve_seconds"))}, reserve=120.0)

        for other in PC_SWEEP:
            if other == linear_pc:
                continue

            def sweep(pc=other):
                try:
                    t, it, li = time_step(sim_r, make_step(sim_r, pc),
                                          reps=2, settle=self.sweep_settle,
                                          max_seconds=PC_TIME_CAP_S)
                    entry = {"step_seconds": t, "newton": it,
                             "linear_iterations": li,
                             "operating_point": time_step.last_info}
                except SettleError as e:
                    entry = {"error": repr(e)}
                return {"pc_sweep": {**res["pc_sweep"], pc: entry}}

            self.section(f"pc_{other}", sweep, reserve=300.0)
        res["bench_wall_seconds"] = time.time() - self.t_start
        self.emit(res)
        return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--budget-s", type=float, default=None,
                    help="skip the sections that cannot fit this many "
                         "seconds (default: run every section)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device; the "
                         "roofline section needs one)")
    ap.add_argument("--nx", type=int, default=FLAGSHIP[0])
    ap.add_argument("--ny", type=int, default=FLAGSHIP[1])
    ap.add_argument("--nz", type=int, default=FLAGSHIP[2])
    args = ap.parse_args(argv)

    def emit(result):
        print(json.dumps(result), flush=True)

    try:
        Bench(device=args.device, size=(args.nx, args.ny, args.nz),
              budget_s=args.budget_s, emit=emit,
              log=lambda m: print(m, flush=True)).run()
    except Exception as e:  # a failed section emitted the record first
        print(f"# bench failed: {e!r}", file=sys.stderr, flush=True)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
