#!/usr/bin/env python3
"""Smoke run of waiwera_tpu_torch on one CUDA device.

    python3 chip_smoke.py

Phases (any failure raises and the exit code is nonzero):
1. the card: nvidia-smi name and power limit, torch's CUDA, nvcc;
2. build the CUDA kernels csrc/dia_spmv.cu and csrc/stream_scale.cu from
   the checkout (one nvcc each, started together, sm_90a);
3. each kernel against its plain PyTorch version on the card:
   - dia_spmv_f32 at b = 1..4 with odd, negative and out-of-range
     offsets, and at the flagship shape (b = 3, offsets 0, +-1, +-128,
     +-8192, n = 532,480): rtol 1e-5, atol 1e-5 * max|y| (f32 FMA
     contraction and summation order);
   - dia_spmv_f64 at the same shapes: rtol 1e-12, atol 1e-12 * max|y|
     (f64 FMA contraction);
   - stream_scale on an [8, 8Mi] f32 array against x * 0.999999: equal
     to within 1 ulp (one f32 multiply each; bitwise equal expected);
   with times as medians of chained launches (CUDA events);
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
   launches > 0; every kernel was launched;
5. dia_spmv (f32 and f64) against the plain version on the flagship's
   first Jacobian, at the tolerances of phase 3, timed beside
   torch.sparse.mm on the same matrix as a CUDA CSR tensor;
6. the same three small-box steps on the card and on the CPU (plain
   SpMV), which must agree as the CPU port agrees with the JAX package
   (rtol 2e-5, atol 2e-5);
7. the model run, with the kernel counts set to 0 just before and read
   just after: the flagship model written as a JSON file (mesh section
   128 x 64 x 64, f32 Jacobian and BiCGStab, adaptive stepping from
   1e5 s, 6 steps, a checkpoint at 2e4 s, output every 2nd step with
   the water flux) and run with no device named through cli.run_json
   where h5py imports, else through Simulation(config) + Timestepper
   with an in-memory output of the same write signature; the mesh
   comes from the config and the YAML log is written. Checks: the run
   is not aborted, 6 steps, output times increase and hold the
   checkpoint time, finite final state of 1,597,440 unknowns, dia_spmv
   launches = Krylov matvecs > 0, the log ends with timestepper end.
   Then the same JSON at 48 x 32 x 32 with BDF2 for 3 steps (checkpoint
   at 1e4 s), and the 5 x 4 x 3 box for 2 steps through the Timestepper
   on the card and on the CPU: the same tries and sizes, y within rtol
   2e-5, atol 2e-5;
8. the EOS models (eos_model_config: the flagship box and rock, Corey
   relative permeability, van Genuchten capillarity, a per-cell initial
   state, a top boundary holding the top layer's state, a deliverability
   producer near the top and a 20 kg/s injector low down), each written
   as a JSON file and run with no device named, the kernel counts set to
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
   Simulation(config) + Timestepper with the in-memory output and no
   device named, the kernel counts set to 0 just before and read just
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
   tries, y within rtol 2e-5, atol 2e-5, tracers within 1e-6 of max|x|.

Prints each bench section's wall time on its own line, then the model
runs' times and counts, the bench's full JSON record, one JSON line
{"kernels": [...]} (launches on the bench path, on the phase 7 model run,
over phase 8's card runs and on phase 9's full-size run) and the card's nvidia-smi name and power
limit; the last line is {"ok": true, "device": {...}}. Exits nonzero
without a CUDA device.
"""

from __future__ import annotations

import json
import os
import statistics
import sys
import tempfile
import time

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
           "flagship_spacing", "make_step", "model_config", "model_run",
           "run_steps"]

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


def _chain_ms(fn, k=20, reps=5):
    """Median over `reps` of the CUDA-event time of k chained calls,
    divided by k, in ms (one warm-up chain first)."""
    for _ in range(k):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(k):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / k)
    return statistics.median(times)


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
    """Kernel vs plain version on the card: dict of max_abs_err, ms,
    plain_ms, library_ms (torch.sparse.mm on the CSR form, or None),
    bound_ms and bound_by."""
    from waiwera_tpu_torch.ops import dia

    rtol = RTOL[m.bands.dtype]
    y = dia.dia_matvec(m, x)
    torch.cuda.synchronize()
    y_ref = dia.dia_matvec_reference(m, x)
    err = float((y - y_ref).abs().max())
    scale = float(y_ref.abs().max())
    torch.testing.assert_close(y, y_ref, rtol=rtol, atol=rtol * scale)
    ms = _chain_ms(lambda: dia.dia_matvec(m, x))
    plain_ms = _chain_ms(lambda: dia.dia_matvec_reference(m, x), k=5)
    lib_ms = None
    if library:
        csr = to_csr(m)
        xv = x.reshape(-1, 1)
        y_lib = torch.sparse.mm(csr, xv).reshape(x.shape)
        torch.testing.assert_close(y_lib, y_ref, rtol=rtol, atol=rtol * scale)
        lib_ms = _chain_ms(lambda: torch.sparse.mm(csr, xv))
        del csr
    nbytes, flops = spmv_work(m)
    bound, bound_by = _bound_ms(nbytes, flops, m.bands.dtype)
    log(f"spmv {label}: {m.bands.dtype} b {m.block_size} offsets "
        f"{m.offsets} n {m.num_rows} max_abs_err {err:.3e} (max|y| "
        f"{scale:.3e}) kernel {ms:.4f} ms plain {plain_ms:.4f} ms library "
        f"{lib_ms} ms bound {bound:.4f} ms ({bound_by})")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "library_ms": lib_ms, "bound_ms": bound, "bound_by": bound_by,
            "bytes": nbytes}


def compare_stream(log):
    """stream_scale vs x * 0.999999 on the card ([8, 8Mi] f32)."""
    from waiwera_tpu_torch.ops import stream

    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.rand((stream.N_SUB, stream.N_LANE), generator=gen,
                   device="cuda") + 0.5
    out = torch.empty_like(x)
    stream.stream_scale(x, out)
    torch.cuda.synchronize()
    ref = x * stream.SCALE
    bitwise = bool(torch.equal(out, ref))
    ulp = float(((out.view(torch.int32) - ref.view(torch.int32)).abs()
                 .max()))
    err = float((out - ref).abs().max())
    if ulp > 1:
        raise RuntimeError(f"stream_scale differs by {ulp} ulp")
    y = torch.empty_like(x)
    ms = _chain_ms(lambda: stream.stream_scale(x, out))
    plain_ms = _chain_ms(lambda: x * stream.SCALE)
    lib_ms = _chain_ms(lambda: torch.mul(x, stream.SCALE, out=y))
    nbytes = 2 * x.numel() * 4
    bound, bound_by = _bound_ms(nbytes, x.numel(), torch.float32)
    log(f"stream_scale [8, 8Mi] f32: bitwise equal {bitwise}, max ulp "
        f"{ulp:.0f}, kernel {ms:.4f} ms ({nbytes / ms / 1e6:.1f} GB/s) "
        f"plain {plain_ms:.4f} ms torch.mul(out=) {lib_ms:.4f} ms bound "
        f"{bound:.4f} ms")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "library_ms": lib_ms, "bound_ms": bound, "bound_by": bound_by,
            "bytes": nbytes, "bitwise_equal": bitwise}


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


def eos_initial_state(kind, nx, ny, nz):
    """(primary [n, npv], region [n]) of the EOS model `kind`, cells in
    the mesh's natural order (x fastest, the top layer last)."""
    st = EOS_STATES[kind]
    depth = (nz - 1 - np.arange(nz) + 0.5) * EOS_DZ  # per layer, from top
    p = st["p_top"] + st["density"] * 9.8 * (depth - 0.5 * EOS_DZ)
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


class MemoryOutput:
    """Output of a run kept in memory, for a machine without h5py: the
    write signature of sim/output.py HDF5Output; each record keeps the
    time, the interior pressures, the water flux, the source and network
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


def _h5py_imports() -> bool:
    try:
        import h5py  # noqa: F401
    except ImportError:
        return False
    return True


def model_run(workdir, size, method="beuler", steps=6, device=None,
              use_h5=None, log=log, checkpoint=CHECKPOINT, config=None,
              name=None, sim_hook=None):
    """Write the model JSON into workdir and run it through the port's
    entry points (device None: the CUDA device). The model is the
    flagship's model_config, or `config` (with checkpoint None where it
    has none). sim_hook(sim), where given, is called on the in-memory
    path's Simulation before the run. Returns (Timestepper, output times,
    wall seconds, which entry point ran); on the in-memory path the
    Timestepper's `output` is the MemoryOutput. Raises if the run
    aborted, took another number of
    steps, wrote times that do not increase or miss the checkpoint,
    ended in a non-finite state, or left a log that does not end with the
    timestepper's end."""
    from waiwera_tpu_torch import cli

    if config is None:
        config = model_config(*size, method=method, steps=steps,
                              checkpoint=checkpoint)
    name = name or f"model_{method}_{'x'.join(map(str, size))}"
    fn = os.path.join(workdir, name + ".json")
    with open(fn, "w") as f:
        json.dump(config, f)
    log_fn = os.path.join(workdir, name + ".yaml")
    if use_h5 is None:
        use_h5 = _h5py_imports()
    t0 = time.perf_counter()
    if use_h5:
        entry = "cli.run_json"
        ts = cli.run_json(fn, device=device, overrides=[
            "output.filename=" + json.dumps(os.path.join(workdir,
                                                         name + ".h5"))])
        import h5py

        with h5py.File(os.path.join(workdir, name + ".h5")) as f:
            times = np.asarray(f["time"])[:, 0].tolist()
            nflux = f["face_fields/flux_water"].shape
        if nflux != (len(times), ts.sim.mesh.num_faces):
            raise RuntimeError(f"flux_water has shape {nflux}")
    else:
        from waiwera_tpu_torch.sim.simulation import Simulation
        from waiwera_tpu_torch.sim.timestepper import Timestepper
        from waiwera_tpu_torch.utils.config import TrackedConfig
        from waiwera_tpu_torch.utils.logging import Logger

        entry = "Simulation + Timestepper (no h5py: in-memory output)"
        with open(fn) as f:
            config = TrackedConfig(json.load(f))
        sim = Simulation(config, device=device)
        if sim_hook is not None:
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
    syncs = st["host_syncs_step"] + st["host_syncs_timestepper"]
    refused = sum(not ok for _, ok in ts.tried)
    reductions = len([ln for ln in open(log_fn)
                      if "[warn, timestep, reduction" in ln])
    log(f"{name} through {entry}: wall {wall:.2f} s, run loop "
        f"{sum(st['step_seconds']):.2f} s, per accepted step "
        f"{[round(x, 3) for x in st['step_seconds']]} s, accepted sizes "
        f"{[s for s, _, _ in ts.accepted]}, tries {st['tries']} (refused "
        f"{refused}, logged reductions {reductions}), Newton "
        f"{st['newton_iterations']}, BiCGStab {st['linear_iterations']}, "
        f"matvecs {st['matvecs']}, host syncs per try "
        f"{syncs / st['tries']:.1f}"
        f" (of which the timestepper adds "
        f"{st['host_syncs_timestepper'] / st['tries']:.2f}), output "
        f"{st['output_seconds']:.3f} s over {len(times)} records at {times}")
    return ts, times, wall, entry


def check_bench(res, counts):
    """The main path's checks on the bench record and kernel counts."""
    op = res["operating_point"]
    if op["settle_accepted"] < 2:
        raise RuntimeError(f"flagship settle: {op['settle_accepted']} "
                           "accepted")
    if not op["y_finite"] or op["y_shape"] != [FLAGSHIP_ROWS, 3]:
        raise RuntimeError(f"flagship solution: finite {op['y_finite']}, "
                           f"shape {op['y_shape']}")
    # bjacobi sections: every Krylov matvec launched the kernel
    for key in ("operating_point", "reduced_operating_point",
                "minc_operating_point"):
        o = res[key]
        if o["spmv_launches"] <= 0 or o["spmv_launches"] != o["krylov_matvecs"]:
            raise RuntimeError(f"{key}: kernel launches {o['spmv_launches']} "
                               f"!= Krylov matvecs {o['krylov_matvecs']}")
    o = res["dtype_table"]["f64_operating_point"]
    if o["spmv_launches"] <= 0 or o["spmv_launches"] != o["krylov_matvecs"]:
        raise RuntimeError(f"f64 step: kernel launches {o['spmv_launches']}"
                           f" != Krylov matvecs {o['krylov_matvecs']}")
    if res["minc_spmv_path"] != "hybrid-dia":
        raise RuntimeError(f"MINC step took {res['minc_spmv_path']}")
    frac = res["spmv_roofline_fraction"]
    if not 0.0 < frac <= 1.05:
        raise RuntimeError(f"spmv_roofline_fraction {frac}")
    if not 0.0 < res["measured_bandwidth_gb_s"] < 1.05 * 3350.0:
        raise RuntimeError(f"measured bandwidth "
                           f"{res['measured_bandwidth_gb_s']} GB/s")
    for name, n in counts.items():
        if n <= 0:
            raise RuntimeError(f"kernel {name} was not launched on the "
                               "main path")


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
    launches summed over the phase's card runs)."""
    records = []
    total = {k: 0 for k in counters}
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
        del ts
        torch.cuda.empty_cache()
    # (d) the small default-EOS model on the card and on the CPU
    cfg = eos_model_config("we", 5, 4, 3, steps=3)
    pair = []
    for dev in (None, "cpu"):
        for c in counters.values():
            c.count = 0
        ts, _, _, _ = model_run(workdir, (5, 4, 3), steps=3, device=dev,
                                use_h5=False, log=lambda m: None,
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
    return records, total


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
    ts, _, wall, entry = model_run(workdir, FLAGSHIP, steps=3, use_h5=False,
                                   log=log, checkpoint=None, config=cfg,
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
                                use_h5=False, log=lambda m: None,
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


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available()"
                         " is false)")
    from waiwera_tpu_torch import bench
    from waiwera_tpu_torch.ops import cuda_build, dia, stream
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
    libs = cuda_build.build_all(["dia_spmv", "stream_scale"],
                                extra_flags=("-Xptxas=-v",))
    log(f"built {[os.path.relpath(p, ROOT) for p in libs]} in "
        f"{time.perf_counter() - t0:.2f} s")

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
              stream.stream_scale_launches):
        c.count = 0
    t0 = time.perf_counter()
    # no device named: the entry point takes the CUDA device by default.
    # The preconditioner sweep holds each pc for 2 accepted steps, not 4,
    # to leave the script's time to the model run of phase 7
    b = bench.Bench(emit=lambda r: None, log=log, sweep_settle=2)
    res = b.run()
    counts = {"dia_spmv": dia.dia_spmv_launches.count,
              "dia_spmv_f64": dia.dia_spmv_f64_launches.count,
              "stream_scale": stream.stream_scale_launches.count}
    log(f"main path (bench) {time.perf_counter() - t0:.2f} s; launches "
        f"{counts}")
    for name, s in res["section_seconds"].items():
        log(f"bench section {name}: {s:.3f} s")
    check_bench(res, counts)

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

    # 7. the model run: JSON file -> Simulation(config) -> Timestepper ->
    # output and log, no device named
    counters = {"dia_spmv": dia.dia_spmv_launches,
                "dia_spmv_f64": dia.dia_spmv_f64_launches,
                "stream_scale": stream.stream_scale_launches}
    for c in counters.values():
        c.count = 0
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as workdir:
        ts, _, run_wall, entry = model_run(workdir, FLAGSHIP)
        run_counts = {k: c.count for k, c in counters.items()}
        if ts.sim.device.type != "cuda":
            raise RuntimeError(f"the model run took {ts.sim.device}")
        if tuple(ts.final_y.shape) != (FLAGSHIP_ROWS, 3):
            raise RuntimeError(f"final state {tuple(ts.final_y.shape)}")
        if run_counts["dia_spmv"] <= 0 or \
                run_counts["dia_spmv"] != ts.stats["matvecs"]:
            raise RuntimeError(
                f"model run: kernel launches {run_counts['dia_spmv']} != "
                f"Krylov matvecs {ts.stats['matvecs']}")
        log(f"model run: {ts.final_y.numel()} unknowns, launches "
            f"{run_counts}, final time {ts.final_time:.6g} s")
        del ts
        tb, _, _, _ = model_run(workdir, bench.REDUCED, method="bdf2",
                                steps=3, checkpoint=CHECKPOINT_SMALL)
        del tb
        pair = []
        for dev in (None, "cpu"):
            tsm, _, _, _ = model_run(workdir, (5, 4, 3), steps=2, device=dev,
                                     use_h5=False, log=lambda m: None,
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
        f"flagship run {run_wall:.2f} s through {entry}")

    # 8. the EOS models: JSON files with their own EOS, thermodynamics
    # and curves through the port's entry points on the card
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as workdir:
        eos_records, eos_counts = eos_phase(workdir, counters)
    jac_s = {f"{r['run']} {r['eos']}": round(r["jacobian_parts_s"], 4)
             for r in eos_records}
    log(f"phase 8 (EOS models) {time.perf_counter() - t0:.2f} s; launches "
        f"{eos_counts}; jacobian_parts s {jac_s}")
    if eos_counts["dia_spmv_f64"] <= 0:
        raise RuntimeError("phase 8: dia_spmv_f64 was not launched")

    # 9. the production-field model: the source network, tracers and rock
    # controls at the flagship size through the port's entry points
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as workdir:
        net_record, net_counts = network_phase(workdir, counters)
    log(f"phase 9 (production field) {time.perf_counter() - t0:.2f} s; "
        f"launches {net_counts}")

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
            "launches_model_run": run_counts[name],
            "launches_eos_models": eos_counts[name],
            "launches_network_model": net_counts[name],
            "max_abs_err": k["max_abs_err"],
            "ms": k["ms"],
            "plain_ms": k["plain_ms"],
            "bound_ms": k["bound_ms"],
            "bound_by": k["bound_by"],
            "library_ms": k["library_ms"],
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
