"""Passive tracers: the auxiliary linear problem (counterpart of
waiwera_tpu/sim/tracer.py; tracer.F90, flow_simulation.F90:1489-1959,
timestepper.F90:458-557).

Per accepted timestep, solves

    [c_Al Al - dt_eff Ar] x = b

where Al = diag(phi S_p rho_p) per tracer (cell.F90:146-164), Ar has
upstream-weighted advection by the per-phase mass fluxes of the
converged flow solution, harmonic-weighted diffusion (phi rho_p tau,
tau = S_p; cell.F90:168-201, face.F90:519-536), Arrhenius decay
(tracer.F90:48-61) and production sinks; b has injection sources and the
history terms:

  BE:   A = Al(1) - dt Ar(1);             b = Al(0) x(0) + dt br
  BDF2: A = (1+2r) Al(1) - dt (r+1) Ar(1)
        b = (r+1)^2 Al(0) x(0) - r^2 Al(-1) x(-1) + dt (r+1) br

Rows of cells where the tracer phase is absent are identity rows with a
zero right-hand side; Dirichlet boundary (ghost) rows hold the boundary
tracer value (flow_simulation.F90:1837-1959). The operator is
matrix-free: advection and diffusion are indexed face gathers and one
two-sided fixed-order scatter-sum (ops/segment.py) per application, in
the canonical face order of the flow solve's fluxes. It is solved with
GMRES and Jacobi on an exactly assembled diagonal (the reference's KSP
gmres/bjacobi, timestepper.F90:1840-1851). Tracers are one-way coupled
(flow -> tracer).
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional

import numpy as np
import torch

# GMRES basis memory cap: the Arnoldi workspace is [restart+1, N*nt]
# values; above this many bytes in the solve dtype the basis is stored in
# f32 (H and the updates stay in the solve dtype)
GMRES_BASIS_BYTES_CAP = 2**28
GMRES_RESTART = 30
# the auxiliary KSP's tolerance and iteration cap
RTOL = 1e-5
MAX_ITERATIONS = 1000

GAS_CONSTANT = 8.3144598  # J/mol/K (thermodynamics.F90:37-41)
TC_K = 273.15


def gmres_basis_dtype(num_dofs: int, itemsize: int):
    """torch.float32 when the full-precision Arnoldi basis would exceed
    the byte cap, else None (the solve dtype)."""
    if num_dofs * (GMRES_RESTART + 1) * itemsize > GMRES_BASIS_BYTES_CAP:
        return torch.float32
    return None


class TracerSet:
    """Tracer definitions (setup_tracers, tracer.F90:65-140)."""

    def __init__(self, cfg, eos):
        if isinstance(cfg, dict):
            cfg = [cfg]
        self.names: List[str] = []
        phase_index = []
        decay = []
        activation = []
        diffusion = []
        phase_names = [p.lower() for p in eos.phase_names]
        default_phase = getattr(eos, "default_tracer_phase", "liquid")
        for i, t in enumerate(cfg or []):
            self.names.append(t.get("name", f"tracer_{i}"))
            ph = str(t.get("phase", default_phase)).lower()
            if ph not in phase_names:
                raise ValueError(f"unknown tracer phase {ph!r}")
            phase_index.append(phase_names.index(ph))
            decay.append(float(t.get("decay", 0.0)))
            activation.append(float(t.get("activation", 0.0)))
            diffusion.append(float(t.get("diffusion", 0.0)))
        self.num_tracers = len(self.names)
        self.phase_index = np.asarray(phase_index, np.int64)
        self.decay_constant = np.asarray(decay, np.float64)
        self.activation = np.asarray(activation, np.float64)
        self.diffusion = np.asarray(diffusion, np.float64)
        self._cache = {}

    def _on(self, like: torch.Tensor):
        """(phase index, decay, activation, diffusion) on like's device,
        the floats in its dtype, copied once per (dtype, device)."""
        key = (like.dtype, like.device)
        hit = self._cache.get(key)
        if hit is None:
            def f(a):
                return torch.as_tensor(a, dtype=like.dtype,
                                       device=like.device)

            hit = self._cache[key] = (
                torch.as_tensor(self.phase_index, device=like.device),
                f(self.decay_constant), f(self.activation),
                f(self.diffusion))
        return hit

    def decay_rate(self, temperature: torch.Tensor) -> torch.Tensor:
        """[N, nt] Arrhenius decay rate (tracer.F90:48-61)."""
        _, decay, activation, _ = self._on(temperature)
        tk = temperature[:, None] + TC_K
        return decay * torch.exp(-activation / (GAS_CONSTANT * tk))


class TracerResult(NamedTuple):
    x: torch.Tensor  # [N, nt]
    al: torch.Tensor  # [N, nt] balance coefficients at the solve state
    converged: bool
    iterations: int
    host_syncs: int
    matvecs: int


def balance_coefs(tracers: TracerSet, fluid, rock) -> torch.Tensor:
    """[N, nt]: phi S_p rho_p for each tracer's phase."""
    p = tracers._on(fluid.pressure)[0]
    return rock.porosity[:, None] * fluid.saturation[:, p] \
        * fluid.density[:, p]


def operator(
    tracers: TracerSet,
    mesh,
    fluid,
    rock,
    fluxes: torch.Tensor,
    npv: int,
    al: torch.Tensor,
    c_al,
    dt_eff,
    b_hist: torch.Tensor,
    sources,
    source_rate: Optional[torch.Tensor],
    source_frac: Optional[torch.Tensor],
    tracer_injection: Optional[torch.Tensor],
    ghost_value: torch.Tensor,
    owned: Optional[torch.Tensor] = None,
    sync=None,
):
    """(a_matvec, precond, b) of one auxiliary solve: the matrix-free
    operator c_al Al - dt_eff Ar, Jacobi on its exact diagonal, and the
    right-hand side. c_al and dt_eff are numbers or 0-d tensors; nothing
    is read on the host, so a graph can hold it (the first piece of the
    tracer step's GMRES solve).

    mesh: MeshArrays (canonical face order, that of `fluxes`).
    al: balance_coefs at `fluid`, [N, nt].
    b_hist: the history part of b ([N, nt], method-dependent, computed by
    the caller from the last steps' balance coefficients and tracers).
    sources: the network's SourceArrays (cells and their scatter-sum), or
    None without sources.
    source_frac: [ns, nt] tracer-phase flow fractions at source cells.
    tracer_injection: [ns, nt] injection rates.
    ghost_value: [N, nt] Dirichlet values of the ghost rows.

    Distributed hooks (parallel/spmd.py): owned [N] masks the rows to
    the owning rank (halo rows stay zero through the Krylov iteration)
    and sync is the halo exchange applied inside the matvec before the
    face gathers. On one device both are left out."""
    n = mesh.num_cells
    nt = tracers.num_tracers
    area = mesh.face_area
    d12 = torch.where(mesh.face_distance12 > 0.0, mesh.face_distance12, 1.0)
    vol = torch.where(mesh.cell_volume > 0.0, mesh.cell_volume, 1.0)
    is_ghost = mesh.is_ghost

    def scatter2(va, vb):
        return mesh.face_sum.add(va.new_zeros((n,) + va.shape[1:]),
                                 torch.cat([va, vb]))

    pidx, _, _, diffusion = tracers._on(fluid.pressure)
    # per-face tracer-phase mass flux [F, nt]; upstream side by its sign
    pf = fluxes[:, npv:][:, pidx]
    up_is_l = pf >= 0.0
    adv = pf * area[:, None]  # [F, nt] mass flow
    # diffusion: harmonic phi rho tau (tau = S), times D / d12 * area
    dfac_cell = rock.porosity[:, None] * fluid.density[:, pidx] \
        * fluid.saturation[:, pidx]
    gather_l, gather_r = mesh.face_rows
    f1 = gather_l(dfac_cell)
    f2 = gather_r(dfac_cell)
    wsum = f1 + f2
    big = torch.abs(wsum) > 1e-30
    dfac = torch.where(big, 2.0 * f1 * f2 / torch.where(big, wsum, 1.0), 0.0)
    diff_k = area[:, None] * dfac * diffusion / d12[:, None]  # [F, nt]

    # decay and production diagonals, injection right-hand side
    decay_diag = -tracers.decay_rate(fluid.temperature) * al  # [N, nt]
    prod_diag = al.new_zeros((n, nt))
    brhs = al.new_zeros((n, nt))
    if sources is not None and sources.cell.shape[0] > 0:
        source_cell = sources.cell
        producing = source_rate < 0.0
        q_over_v = source_rate / vol[source_cell]
        prod_contrib = torch.where(producing[:, None],
                                   source_frac * q_over_v[:, None], 0.0)
        prod_diag = sources.cell_sum.add(prod_diag, prod_contrib)
        inj = torch.where(producing[:, None], 0.0,
                          tracer_injection / vol[source_cell][:, None])
        brhs = sources.cell_sum.add(brhs, inj)

    # tracer phase present? (the phase_composition bitmask)
    present = ((fluid.phase_composition[:, None].to(torch.int64)
                >> pidx[None, :]) & 1) > 0
    identity_row = (~present) | is_ghost[:, None]
    fixed = torch.where(is_ghost[:, None], ghost_value, 0.0)

    vol_l = gather_l(vol)[:, None]
    vol_r = gather_r(vol)[:, None]

    def ar_matvec(x):
        xl = gather_l(x)
        xr = gather_r(x)
        xu = torch.where(up_is_l, xl, xr)  # [F, nt] upstream value
        # advection (flow_simulation.F90:1664-1676) and diffusion
        # (:1677-1685) in one two-sided face scatter
        g = xr - xl
        va = (-adv * xu + diff_k * g) / vol_l
        vb = (adv * xu - diff_k * g) / vol_r
        return (decay_diag + prod_diag) * x + scatter2(va, vb)

    own = None if owned is None else owned[:, None]

    def a_matvec(x):
        xs = x if sync is None else sync(x)
        ax = c_al * al * xs - dt_eff * ar_matvec(xs)
        ax = torch.where(identity_row, xs, ax)
        return ax if own is None else torch.where(own, ax, 0.0)

    b = torch.where(identity_row, fixed, b_hist + dt_eff * brhs)
    if own is not None:
        b = torch.where(own, b, 0.0)

    # the exact diagonal, for Jacobi preconditioning
    va = (torch.where(up_is_l, -adv, 0.0) - diff_k) / vol_l
    vb = (torch.where(~up_is_l, adv, 0.0) - diff_k) / vol_r
    diag_ar = decay_diag + prod_diag + scatter2(va, vb)
    diag = torch.where(identity_row, 1.0, c_al * al - dt_eff * diag_ar)
    inv_diag = torch.where(torch.abs(diag) > 1e-300, 1.0 / diag, 1.0)

    def precond(v):
        return v * inv_diag

    return a_matvec, precond, b
