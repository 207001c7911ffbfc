"""Newton solver with phase transitions (counterpart of
waiwera_tpu/solver/newton.py).

Same semantics as the JAX package:
- residual convergence: max_i |r_i| / max(|L_last_i|, f_atol) < f_rtol
  (SNES_convergence, timestepper.F90:1898-1951)
- update convergence: max_i |dy_i| / max(|y_i|, u_atol) <= u_rtol
- minimum-iterations gate; failure on EOS domain errors, transition or
  bounds errors, linear-solver failure, non-finite or diverging norms
- full-step update followed by region transitions and the primary
  bounds check (flow_simulation_fluid_transitions)

The JAX package runs the loop as one lax.while_loop on the device. Here
the host runs it over device-only pieces (solver/program.py), each
ending in flags the host reads once:
- (a) the start: the residual at y0 and its flags (one read);
- (b) the Jacobian parts, the operator and the preconditioner (the
  piece newton.jacobian, no read), then (c) the Krylov solve on them:
  its start with the first BiCGStab chunk, the further chunks and rounds
  (one read per chunk and per round; krylov.bicgstab_solve);
- (d) the update, transitions, bounds check, the residual at the new
  iterate and the convergence and failure flags (one read per
  iteration).
The monitor's values ride on the reads. GMRES and LGMRES take (c) as
their start and cycle pieces (krylov.gmres_solve,
krylov.lgmres_solve: one read at the start and one per cycle),
BiCGStab(l) as its start and chunk pieces (krylov.bicgstab_l_solve: one
read at the start and one per chunk). A Program runs the pieces eagerly
or replays them as CUDA graphs (Simulation.make_step_fn picks it from
the configuration, program_covers: every linear method and
preconditioner on one rank). The host syncs are counted in
NewtonResult.host_syncs. Under a profiler the host loop is the span
newton.solve (utils/spans.py).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from waiwera_tpu_torch.solver import krylov
from waiwera_tpu_torch.solver.program import Program, distinct
from waiwera_tpu_torch.solver.system import MethodCoeffs, System
from waiwera_tpu_torch.utils.spans import span


# what a graph program covers: the linear methods whose loops run as
# device pieces (by the reference's KSP names and their aliases) and the
# preconditioners whose set-up and application hold no host read: every
# name System.linear_operator_from_parts and precond.make_preconditioner
# take, on every route
GRAPH_METHODS = ("bcgs", "bicgstab", "gmres", "lgmres", "bcgsl",
                 "bicgstabl")
GRAPH_PCS = ("none", "jacobi", "bjacobi", "asm", "ilu", "dilu", "sgs",
             "line", "zline", "cpr", "cprmg", "lu")


class NewtonParams(NamedTuple):
    """Defaults follow timestepper.F90:1567,1998-2002."""

    max_iterations: int = 8
    min_iterations: int = 0
    function_rtol: float = 1e-5
    function_atol: float = 1.0
    update_rtol: float = 1e-10
    update_atol: float = 1.0
    divergence_tol: float = 1e8  # SNES dtol
    linear_method: str = "bcgs"
    linear_pc: str = "bjacobi"
    linear_rtol: float = 1e-5
    linear_max_iterations: int = 1000
    linear_restart: int = 30  # gmres/lgmres subspace size
    linear_augment: int = 2  # lgmres augmentation depth (PETSc default)
    linear_ell: int = 2  # bcgsl polynomial degree (PETSc default)
    pc_sweeps: int = 3  # fixed-point sweeps per triangular solve (DILU)
    # per-iteration nonlinear monitor (SNES_monitor,
    # timestepper.F90:1855-1894): prints iteration, scaled residual norm,
    # worst cell and worst equation, one host sync per report
    monitor: bool = False
    # precision of the inner Krylov solve and of the Jacobian tangent
    # chain; the residual and the convergence tests stay f64
    linear_dtype: str = "float64"
    jacobian_dtype: str = "float64"


_F32_NAMES = ("float32", "f32", "single")
_F64_NAMES = ("float64", "f64", "double")


def _resolve_dtype(name: str, what: str):
    if name in _F32_NAMES:
        return torch.float32
    if name in _F64_NAMES:
        return torch.float64
    raise ValueError(
        f"unknown {what} {name!r}: expected one of "
        f"{_F32_NAMES + _F64_NAMES}"
    )


class NewtonResult(NamedTuple):
    y: torch.Tensor  # [N, npv] solution (scaled primaries)
    region: torch.Tensor  # [N] int32 final thermodynamic regions
    iterations: int
    converged: bool
    failed: bool  # domain / linear-solver failure
    max_residual: torch.Tensor  # 0-d, last scaled residual norm
    linear_iterations: int  # total
    worst_cell: torch.Tensor  # 0-d, cell of the largest scaled residual
    worst_equation: torch.Tensor  # 0-d, its equation
    host_syncs: int  # flags copied to the host during the solve
    matvecs: int  # Krylov operator applications, total (masked included)
    # state at the final iterate
    fluid: object = None  # FluidState
    lhs: torch.Tensor = None  # [N, npv] balances at y
    fluxes: torch.Tensor = None  # [F, nflux] face fluxes at y
    masked_iterations: int = 0  # BiCGStab iterations run masked, total


class _State(NamedTuple):
    """Newton's loop state at the current iterate, on the device."""

    y: torch.Tensor
    region: torch.Tensor
    temperature: torch.Tensor
    r: torch.Tensor  # f64 residual, zero in ghost rows
    fluid: object  # FluidState
    lhs: torch.Tensor
    fluxes: torch.Tensor
    maxres: torch.Tensor  # 0-d scaled residual norm
    worst_cell: torch.Tensor
    worst_equation: torch.Tensor


class _Newton:
    """The device-only pieces of newton_solve."""

    def __init__(self, system: System, params: NewtonParams):
        self.system = system
        self.params = params
        self.linear_dtype = _resolve_dtype(params.linear_dtype,
                                           "linear_dtype")
        self.jacobian_dtype = _resolve_dtype(params.jacobian_dtype,
                                             "jacobian_dtype")
        if self.jacobian_dtype == torch.float32:
            # an f32 Jacobian cannot back an f64 Krylov solve
            self.linear_dtype = torch.float32

    def any_err(self, e):
        system = self.system
        return system.reduce_any(torch.any(e & system.interior_mask))

    def scaled(self, v, scale, tol):
        s = torch.clamp_min(torch.abs(scale), tol)
        return torch.where(self.system.interior_mask[:, None],
                           torch.abs(v) / s, 0.0)

    def max_scaled_loc(self, v, scale, tol):
        # the largest scaled component over the ranks, and its natural
        # cell and equation, reported by the rank that holds it
        system = self.system
        npv = system.npv
        vals = self.scaled(v, scale, tol).reshape(-1)
        idx = torch.argmax(vals)
        # a gather: indexing by a 0-d tensor reads the index on the host
        m = vals.gather(0, idx.reshape(1)).reshape(())
        gm = system.reduce_max(m)
        has_max = m >= gm
        wc = system.reduce_max(torch.where(
            has_max, system.to_global_cell(idx // npv), -1))
        we = system.reduce_max(torch.where(has_max, idx % npv, -1))
        return gm, wc, we

    def fnorm_of(self, r):
        return torch.sqrt(self.system.reduce_sum(torch.sum(r * r)))

    def residual(self, y, region, rock, coeffs, t0, t1):
        system = self.system
        fluid, cond, err = system.derived_state(y, region, rock)
        L = system.lhs(fluid, rock)
        R, fx = system.rhs(fluid, cond, rock, t0, t1)
        r = coeffs.c_lhs * L + coeffs.const - coeffs.dt_eff * R
        # ghost rows of the Krylov right-hand side are zero
        r = torch.where(system.interior_mask[:, None], r, 0.0)
        return r, fluid, L, fx, err

    def start(self, y0, region0, temperature0, rock, coeffs, t0, t1,
              lhs_scale, initial):
        """(a): the residual at y0, the state and the flags [converged,
        failed] (+ the monitor's maxres, cell, equation)."""
        p = self.params
        if initial is not None:
            fluid, L, fx = initial
            r = self.system.residual_from_state(fluid, L, fx, coeffs, t0, t1)
            r = torch.where(self.system.interior_mask[:, None], r, 0.0)
            err0 = ~torch.isfinite(L).all(dim=1)
        else:
            r, fluid, L, fx, err0 = self.residual(y0, region0, rock, coeffs,
                                                  t0, t1)
        fnorm0 = self.fnorm_of(r)
        maxres, wc, we = self.max_scaled_loc(r, lhs_scale, p.function_atol)
        flags = [(p.min_iterations <= 0) & (maxres < p.function_rtol),
                 self.any_err(err0) | ~torch.isfinite(fnorm0)]
        if p.monitor:
            flags += [maxres, wc, we]
        # the state owns its tensors (copies where they are inputs): a
        # graph writes the next iterate into them
        inputs = (y0, region0, temperature0, lhs_scale, initial)
        st = distinct((inputs, _State(y0, region0, temperature0, r, fluid,
                                      L, fx, maxres, wc, we)))[1]
        return fnorm0, st, _flags(flags)

    def operator(self, st: _State, rock, coeffs, t0, t1):
        """(b): (matvec, preconditioner, right-hand side) at st."""
        system, p = self.system, self.params
        parts = system.jacobian_parts(
            st.y, st.region, rock, coeffs, t0, t1,
            tangent_dtype=self.jacobian_dtype)
        mv, pc = system.linear_operator_from_parts(
            parts, p.linear_pc, dtype=self.linear_dtype, sweeps=p.pc_sweeps)
        return mv, pc, st.r.to(self.linear_dtype)

    def update(self, st: _State, x, rock, coeffs, t0, t1, lhs_scale,
               fnorm0):
        """(d): the iterate y - x after transitions and the bounds check,
        its residual, and the flags [failed, converged] (+ the monitor's
        maxres, maxupd, cell, equation)."""
        system, p = self.system, self.params
        eos = system.eos
        y, region = st.y, st.region
        # halo slots of the solution are not solved locally: pull them
        # from their owners before the pointwise update
        y_raw = y - system.sync(x.to(y.dtype))
        old_primary = eos.unscale(y, region)
        primary_raw = eos.unscale(y_raw, region)
        new_primary, new_region, _, terr = eos.transition(
            old_primary, primary_raw, region, st.temperature)
        new_primary, bounds_err = eos.check_primary_variables(
            new_primary, new_region)
        y_new = eos.scale(new_primary, new_region)
        # ghost rows never move (halo copies of remote cells do, as on
        # their owner: the same per-cell transition on synced inputs)
        update = system.update_mask
        y_new = torch.where(update[:, None], y_new, y)
        new_region = torch.where(update, new_region, region)

        r, fluid, L, fx, perr = self.residual(y_new, new_region, rock,
                                              coeffs, t0, t1)
        maxres, wc, we = self.max_scaled_loc(r, lhs_scale, p.function_atol)
        maxupd = system.reduce_max(
            torch.max(self.scaled(y - y_new, y_new, p.update_atol)))
        fnorm = self.fnorm_of(r)
        flags = [
            self.any_err(terr) | self.any_err(bounds_err)
            | self.any_err(perr) | ~torch.isfinite(fnorm)
            | (fnorm > p.divergence_tol * torch.clamp_min(fnorm0, 1e-300)),
            (maxres < p.function_rtol) | (maxupd <= p.update_rtol),
        ]
        if p.monitor:
            flags += [maxres, maxupd, wc, we]
        new = _State(y_new, new_region, fluid.temperature, r, fluid, L, fx,
                     maxres, wc, we)
        return new, _flags(flags)


def _flags(values) -> torch.Tensor:
    """Flags and monitor values in one f64 vector: one host read."""
    return torch.stack([v.to(torch.float64) for v in values])


def program_covers(system: System, params: "NewtonParams") -> bool:
    """Whether every piece of a try under `params` can run as a CUDA
    graph: a one-rank System, a linear method of GRAPH_METHODS and a
    preconditioner of GRAPH_PCS. A distributed System runs eagerly (its
    collectives: ROADMAP A18.5)."""
    return (not system.distributed
            and params.linear_method in GRAPH_METHODS
            and params.linear_pc in GRAPH_PCS)


def _operator_of(matvec, precond, b):
    """The Krylov set-up of a Newton iteration, as the piece
    newton.jacobian computed it."""
    return matvec, precond, b


def _linear_solve(program, newton, st, rock, coeffs, t0, t1):
    """(b) and (c): the piece newton.jacobian (newton.operator: the
    Jacobian, the operator and the preconditioner), then the Krylov solve
    of one Newton iteration as pieces on what it returned. No host read
    sits between the two, so the solve's first piece is queued while the
    Jacobian runs."""
    system, p = newton.system, newton.params
    kw = dict(rtol=p.linear_rtol, reduce_sum=system.reduce_sum,
              name="newton.krylov")
    args = program.run("newton.jacobian", newton.operator, st, rock, coeffs,
                       t0, t1)
    method = p.linear_method
    if method in ("bcgs", "bicgstab"):
        return krylov.bicgstab_solve(
            program, _operator_of, *args,
            max_iterations=p.linear_max_iterations, **kw)
    if method in ("bcgsl", "bicgstabl"):
        return krylov.bicgstab_l_solve(
            program, _operator_of, *args, ell=p.linear_ell,
            max_iterations=p.linear_max_iterations, **kw)
    max_restarts = krylov.max_restarts(p.linear_max_iterations,
                                       p.linear_restart)
    if method == "gmres":
        return krylov.gmres_solve(
            program, _operator_of, *args, restart=p.linear_restart,
            max_restarts=max_restarts, **kw)
    if method == "lgmres":
        return krylov.lgmres_solve(
            program, _operator_of, *args, restart=p.linear_restart,
            augment=p.linear_augment, max_restarts=max_restarts, **kw)
    raise ValueError(f"unknown linear solver: {method!r}")


def newton_solve(
    system: System,
    y0: torch.Tensor,
    region0: torch.Tensor,
    temperature0: torch.Tensor,
    rock,
    coeffs: MethodCoeffs,
    t0,
    t1,
    lhs_scale: torch.Tensor,
    params: NewtonParams = NewtonParams(),
    initial=None,
    program: Optional[Program] = None,
) -> NewtonResult:
    """Solve r(y) = 0 from y0.

    lhs_scale: the balances at the last accepted step, which scale the
    residual norm. temperature0: fluid temperature at y0 (for the
    transition fallbacks). initial: optional (fluid0, lhs0, fluxes0)
    evaluated at exactly (y0, region0, rock); the pre-loop residual
    then re-evaluates only the source inflows. A cell whose carried
    balances are not finite counts as a domain error.

    t0, t1: 0-d tensors or numbers. program: runs the pieces (default:
    eagerly); in graph mode every tensor argument must be the program's
    own (Program.stage), and the result's tensors are copies out of its
    pool."""
    if program is None:
        program = Program()
    if program.mode != "eager" and not program_covers(system, params):
        why = ("a distributed System runs eagerly only"
               if system.distributed else "unknown to the port")
        raise ValueError(
            f"graph program: linear method {params.linear_method!r} with "
            f"preconditioner {params.linear_pc!r}: {why}")
    with span("newton.solve"):
        newton = _Newton(system, params)
        p = params
        syncs0 = program.host_syncs
        fnorm0, st, flags = program.run(
            "newton.start", newton.start, y0, region0, temperature0, rock,
            coeffs, t0, t1, lhs_scale, initial)
        f = program.read(flags)
        converged, failed = f[0] > 0.5, f[1] > 0.5
        if p.monitor:
            print(f"newton it 0: maxres {f[2]:.6e} worst cell {int(f[3])} "
                  f"eq {int(f[4])}")

        it = 0
        linear_its = 0
        matvecs = 0
        masked = 0
        while not converged and not failed and it < p.max_iterations:
            lin = _linear_solve(program, newton, st, rock, coeffs, t0, t1)
            matvecs += lin.matvecs
            masked += lin.masked_iterations
            st, flags = program.loop("newton.update", newton.update, st,
                                     lin.x, rock, coeffs, t0, t1, lhs_scale,
                                     fnorm0)
            f = program.read(flags)
            it += 1
            linear_its += lin.iterations
            if p.monitor:
                print(f"newton it {it}: maxres {f[2]:.6e} maxupd "
                      f"{f[3]:.3e} worst cell {int(f[4])} eq {int(f[5])} "
                      f"linear its {lin.iterations}")
            failed = failed or f[0] > 0.5 or not lin.converged
            converged = (it >= p.min_iterations and f[1] > 0.5
                         and not failed)

        out = program.hand_out((st.y, st.region, st.maxres,
                                st.worst_cell, st.worst_equation, st.fluid,
                                st.lhs, st.fluxes))
        y, region, maxres, wc, we, fluid, L, fx = out
        return NewtonResult(
            y=y,
            region=region,
            iterations=it,
            converged=converged,
            failed=failed,
            max_residual=maxres,
            linear_iterations=linear_its,
            worst_cell=wc,
            worst_equation=we,
            host_syncs=program.host_syncs - syncs0,
            matvecs=matvecs,
            fluid=fluid,
            lhs=L,
            fluxes=fx,
            masked_iterations=masked,
        )
