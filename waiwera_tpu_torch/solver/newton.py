"""Newton solver with phase transitions (counterpart of
waiwera_tpu/solver/newton.py), as a Python loop.

Same semantics as the JAX package:
- residual convergence: max_i |r_i| / max(|L_last_i|, f_atol) < f_rtol
  (SNES_convergence, timestepper.F90:1898-1951)
- update convergence: max_i |dy_i| / max(|y_i|, u_atol) <= u_rtol
- minimum-iterations gate; failure on EOS domain errors, transition or
  bounds errors, linear-solver failure, non-finite or diverging norms
- full-step update followed by region transitions and the primary
  bounds check (flow_simulation_fluid_transitions)

Each iteration's convergence test is one host sync (counted, with the
Krylov solver's, in NewtonResult.host_syncs); the monitor's report, when
it is on, is one more per iteration and one before the loop.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from waiwera_tpu_torch.solver import krylov
from waiwera_tpu_torch.solver.system import MethodCoeffs, System


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
    matvecs: int  # Krylov operator applications, total
    # state at the final iterate
    fluid: object = None  # FluidState
    lhs: torch.Tensor = None  # [N, npv] balances at y
    fluxes: torch.Tensor = None  # [F, nflux] face fluxes at y


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
) -> NewtonResult:
    """Solve r(y) = 0 from y0.

    lhs_scale: the balances at the last accepted step, which scale the
    residual norm. temperature0: fluid temperature at y0 (for the
    transition fallbacks). initial: optional (fluid0, lhs0, fluxes0)
    evaluated at exactly (y0, region0, rock); the pre-loop residual
    then re-evaluates only the source inflows. A cell whose carried
    balances are not finite counts as a domain error."""
    eos = system.eos
    interior = system.interior_mask
    npv = system.npv
    syncs = 0

    def to_host(*flags: torch.Tensor):
        nonlocal syncs
        syncs += 1
        return [bool(f) for f in torch.stack(flags).cpu()]

    def any_err(e):
        return torch.any(e & interior)

    def max_scaled(v, scale, tol):
        s = torch.clamp_min(torch.abs(scale), tol)
        return torch.where(interior[:, None], torch.abs(v) / s, 0.0)

    def max_scaled_loc(v, scale, tol):
        vals = max_scaled(v, scale, tol).reshape(-1)
        idx = torch.argmax(vals)
        return vals[idx], idx // npv, idx % npv

    def fnorm_of(r):
        return torch.sqrt(torch.sum(r * r))

    if initial is not None:
        fluid, L, fx = initial
        r = system.residual_from_state(fluid, L, fx, coeffs, t0, t1)
        err0 = ~torch.isfinite(L).all(dim=1)
    else:
        fluid, cond, err0 = system.derived_state(y0, region0, rock)
        L = system.lhs(fluid, rock)
        R, fx = system.rhs(fluid, cond, rock, t0, t1)
        r = coeffs.c_lhs * L + coeffs.const - coeffs.dt_eff * R
    # ghost rows of the Krylov right-hand side are zero
    r = torch.where(interior[:, None], r, 0.0)
    fnorm0 = fnorm_of(r)
    maxres, wc, we = max_scaled_loc(r, lhs_scale, params.function_atol)
    converged, failed = to_host(
        (params.min_iterations <= 0) & (maxres < params.function_rtol),
        any_err(err0) | ~torch.isfinite(fnorm0),
    )
    if params.monitor:
        syncs += 1
        r_h, c_h, e_h = torch.stack([maxres, wc.to(maxres.dtype),
                                     we.to(maxres.dtype)]).cpu().tolist()
        print(f"newton it 0: maxres {r_h:.6e} worst cell {int(c_h)} "
              f"eq {int(e_h)}")

    linear_dtype = _resolve_dtype(params.linear_dtype, "linear_dtype")
    jacobian_dtype = _resolve_dtype(params.jacobian_dtype, "jacobian_dtype")
    if jacobian_dtype == torch.float32:
        # an f32 Jacobian cannot back an f64 Krylov solve
        linear_dtype = torch.float32

    y, region, temperature = y0, region0, temperature0
    it = 0
    linear_its = 0
    matvecs = 0
    while not converged and not failed and it < params.max_iterations:
        parts = system.jacobian_parts(
            y, region, rock, coeffs, t0, t1, tangent_dtype=jacobian_dtype
        )
        mv, pc = system.linear_operator_from_parts(
            parts, params.linear_pc, dtype=linear_dtype
        )
        lin = krylov.solve(
            params.linear_method, mv, r.to(linear_dtype), precond=pc,
            rtol=params.linear_rtol,
            max_iterations=params.linear_max_iterations,
            restart=params.linear_restart,
            augment=params.linear_augment,
            ell=params.linear_ell,
        )
        syncs += lin.host_syncs
        matvecs += lin.matvecs
        y_raw = y - lin.x.to(y.dtype)

        # transitions + primary bounds
        old_primary = eos.unscale(y, region)
        primary_raw = eos.unscale(y_raw, region)
        new_primary, new_region, _, terr = eos.transition(
            old_primary, primary_raw, region, temperature
        )
        new_primary, bounds_err = eos.check_primary_variables(
            new_primary, new_region
        )
        y_new = eos.scale(new_primary, new_region)
        # ghost rows never move
        y_new = torch.where(interior[:, None], y_new, y)
        new_region = torch.where(interior, new_region, region)

        # residual at the updated iterate
        fluid, cond, perr = system.derived_state(y_new, new_region, rock)
        L = system.lhs(fluid, rock)
        R, fx = system.rhs(fluid, cond, rock, t0, t1)
        r = coeffs.c_lhs * L + coeffs.const - coeffs.dt_eff * R
        r = torch.where(interior[:, None], r, 0.0)

        it += 1
        linear_its += lin.iterations
        maxres, wc, we = max_scaled_loc(r, lhs_scale, params.function_atol)
        maxupd = torch.max(max_scaled(y - y_new, y_new, params.update_atol))
        fnorm = fnorm_of(r)
        if params.monitor:
            syncs += 1
            r_h, u_h, c_h, e_h = torch.stack([
                maxres, maxupd, wc.to(maxres.dtype), we.to(maxres.dtype),
            ]).cpu().tolist()
            print(f"newton it {it}: maxres {r_h:.6e} maxupd {u_h:.3e} "
                  f"worst cell {int(c_h)} eq {int(e_h)} linear its "
                  f"{lin.iterations}")
        failed_now, conv_now = to_host(
            any_err(terr) | any_err(bounds_err) | any_err(perr)
            | ~torch.isfinite(fnorm)
            | (fnorm > params.divergence_tol * torch.clamp_min(fnorm0, 1e-300)),
            (maxres < params.function_rtol) | (maxupd <= params.update_rtol),
        )
        failed = failed or failed_now or not lin.converged
        converged = (
            it >= params.min_iterations and conv_now and not failed
        )
        y, region, temperature = y_new, new_region, fluid.temperature

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
        host_syncs=syncs,
        matvecs=matvecs,
        fluid=fluid,
        lhs=L,
        fluxes=fx,
    )
