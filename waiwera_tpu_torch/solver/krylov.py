"""Krylov solver: right-preconditioned BiCGStab with true-residual
restart rounds (counterpart of waiwera_tpu/solver/krylov.py: bicgstab
and the KSP-name dispatch in solve).

The JAX loops are lax.while_loops on the device. Here the loops run in
Python and every convergence test copies one flag to the host: a host
sync. The syncs are counted in KrylovResult.host_syncs. Vectors are
[N, b]; dot products reduce over everything.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

DEFAULT_RTOL = 1e-5  # PETSc KSP default relative tolerance
DEFAULT_ATOL = 1e-50
MAX_ROUNDS = 3  # true-residual restart rounds


class KrylovResult(NamedTuple):
    x: torch.Tensor
    iterations: int
    residual_norm: torch.Tensor  # 0-d
    converged: bool
    host_syncs: int
    matvecs: int  # operator applications


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.dot(a.reshape(-1), b.reshape(-1))


def _norm(a: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(_dot(a, a))


def bicgstab(
    matvec: Callable[[torch.Tensor], torch.Tensor],
    b: torch.Tensor,
    precond: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    rtol: float = DEFAULT_RTOL,
    atol: float = DEFAULT_ATOL,
    max_iterations: int = 1000,
) -> KrylovResult:
    """Right-preconditioned BiCGStab for A x = b from x = 0.

    Each convergence-by-recurrence re-evaluates the TRUE residual
    b - A x and, if it is still above tol, restarts the recurrence from
    the current iterate with a fresh shadow vector (at most MAX_ROUNDS
    rounds), exactly as the JAX package does, so iteration counts
    match."""
    if precond is None:
        precond = lambda v: v  # noqa: E731
    syncs = 0
    matvecs = 0

    def A(v):
        nonlocal matvecs
        matvecs += 1
        return matvec(v)

    def above_tol(rnorm) -> bool:
        # the one place a flag crosses to the host
        nonlocal syncs
        syncs += 1
        return bool((rnorm > tol) & torch.isfinite(rnorm))

    tiny = torch.finfo(b.dtype).tiny
    x = torch.zeros_like(b)
    tol = torch.clamp_min(rtol * _norm(b), atol)

    def safe(v):
        return torch.where(v != 0, v, tiny)

    k = 0
    rnd = 0
    rnorm = _norm(b - A(x))
    while k < max_iterations and rnd < MAX_ROUNDS and above_tol(rnorm):
        r = b - A(x)
        r0 = r
        p = r
        rho = _dot(r, r)
        rn = _norm(r)
        while k < max_iterations and above_tol(rn):
            phat = precond(p)
            v = A(phat)
            alpha = rho / safe(_dot(r0, v))
            s = r - alpha * v
            shat = precond(s)
            t = A(shat)
            omega = _dot(t, s) / safe(_dot(t, t))
            x = x + alpha * phat + omega * shat
            r = s - omega * t
            rho_new = _dot(r0, r)
            beta = (rho_new / safe(rho)) * (alpha / safe(omega))
            p = r + beta * (p - omega * v)
            rho = rho_new
            k += 1
            rn = _norm(r)
        rnorm = _norm(b - A(x))
        rnd += 1
    syncs += 1
    converged = bool((rnorm <= tol) & torch.isfinite(rnorm))
    return KrylovResult(
        x=x, iterations=k, residual_norm=rnorm, converged=converged,
        host_syncs=syncs, matvecs=matvecs,
    )


_BICGSTAB = ("bcgs", "bicgstab")
_NOT_PORTED = ("gmres", "lgmres", "bcgsl", "bicgstabl")


def require_ported(method: str) -> None:
    """Raise unless `method`, one of the reference's JSON linear-solver
    names (timestepper.F90:1725-1739), is ported: only BiCGStab is."""
    if method in _BICGSTAB:
        return
    if method in _NOT_PORTED:
        raise NotImplementedError(
            f"linear solver {method!r} is not ported yet (ROADMAP A14)"
        )
    raise ValueError(f"unknown linear solver: {method!r}")


def solve(method: str, matvec, b, precond=None, rtol: float = DEFAULT_RTOL,
          max_iterations: int = 1000) -> KrylovResult:
    """KSP-style dispatch by the reference's JSON linear-solver names.
    Only BiCGStab is ported."""
    require_ported(method)
    return bicgstab(matvec, b, precond=precond, rtol=rtol,
                    max_iterations=max_iterations)
