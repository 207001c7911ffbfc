"""Krylov solvers: right-preconditioned BiCGStab with true-residual
restart rounds and restarted GMRES (counterpart of
waiwera_tpu/solver/krylov.py: bicgstab, gmres and the KSP-name dispatch
in solve).

The JAX loops are lax.while_loops on the device. Here the loops run in
Python and every convergence test copies one flag to the host: a host
sync. The syncs are counted in KrylovResult.host_syncs. Vectors are
[N, b]; dot products reduce over everything.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
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


# rows of an f32-stored basis cast to the solve dtype at a time, so that
# no full-precision copy of the basis is ever made
_BASIS_CHUNK = 8


def _basis_dot(V: torch.Tensor, k: int, w: torch.Tensor) -> torch.Tensor:
    """V[:k] @ w in w's dtype."""
    if V.dtype == w.dtype:
        return V[:k] @ w
    return torch.cat([V[i:min(i + _BASIS_CHUNK, k)].to(w.dtype) @ w
                      for i in range(0, k, _BASIS_CHUNK)])


def _basis_combine(V: torch.Tensor, k: int, c: torch.Tensor) -> torch.Tensor:
    """V[:k].T @ c in c's dtype."""
    if V.dtype == c.dtype:
        return V[:k].T @ c
    out = None
    for i in range(0, k, _BASIS_CHUNK):
        j = min(i + _BASIS_CHUNK, k)
        part = V[i:j].to(c.dtype).T @ c[i:j]
        out = part if out is None else out + part
    return out


def _hessenberg_lstsq(H: np.ndarray, beta: float, m: int):
    """(y, res): the least-squares solution of min ||beta e1 - H y|| for
    the [m+1, m] Hessenberg H by Givens rotations, and the residual norm
    after each column, res[j] = |g[j+1]| (the GMRES residual with j+1
    Arnoldi vectors), in f64 on the host, as the JAX package's
    smallblocks.hessenberg_lstsq_res does on the device."""
    g = np.zeros(m + 1)
    g[0] = beta
    res = np.zeros(m)
    R = np.array(H, np.float64)
    for j in range(m):
        a, b = R[j, j], R[j + 1, j]
        r = np.sqrt(a * a + b * b)
        big = r > 1e-300
        c = a / r if big else 1.0
        s = b / r if big else 0.0
        R[j], R[j + 1] = c * R[j] + s * R[j + 1], -s * R[j] + c * R[j + 1]
        g[j], g[j + 1] = c * g[j] + s * g[j + 1], -s * g[j] + c * g[j + 1]
        res[j] = abs(g[j + 1])
    y = np.zeros(m)
    for j in range(m - 1, -1, -1):
        rhs = g[j] - np.dot(R[j, j + 1:], y[j + 1:]) if j + 1 < m else g[j]
        y[j] = rhs / R[j, j] if abs(R[j, j]) > 1e-300 else 0.0
    return y, res


def gmres(
    matvec: Callable[[torch.Tensor], torch.Tensor],
    b: torch.Tensor,
    precond: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    rtol: float = DEFAULT_RTOL,
    atol: float = DEFAULT_ATOL,
    restart: int = 30,
    max_restarts: int = 40,
    basis_dtype: Optional[torch.dtype] = None,
) -> KrylovResult:
    """Right-preconditioned restarted GMRES(m) from x = 0.

    Arnoldi with two-pass classical Gram-Schmidt (CGS2) against the
    whole basis, as the JAX package does: each cycle takes all `restart`
    Arnoldi steps on the device with no host sync, then copies the
    [m+1, m] Hessenberg matrix to the host (one sync), solves its least
    squares there, and tests the true residual of the new iterate (one
    sync). That residual starts the next cycle, so a cycle costs m + 1
    operator applications.

    basis_dtype: storage dtype of the Arnoldi basis V [m+1, n], the
    solver's dominant workspace. With float32, H, the least squares and
    every update stay in b.dtype: rows of V are cast to b.dtype a few at
    a time where they meet a vector of b.dtype, the explicit form of the
    JAX package's mixed-dtype promotion."""
    if precond is None:
        precond = lambda v: v  # noqa: E731
    v_dtype = b.dtype if basis_dtype is None else basis_dtype
    syncs = 0
    matvecs = 0

    def A(v):
        nonlocal matvecs
        matvecs += 1
        return matvec(v)

    tiny = torch.finfo(b.dtype).tiny
    shape = b.shape
    n = b.numel()
    m = restart
    x = torch.zeros_like(b)
    tol = torch.clamp_min(rtol * _norm(b), atol)
    r = b - A(x)
    rnorm = _norm(r)
    syncs += 1
    tol_h, rnorm_h = torch.stack([tol, rnorm]).double().cpu().tolist()
    k = 0
    its = 0
    while rnorm_h > tol_h and k < max_restarts and np.isfinite(rnorm_h):
        V = b.new_zeros((m + 1, n), dtype=v_dtype)
        H = b.new_zeros((m + 1, m))
        beta = rnorm
        V[0] = (r.reshape(-1) / torch.where(beta != 0, beta, tiny)).to(
            v_dtype)
        for j in range(m):
            w = A(precond(V[j].reshape(shape).to(b.dtype))).reshape(-1)
            h1 = _basis_dot(V, j + 1, w)
            w = w - _basis_combine(V, j + 1, h1)
            h2 = _basis_dot(V, j + 1, w)
            w = w - _basis_combine(V, j + 1, h2)
            wnorm = torch.sqrt(w @ w)
            H[: j + 1, j] = h1 + h2
            H[j + 1, j] = wnorm
            V[j + 1] = (w / torch.where(wnorm > tiny, wnorm, 1.0)).to(v_dtype)
        syncs += 1
        host = torch.cat([H.reshape(-1), beta.reshape(1)]).double().cpu()
        y, res_profile = _hessenberg_lstsq(host[:-1].numpy().reshape(m + 1, m),
                                           float(host[-1]), m)
        y = torch.as_tensor(y, dtype=b.dtype, device=b.device)
        x = x + precond(_basis_combine(V, m, y).reshape(shape))
        # inner iterations of the cycle: the steps its residual profile
        # needed to reach tol (all m but in the last cycle)
        its += min(int(np.sum(res_profile > tol_h)) + 1, m)
        k += 1
        r = b - A(x)
        rnorm = _norm(r)
        syncs += 1
        rnorm_h = float(rnorm)
    converged = bool(rnorm_h <= tol_h and np.isfinite(rnorm_h))
    return KrylovResult(
        x=x, iterations=its, residual_norm=rnorm, converged=converged,
        host_syncs=syncs, matvecs=matvecs,
    )


_BICGSTAB = ("bcgs", "bicgstab")
_NOT_PORTED = ("lgmres", "bcgsl", "bicgstabl")


def require_ported(method: str) -> None:
    """Raise unless `method`, one of the reference's JSON linear-solver
    names (timestepper.F90:1725-1739), is ported: BiCGStab and GMRES
    are."""
    if method in _BICGSTAB or method == "gmres":
        return
    if method in _NOT_PORTED:
        raise NotImplementedError(
            f"linear solver {method!r} is not ported yet (ROADMAP A14)"
        )
    raise ValueError(f"unknown linear solver: {method!r}")


def solve(method: str, matvec, b, precond=None, rtol: float = DEFAULT_RTOL,
          max_iterations: int = 1000, restart: int = 30,
          basis_dtype: Optional[torch.dtype] = None) -> KrylovResult:
    """KSP-style dispatch by the reference's JSON linear-solver names.
    GMRES takes ceil(max_iterations / restart) cycles at most, as in the
    JAX package; basis_dtype acts on GMRES only."""
    require_ported(method)
    if method == "gmres":
        max_restarts = max(1, -(-int(max_iterations) // max(restart, 1)))
        return gmres(matvec, b, precond=precond, rtol=rtol, restart=restart,
                     max_restarts=max_restarts, basis_dtype=basis_dtype)
    return bicgstab(matvec, b, precond=precond, rtol=rtol,
                    max_iterations=max_iterations)
