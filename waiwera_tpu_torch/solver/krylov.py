"""Krylov solvers: right-preconditioned BiCGStab with true-residual
restart rounds, restarted GMRES, LGMRES and BiCGStab(l) (counterpart of
waiwera_tpu/solver/krylov.py, with the KSP-name dispatch in solve).

BiCGStab keeps its loop state on the device, as the JAX package's
lax.while_loops do: the iterations run in chunks of CHUNK, each
iteration's update masked by a device flag `active` (an iteration after
convergence changes nothing), and the host reads (active, k) once per
chunk and the round's flags once per round. Its pieces run through a
solver.program.Program: eagerly, or replayed as CUDA graphs inside a
Newton iteration. The other solvers' loops run in Python and copy a flag
to the host at every convergence test. The syncs are counted in
KrylovResult.host_syncs. Vectors are [N, b]; dot products reduce over
everything. reduce_sum combines the partial reductions of a
domain-decomposed vector across ranks (an all_reduce; the identity on
one device), so that every rank reads the same dots and takes the same
branches.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from waiwera_tpu_torch.solver.program import Program, distinct

DEFAULT_RTOL = 1e-5  # PETSc KSP default relative tolerance
DEFAULT_ATOL = 1e-50
MAX_ROUNDS = 3  # true-residual restart rounds
# BiCGStab iterations per chunk: one host read per chunk; a solve runs up
# to CHUNK - 1 masked iterations past its last (PERF.md §6 times 4, 8 and
# 16 on the card)
CHUNK = 8


class KrylovResult(NamedTuple):
    x: torch.Tensor
    iterations: int
    residual_norm: torch.Tensor  # 0-d
    converged: bool
    host_syncs: int
    matvecs: int  # operator applications the device ran, masked included
    masked_iterations: int = 0  # BiCGStab iterations run masked


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.dot(a.reshape(-1), b.reshape(-1))


def _identity(x: torch.Tensor) -> torch.Tensor:
    return x


class _BiCGOps(NamedTuple):
    """What the chunks of one solve share: the operator, the
    preconditioner, the right-hand side and the tolerance."""

    matvec: Callable
    precond: Callable
    b: torch.Tensor
    tol: torch.Tensor  # 0-d


class _BiCGState(NamedTuple):
    """BiCGStab's loop state, on the device."""

    x: torch.Tensor
    r: torch.Tensor
    r0: torch.Tensor  # shadow residual of the round
    p: torch.Tensor
    rho: torch.Tensor  # 0-d
    rn: torch.Tensor  # 0-d, recurrence residual norm
    k: torch.Tensor  # 0-d int64, iterations
    active: torch.Tensor  # 0-d bool: the next iteration runs
    rnorm: torch.Tensor  # 0-d, true residual norm at the last round test
    rnd: torch.Tensor  # 0-d int64, rounds ended
    go: torch.Tensor  # 0-d bool: a(nother) round runs


class _BiCGStab:
    """The pieces of one right-preconditioned BiCGStab solve, each a
    pure function of tensors with no host read; the iteration and round
    tests are those of the JAX package's cond and round_cond."""

    def __init__(self, rtol, atol, max_iterations, reduce_sum, chunk):
        self.rtol = rtol
        self.atol = atol
        self.max_iterations = max_iterations
        self.reduce_sum = reduce_sum
        self.chunk = chunk

    def norm(self, a):
        return torch.sqrt(self.reduce_sum(_dot(a, a)))

    def cond(self, rn, tol, k):
        return (rn > tol) & torch.isfinite(rn) & (k < self.max_iterations)

    def round_cond(self, rnorm, tol, k, rnd):
        return ((rnorm > tol) & torch.isfinite(rnorm) & (rnd < MAX_ROUNDS)
                & (k < self.max_iterations))

    def flags(self, st: _BiCGState, tol) -> torch.Tensor:
        """[active, k, go, converged] as int64: the host's one read."""
        conv = (st.rnorm <= tol) & torch.isfinite(st.rnorm)
        return torch.stack([st.active.long(), st.k, st.go.long(),
                            conv.long()])

    def start(self, setup, *args):
        """setup(*args) -> (matvec, precond, b); then the solve's start
        from x = 0, its first round's start and one chunk."""
        matvec, precond, b = setup(*args)
        if precond is None:
            precond = _identity
        tol = torch.clamp_min(self.rtol * self.norm(b), self.atol)
        ops = _BiCGOps(matvec, precond, b, tol)
        x = torch.zeros_like(b)
        rnorm = self.norm(b - matvec(x))
        k = torch.zeros((), dtype=torch.int64, device=b.device)
        st = _BiCGState(x=x, r=b, r0=b, p=b, rho=rnorm, rn=rnorm, k=k,
                        active=torch.zeros((), dtype=torch.bool,
                                           device=b.device),
                        rnorm=rnorm, rnd=torch.zeros_like(k),
                        go=self.round_cond(rnorm, tol, k, torch.zeros_like(k)))
        st, flags = self.restart(st, ops)
        return ops, distinct(st), flags

    def restart(self, st: _BiCGState, ops: _BiCGOps):
        """A round's start from the true residual (active only where
        st.go), then one chunk."""
        r = ops.b - ops.matvec(st.x)
        rr = self.reduce_sum(_dot(r, r))
        rn = torch.sqrt(rr)
        st = st._replace(r=r, r0=r, p=r, rho=rr, rn=rn,
                         active=st.go & self.cond(rn, ops.tol, st.k))
        return self.iterations(st, ops)

    def iterations(self, st: _BiCGState, ops: _BiCGOps):
        """One chunk: `chunk` iterations, each masked by st.active."""
        for _ in range(self.chunk):
            st = self.iterate(st, ops)
        return st, self.flags(st, ops.tol)

    def iterate(self, st: _BiCGState, ops: _BiCGOps) -> _BiCGState:
        tiny = torch.finfo(ops.b.dtype).tiny

        def safe(v):
            return torch.where(v != 0, v, tiny)

        reduce_sum = self.reduce_sum
        x, r, r0, p, rho = st.x, st.r, st.r0, st.p, st.rho
        phat = ops.precond(p)
        v = ops.matvec(phat)
        alpha = rho / safe(reduce_sum(_dot(r0, v)))
        s = r - alpha * v
        shat = ops.precond(s)
        t = ops.matvec(shat)
        # dots that share a reduction go in one (one all_reduce across
        # ranks)
        ts, tt = reduce_sum(torch.stack([_dot(t, s), _dot(t, t)]))
        omega = ts / safe(tt)
        x_new = x + alpha * phat + omega * shat
        r_new = s - omega * t
        rho_new, rr = reduce_sum(torch.stack([_dot(r0, r_new),
                                              _dot(r_new, r_new)]))
        beta = (rho_new / safe(rho)) * (alpha / safe(omega))
        p_new = r_new + beta * (p - omega * v)
        rn_new = torch.sqrt(rr)

        on = st.active

        def keep(new, old):
            return torch.where(on, new, old)

        k = st.k + on.long()
        rn = keep(rn_new, st.rn)
        return st._replace(
            x=keep(x_new, x), r=keep(r_new, r), p=keep(p_new, p),
            rho=keep(rho_new, rho), rn=rn, k=k,
            active=on & self.cond(rn, ops.tol, k),
        )

    def round_end(self, st: _BiCGState, ops: _BiCGOps):
        """The true residual at the end of a round, and the round test."""
        rnorm = self.norm(ops.b - ops.matvec(st.x))
        rnd = st.rnd + 1
        st = st._replace(rnorm=rnorm, rnd=rnd,
                         go=self.round_cond(rnorm, ops.tol, st.k, rnd))
        return st, self.flags(st, ops.tol)


def bicgstab_solve(program: Program, setup: Callable, *args,
                   rtol: float = DEFAULT_RTOL, atol: float = DEFAULT_ATOL,
                   max_iterations: int = 1000,
                   reduce_sum: Callable = _identity,
                   name: str = "bicgstab") -> KrylovResult:
    """Right-preconditioned BiCGStab for A x = b from x = 0, where
    (matvec, precond, b) = setup(*args) is evaluated inside the solve's
    first piece (so that a Newton iteration can put its Jacobian there).

    Each convergence-by-recurrence re-evaluates the TRUE residual
    b - A x and, if it is still above tol, restarts the recurrence from
    the current iterate with a fresh shadow vector (at most MAX_ROUNDS
    rounds), exactly as the JAX package does, so iteration counts and x
    match. Matvecs: 1 + 2 rounds + 2 (iterations + masked iterations),
    plus 1 when no round runs (the first round's start is computed with
    the solve's start). Host reads: one per chunk and one per round."""
    solver = _BiCGStab(rtol, atol, max_iterations, reduce_sum, CHUNK)
    K = solver.chunk
    syncs0 = program.host_syncs
    ops, st, flags = program.run(
        f"{name}.start", lambda *a: solver.start(setup, *a), *args)
    active, k, go, conv = program.read(flags)
    chunks, rounds, matvecs = 1, 0, 2 + 2 * K
    while go:
        while active:
            st, flags = program.loop(f"{name}.chunk", solver.iterations,
                                     st, ops)
            active, k, go, conv = program.read(flags)
            chunks += 1
            matvecs += 2 * K
        st, flags = program.loop(f"{name}.round_end", solver.round_end,
                                 st, ops)
        active, k, go, conv = program.read(flags)
        rounds += 1
        matvecs += 1
        if not go:
            break
        st, flags = program.loop(f"{name}.restart", solver.restart, st, ops)
        active, k, go, conv = program.read(flags)
        chunks += 1
        matvecs += 1 + 2 * K
    return KrylovResult(
        x=st.x, iterations=k, residual_norm=st.rnorm,
        converged=bool(conv), host_syncs=program.host_syncs - syncs0,
        matvecs=matvecs, masked_iterations=chunks * K - k,
    )


def bicgstab(
    matvec: Callable[[torch.Tensor], torch.Tensor],
    b: torch.Tensor,
    precond: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    rtol: float = DEFAULT_RTOL,
    atol: float = DEFAULT_ATOL,
    max_iterations: int = 1000,
    reduce_sum: Callable[[torch.Tensor], torch.Tensor] = _identity,
) -> KrylovResult:
    """Right-preconditioned BiCGStab for A x = b from x = 0, run eagerly
    (bicgstab_solve)."""
    return bicgstab_solve(
        Program(), lambda: (matvec, precond, b), rtol=rtol, atol=atol,
        max_iterations=max_iterations, reduce_sum=reduce_sum,
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
    reduce_sum: Callable[[torch.Tensor], torch.Tensor] = _identity,
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
    def norm(a):
        return torch.sqrt(reduce_sum(_dot(a, a)))

    tol = torch.clamp_min(rtol * norm(b), atol)
    r = b - A(x)
    rnorm = norm(r)
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
            h1 = reduce_sum(_basis_dot(V, j + 1, w))
            w = w - _basis_combine(V, j + 1, h1)
            h2 = reduce_sum(_basis_dot(V, j + 1, w))
            w = w - _basis_combine(V, j + 1, h2)
            wnorm = torch.sqrt(reduce_sum(w @ w))
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
        rnorm = norm(r)
        syncs += 1
        rnorm_h = float(rnorm)
    converged = bool(rnorm_h <= tol_h and np.isfinite(rnorm_h))
    return KrylovResult(
        x=x, iterations=its, residual_norm=rnorm, converged=converged,
        host_syncs=syncs, matvecs=matvecs,
    )


def lgmres(
    matvec: Callable[[torch.Tensor], torch.Tensor],
    b: torch.Tensor,
    precond: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    rtol: float = DEFAULT_RTOL,
    atol: float = DEFAULT_ATOL,
    restart: int = 30,
    augment: int = 2,
    max_restarts: int = 40,
    basis_dtype: Optional[torch.dtype] = None,
    reduce_sum: Callable[[torch.Tensor], torch.Tensor] = _identity,
) -> KrylovResult:
    """Loose GMRES (Baker, Jessup & Manteuffel 2005), PETSc's KSPLGMRES,
    the reference's linear type "lgmres" (timestepper.F90:1731-1734),
    right-preconditioned from x = 0.

    Each cycle's subspace is `restart - augment` Arnoldi directions plus
    the `augment` most recent approximate error vectors z_i = x_i -
    x_{i-1} (normalised, one per earlier cycle). Until the z buffer
    fills, plain Arnoldi directions stand in, so the first cycle is
    exactly GMRES(restart). Host syncs and matvecs as in gmres: one
    sync for the Hessenberg matrix and one for the true residual per
    cycle, restart + 1 operator applications per cycle.

    basis_dtype: storage dtype of the V and Q workspaces (see gmres);
    the z vectors, H and every update stay in b.dtype."""
    if precond is None:
        precond = lambda v: v  # noqa: E731
    k_aug = max(int(augment), 0)
    m = restart
    m_a = m - k_aug  # Arnoldi depth per cycle
    if m_a < 1:
        raise ValueError("lgmres restart must exceed augment")
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
    x = torch.zeros_like(b)
    def norm(a):
        return torch.sqrt(reduce_sum(_dot(a, a)))

    tol = torch.clamp_min(rtol * norm(b), atol)
    r = b - A(x)
    rnorm = norm(r)
    syncs += 1
    tol_h, rnorm_h = torch.stack([tol, rnorm]).double().cpu().tolist()
    Z = []  # the latest error directions, newest first, in b.dtype
    k = 0
    its = 0
    while rnorm_h > tol_h and k < max_restarts and np.isfinite(rnorm_h):
        V = b.new_zeros((m + 1, n), dtype=v_dtype)
        Q = b.new_zeros((m, n), dtype=v_dtype)  # the directions applied
        H = b.new_zeros((m + 1, m))
        beta = rnorm
        V[0] = (r.reshape(-1) / torch.where(beta != 0, beta, tiny)).to(
            v_dtype)
        for j in range(m):
            if j >= m_a and j - m_a < len(Z):
                q = Z[j - m_a]
            else:
                q = precond(V[j].reshape(shape).to(b.dtype)).reshape(-1)
            w = A(q.reshape(shape)).reshape(-1)
            h1 = reduce_sum(_basis_dot(V, j + 1, w))
            w = w - _basis_combine(V, j + 1, h1)
            h2 = reduce_sum(_basis_dot(V, j + 1, w))
            w = w - _basis_combine(V, j + 1, h2)
            wnorm = torch.sqrt(reduce_sum(w @ w))
            H[: j + 1, j] = h1 + h2
            H[j + 1, j] = wnorm
            V[j + 1] = (w / torch.where(wnorm > tiny, wnorm, 1.0)).to(v_dtype)
            Q[j] = q.to(v_dtype)
        syncs += 1
        host = torch.cat([H.reshape(-1), beta.reshape(1)]).double().cpu()
        y, res_profile = _hessenberg_lstsq(host[:-1].numpy().reshape(m + 1, m),
                                           float(host[-1]), m)
        y = torch.as_tensor(y, dtype=b.dtype, device=b.device)
        dx = _basis_combine(Q, m, y)  # Q already in solution space
        x = x + dx.reshape(shape)
        its += min(int(np.sum(res_profile > tol_h)) + 1, m)
        if k_aug > 0:
            dxn = torch.sqrt(reduce_sum(dx @ dx))
            Z = [dx / torch.where(dxn > tiny, dxn, 1.0)] + Z[: k_aug - 1]
        k += 1
        r = b - A(x)
        rnorm = norm(r)
        syncs += 1
        rnorm_h = float(rnorm)
    converged = bool(rnorm_h <= tol_h and np.isfinite(rnorm_h))
    return KrylovResult(
        x=x, iterations=its, residual_norm=rnorm, converged=converged,
        host_syncs=syncs, matvecs=matvecs,
    )


def bicgstab_l(
    matvec: Callable[[torch.Tensor], torch.Tensor],
    b: torch.Tensor,
    precond: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    rtol: float = DEFAULT_RTOL,
    atol: float = DEFAULT_ATOL,
    ell: int = 2,
    max_iterations: int = 1000,
    reduce_sum: Callable[[torch.Tensor], torch.Tensor] = _identity,
) -> KrylovResult:
    """BiCGStab(l) (Sleijpen & Fokkema 1993), PETSc's KSPBCGSL, the
    reference's linear type "bcgsl" (timestepper.F90:1735-1738), from
    x = 0.

    Each sweep does l BiCG steps and an l-dimensional minimal-residual
    polynomial update. Right preconditioning runs the sweep on op = A∘M
    and maps the accumulated update through M once at the end. The
    convergence test of the recurrence residual before each sweep is
    one host sync; a sweep is 2 l operator applications and counts l
    iterations, as in the JAX package."""
    if precond is None:
        precond = lambda v: v  # noqa: E731
    syncs = 0
    matvecs = 0

    def op(v):
        nonlocal matvecs
        matvecs += 1
        return matvec(precond(v))

    L = int(ell)
    tiny = torch.finfo(b.dtype).tiny

    def safe(v):
        return torch.where(torch.abs(v) > tiny, v, tiny)

    def dot(a, c):
        return reduce_sum(_dot(a, c))

    y = torch.zeros_like(b)  # accumulated update, preconditioned space
    rshadow = b
    tol = torch.clamp_min(rtol * torch.sqrt(dot(b, b)), atol)
    R = [b] + [torch.zeros_like(b) for _ in range(L)]
    U = [torch.zeros_like(b) for _ in range(L + 1)]
    one = b.new_ones(())
    rho0, alpha, omega = one, b.new_zeros(()), one
    rnorm = torch.sqrt(dot(b, b))
    k = 0
    while True:
        syncs += 1
        rnorm_h, tol_h = torch.stack([rnorm, tol]).double().cpu().tolist()
        if not (rnorm_h > tol_h and np.isfinite(rnorm_h)
                and k < max_iterations):
            break
        rho0 = -omega * rho0
        # BiCG part
        for j in range(L):
            rho1 = dot(R[j], rshadow)
            beta = alpha * rho1 / safe(rho0)
            rho0 = rho1
            for i in range(j + 1):
                U[i] = R[i] - beta * U[i]
            U[j + 1] = op(U[j])
            gamma = dot(U[j + 1], rshadow)
            alpha = rho0 / safe(gamma)
            for i in range(j + 1):
                R[i] = R[i] - alpha * U[i + 1]
            R[j + 1] = op(R[j])
            y = y + alpha * U[0]
        # MR part: modified Gram-Schmidt on R[1..L]
        tau = [[None] * (L + 1) for _ in range(L + 1)]
        sigma = [None] * (L + 1)
        gam_p = [None] * (L + 1)
        for j in range(1, L + 1):
            for i in range(1, j):
                tij = dot(R[j], R[i]) / safe(sigma[i])
                tau[i][j] = tij
                R[j] = R[j] - tij * R[i]
            sigma[j] = dot(R[j], R[j])
            gam_p[j] = dot(R[0], R[j]) / safe(sigma[j])
        gam = [None] * (L + 1)
        gam[L] = gam_p[L]
        omega = gam[L]
        for j in range(L - 1, 0, -1):
            gam[j] = gam_p[j] - sum(tau[j][i] * gam[i]
                                    for i in range(j + 1, L + 1))
        gam_pp = [None] * L
        for j in range(1, L):
            gam_pp[j] = gam[j + 1] + sum(tau[j][i] * gam[i + 1]
                                         for i in range(j + 1, L))
        y = y + gam[1] * R[0]
        R[0] = R[0] - gam_p[L] * R[L]
        U[0] = U[0] - gam[L] * U[L]
        for j in range(1, L):
            U[0] = U[0] - gam[j] * U[j]
            y = y + gam_pp[j] * R[j]
            R[0] = R[0] - gam_p[j] * R[j]
        k += L
        rnorm = torch.sqrt(dot(R[0], R[0]))
    converged = bool(rnorm_h <= tol_h and np.isfinite(rnorm_h))
    return KrylovResult(
        x=precond(y), iterations=k, residual_norm=rnorm,
        converged=converged, host_syncs=syncs, matvecs=matvecs,
    )


def solve(method: str, matvec, b, precond=None, rtol: float = DEFAULT_RTOL,
          max_iterations: int = 1000, restart: int = 30, augment: int = 2,
          ell: int = 2,
          basis_dtype: Optional[torch.dtype] = None,
          reduce_sum=_identity) -> KrylovResult:
    """KSP-style dispatch by the reference's JSON linear-solver names
    (timestepper.F90:1725-1739): bcgs/bicgstab, gmres, lgmres and
    bcgsl/bicgstabl. GMRES and LGMRES take ceil(max_iterations /
    restart) cycles at most, as in the JAX package; basis_dtype acts on
    those two only."""
    if method in ("bcgs", "bicgstab"):
        return bicgstab(matvec, b, precond=precond, rtol=rtol,
                        max_iterations=max_iterations, reduce_sum=reduce_sum)
    max_restarts = max(1, -(-int(max_iterations) // max(restart, 1)))
    if method == "gmres":
        return gmres(matvec, b, precond=precond, rtol=rtol, restart=restart,
                     max_restarts=max_restarts, basis_dtype=basis_dtype,
                     reduce_sum=reduce_sum)
    if method == "lgmres":
        return lgmres(matvec, b, precond=precond, rtol=rtol, restart=restart,
                      augment=augment, max_restarts=max_restarts,
                      basis_dtype=basis_dtype, reduce_sum=reduce_sum)
    if method in ("bcgsl", "bicgstabl"):
        return bicgstab_l(matvec, b, precond=precond, rtol=rtol, ell=ell,
                          max_iterations=max_iterations,
                          reduce_sum=reduce_sum)
    raise ValueError(f"unknown linear solver: {method!r}")
