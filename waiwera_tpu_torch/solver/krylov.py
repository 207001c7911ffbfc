"""Krylov solvers: right-preconditioned BiCGStab with true-residual
restart rounds, restarted GMRES, LGMRES and BiCGStab(l) (counterpart of
waiwera_tpu/solver/krylov.py, with the KSP-name dispatch in solve).

BiCGStab keeps its loop state on the device, as the JAX package's
lax.while_loops do: the iterations run in chunks of CHUNK, each
iteration's update masked by a device flag `active` (an iteration after
convergence changes nothing), and the host reads (active, k) once per
chunk and the round's flags once per round. GMRES and LGMRES, as the
JAX package's lax.fori_loop/while_loop, run each restart cycle as one
piece (Arnoldi, the Hessenberg least squares by Givens rotations on the
device, the update and the true residual), and the host reads the
cycle test once per cycle. BiCGStab(l), as the JAX package's
lax.while_loop, runs its sweeps in masked chunks and the host reads
(active, k) once per chunk. These pieces run through a
solver.program.Program: eagerly, or replayed as CUDA graphs inside a
Newton iteration or a tracer step. The syncs are counted in
KrylovResult.host_syncs. Vectors are [N, b]; dot products reduce over
everything. reduce_sum combines the partial reductions of a
domain-decomposed vector across ranks (an all_reduce; the identity on
one device), so that every rank reads the same dots and takes the same
branches.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from waiwera_tpu_torch.solver.program import Program, distinct
from waiwera_tpu_torch.solver.smallblocks import hessenberg_lstsq_res

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
    """What the chunks of one BiCGStab or BiCGStab(l) solve share: the
    operator, the preconditioner, the right-hand side and the
    tolerance."""

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


class _ArnoldiOps(NamedTuple):
    """What the cycles of one GMRES or LGMRES solve share."""

    matvec: Callable
    precond: Callable
    b: torch.Tensor
    tol: torch.Tensor  # 0-d


class _ArnoldiState(NamedTuple):
    """GMRES's and LGMRES's loop state between cycles, on the device."""

    x: torch.Tensor
    r: torch.Tensor  # b - A x, which starts the next cycle
    rnorm: torch.Tensor  # 0-d
    k: torch.Tensor  # 0-d int64, cycles
    its: torch.Tensor  # 0-d int64, inner iterations
    Z: torch.Tensor  # [max(augment, 1), n] LGMRES error directions,
    # newest first
    nz: torch.Tensor  # 0-d int64, valid rows of Z


class _Arnoldi:
    """The pieces of one right-preconditioned restarted GMRES(m) or
    LGMRES solve, each a pure function of tensors with no host read; the
    cycle test is that of the JAX package's cond.

    Arnoldi with two-pass classical Gram-Schmidt (CGS2) against the
    whole basis, as the JAX package does: a cycle takes all m Arnoldi
    steps, solves the Hessenberg least squares on the device
    (smallblocks.hessenberg_lstsq_res), updates x, counts the inner
    iterations its residual profile needed and computes the true
    residual of the new iterate, which starts the next cycle: m + 1
    operator applications.

    LGMRES (augment > 0; Baker, Jessup & Manteuffel 2005, PETSc's
    KSPLGMRES): each cycle's subspace is m - augment Arnoldi directions
    plus the augment latest approximate error vectors z_i = x_i -
    x_{i-1} (normalised), kept as the JAX package keeps them, in a fixed
    [augment, n] buffer Z with a count nz of its valid rows; until Z
    fills, plain Arnoldi directions stand in, so the first cycle is
    GMRES(m). x is updated from the directions applied (Q), GMRES's from
    the preconditioned basis.

    basis_dtype: the storage dtype of V (and Q), the dominant
    workspace; with float32, H, the least squares and every update stay
    in b.dtype: rows of V are cast to b.dtype a few at a time where they
    meet a vector of b.dtype, the explicit form of the JAX package's
    mixed-dtype promotion."""

    def __init__(self, rtol, atol, restart, max_restarts, basis_dtype,
                 reduce_sum, augment=None):
        self.rtol = rtol
        self.atol = atol
        self.m = restart
        self.max_restarts = max_restarts
        self.basis_dtype = basis_dtype
        self.reduce_sum = reduce_sum
        self.lgmres = augment is not None
        self.k_aug = max(int(augment), 0) if self.lgmres else 0
        self.m_a = self.m - self.k_aug  # Arnoldi depth per cycle
        if self.m_a < 1:
            raise ValueError("lgmres restart must exceed augment")

    def norm(self, a):
        return torch.sqrt(self.reduce_sum(_dot(a, a)))

    def flags(self, st: _ArnoldiState, tol) -> torch.Tensor:
        """[go, its, converged] as int64: the host's one read per cycle."""
        finite = torch.isfinite(st.rnorm)
        go = (st.rnorm > tol) & (st.k < self.max_restarts) & finite
        conv = (st.rnorm <= tol) & finite
        return torch.stack([go.long(), st.its, conv.long()])

    def start(self, setup, *args):
        """setup(*args) -> (matvec, precond, b); then the residual at
        x = 0 and the first cycle test."""
        matvec, precond, b = setup(*args)
        if precond is None:
            precond = _identity
        tol = torch.clamp_min(self.rtol * self.norm(b), self.atol)
        ops = _ArnoldiOps(matvec, precond, b, tol)
        x = torch.zeros_like(b)
        r = b - matvec(x)
        k = torch.zeros((), dtype=torch.int64, device=b.device)
        st = _ArnoldiState(
            x=x, r=r, rnorm=self.norm(r), k=k, its=torch.zeros_like(k),
            Z=b.new_zeros((max(self.k_aug, 1), b.numel())),
            nz=torch.zeros_like(k))
        return ops, distinct(st), self.flags(st, tol)

    def cycle(self, st: _ArnoldiState, ops: _ArnoldiOps):
        """One restart cycle from st.x, and its test."""
        b = ops.b
        m, reduce_sum = self.m, self.reduce_sum
        v_dtype = b.dtype if self.basis_dtype is None else self.basis_dtype
        tiny = torch.finfo(b.dtype).tiny
        shape, n = b.shape, b.numel()
        V = b.new_zeros((m + 1, n), dtype=v_dtype)
        H = b.new_zeros((m + 1, m))
        Q = b.new_zeros((m, n), dtype=v_dtype) if self.lgmres else None
        beta = st.rnorm
        V[0] = (st.r.reshape(-1) / torch.where(beta != 0, beta, tiny)).to(
            v_dtype)
        for j in range(m):
            q = ops.precond(V[j].reshape(shape).to(b.dtype)).reshape(-1)
            if j >= self.m_a:
                # an error direction where Z holds one
                q = torch.where(j - self.m_a < st.nz, st.Z[j - self.m_a], q)
            w = ops.matvec(q.reshape(shape)).reshape(-1)
            h1 = reduce_sum(_basis_dot(V, j + 1, w))
            w = w - _basis_combine(V, j + 1, h1)
            h2 = reduce_sum(_basis_dot(V, j + 1, w))
            w = w - _basis_combine(V, j + 1, h2)
            wnorm = torch.sqrt(reduce_sum(w @ w))
            H[: j + 1, j] = h1 + h2
            H[j + 1, j] = wnorm
            V[j + 1] = (w / torch.where(wnorm > tiny, wnorm, 1.0)).to(v_dtype)
            if Q is not None:
                Q[j] = q.to(v_dtype)
        y, res = hessenberg_lstsq_res(H, beta, m)
        y = y.to(b.dtype)
        Z, nz = st.Z, st.nz
        if Q is None:
            x = st.x + ops.precond(_basis_combine(V, m, y).reshape(shape))
        else:
            dx = _basis_combine(Q, m, y)  # Q already in solution space
            x = st.x + dx.reshape(shape)
            if self.k_aug > 0:
                dxn = torch.sqrt(reduce_sum(dx @ dx))
                z = dx / torch.where(dxn > tiny, dxn, 1.0)
                Z = torch.cat([z[None], Z[:-1]])
                nz = torch.clamp_max(nz + 1, self.k_aug)
        # inner iterations of the cycle: the steps its residual profile
        # needed to reach tol (all m but in the last cycle)
        inner = torch.clamp_max(torch.sum(res > ops.tol) + 1, m)
        r = b - ops.matvec(x)
        st = _ArnoldiState(x=x, r=r, rnorm=self.norm(r), k=st.k + 1,
                           its=st.its + inner, Z=Z, nz=nz)
        return st, self.flags(st, ops.tol)


def _arnoldi_solve(solver: _Arnoldi, program: Program, setup, args,
                   name: str) -> KrylovResult:
    """The host loop over a GMRES or LGMRES solve's pieces: one read at
    the start and one per cycle."""
    syncs0 = program.host_syncs
    ops, st, flags = program.run(
        f"{name}.start", lambda *a: solver.start(setup, *a), *args)
    go, its, conv = program.read(flags)
    cycles = 0
    while go:
        st, flags = program.loop(f"{name}.cycle", solver.cycle, st, ops)
        go, its, conv = program.read(flags)
        cycles += 1
    return KrylovResult(
        x=st.x, iterations=its, residual_norm=st.rnorm,
        converged=bool(conv), host_syncs=program.host_syncs - syncs0,
        matvecs=1 + cycles * (solver.m + 1),
    )


def gmres_solve(program: Program, setup: Callable, *args,
                rtol: float = DEFAULT_RTOL, atol: float = DEFAULT_ATOL,
                restart: int = 30, max_restarts: int = 40,
                basis_dtype: Optional[torch.dtype] = None,
                reduce_sum: Callable = _identity,
                name: str = "gmres") -> KrylovResult:
    """Right-preconditioned restarted GMRES(restart) for A x = b from
    x = 0, where (matvec, precond, b) = setup(*args) is evaluated inside
    the solve's first piece (so that a Newton iteration can put its
    Jacobian there); each cycle is one piece (_Arnoldi). Host reads: one
    at the start and one per cycle; matvecs 1 + cycles (restart + 1)."""
    solver = _Arnoldi(rtol, atol, restart, max_restarts, basis_dtype,
                      reduce_sum)
    return _arnoldi_solve(solver, program, setup, args, name)


def lgmres_solve(program: Program, setup: Callable, *args,
                 rtol: float = DEFAULT_RTOL, atol: float = DEFAULT_ATOL,
                 restart: int = 30, augment: int = 2,
                 max_restarts: int = 40,
                 basis_dtype: Optional[torch.dtype] = None,
                 reduce_sum: Callable = _identity,
                 name: str = "lgmres") -> KrylovResult:
    """LGMRES, the reference's linear type "lgmres"
    (timestepper.F90:1731-1734), shaped as gmres_solve: restart -
    augment Arnoldi directions and `augment` error directions per
    cycle."""
    solver = _Arnoldi(rtol, atol, restart, max_restarts, basis_dtype,
                      reduce_sum, augment=augment)
    return _arnoldi_solve(solver, program, setup, args, name)


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
    """Right-preconditioned restarted GMRES(m) from x = 0, run eagerly
    (gmres_solve)."""
    return gmres_solve(
        Program(), lambda: (matvec, precond, b), rtol=rtol, atol=atol,
        restart=restart, max_restarts=max_restarts, basis_dtype=basis_dtype,
        reduce_sum=reduce_sum)


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
    """Loose GMRES from x = 0, run eagerly (lgmres_solve)."""
    return lgmres_solve(
        Program(), lambda: (matvec, precond, b), rtol=rtol, atol=atol,
        restart=restart, augment=augment, max_restarts=max_restarts,
        basis_dtype=basis_dtype, reduce_sum=reduce_sum)


class _BiCGLState(NamedTuple):
    """BiCGStab(l)'s loop state, on the device: the JAX package's
    while_loop carry and a flag."""

    y: torch.Tensor  # accumulated update, preconditioned space
    R: torch.Tensor  # [ell + 1, N, b]
    U: torch.Tensor  # [ell + 1, N, b]
    rho0: torch.Tensor  # 0-d
    alpha: torch.Tensor  # 0-d
    omega: torch.Tensor  # 0-d
    k: torch.Tensor  # 0-d int64, iterations (ell per sweep)
    rnorm: torch.Tensor  # 0-d, recurrence residual norm
    active: torch.Tensor  # 0-d bool: the next sweep runs


class _BiCGStabL:
    """The pieces of one BiCGStab(l) solve (Sleijpen & Fokkema 1993,
    PETSc's KSPBCGSL), each a pure function of tensors with no host
    read: the JAX package's lax.while_loop (cond and body) as chunks of
    `sweeps` sweeps, each sweep's update masked by the state's `active`
    (a sweep after convergence changes nothing)."""

    def __init__(self, ell, rtol, atol, max_iterations, reduce_sum, sweeps):
        self.L = int(ell)
        self.rtol = rtol
        self.atol = atol
        self.max_iterations = max_iterations
        self.reduce_sum = reduce_sum
        self.sweeps = sweeps

    def dot(self, a, c):
        return self.reduce_sum(_dot(a, c))

    def cond(self, rnorm, tol, k):
        return (rnorm > tol) & (k < self.max_iterations) & torch.isfinite(
            rnorm)

    def flags(self, st: _BiCGLState, tol) -> torch.Tensor:
        """[active, k, converged] as int64: the host's one read."""
        conv = (st.rnorm <= tol) & torch.isfinite(st.rnorm)
        return torch.stack([st.active.long(), st.k, conv.long()])

    def start(self, setup, *args):
        """setup(*args) -> (matvec, precond, b); then the carried state
        at x = 0 and the first test."""
        matvec, precond, b = setup(*args)
        if precond is None:
            precond = _identity
        rnorm = torch.sqrt(self.dot(b, b))
        tol = torch.clamp_min(self.rtol * rnorm, self.atol)
        ops = _BiCGOps(matvec, precond, b, tol)
        R = b.new_zeros((self.L + 1,) + tuple(b.shape))
        R[0] = b
        k = torch.zeros((), dtype=torch.int64, device=b.device)
        st = _BiCGLState(
            y=torch.zeros_like(b), R=R, U=torch.zeros_like(R),
            rho0=b.new_ones(()), alpha=b.new_zeros(()),
            omega=b.new_ones(()), k=k, rnorm=rnorm,
            active=self.cond(rnorm, tol, k))
        return ops, distinct(st), self.flags(st, tol)

    def chunk(self, st: _BiCGLState, ops: _BiCGOps):
        """One chunk: `sweeps` sweeps, each masked by st.active."""
        for _ in range(self.sweeps):
            st = self.sweep(st, ops)
        return st, self.flags(st, ops.tol)

    def sweep(self, st: _BiCGLState, ops: _BiCGOps) -> _BiCGLState:
        """The JAX package's body: ell BiCG steps on op = A∘M, then the
        ell-dimensional minimal-residual update; kept where st.active."""
        L, dot = self.L, self.dot
        tiny = torch.finfo(ops.b.dtype).tiny

        def safe(v):
            return torch.where(torch.abs(v) > tiny, v, tiny)

        def op(v):
            return ops.matvec(ops.precond(v))

        rshadow = ops.b  # the shadow residual: b, from x = 0
        y, alpha, omega = st.y, st.alpha, st.omega
        R, U = list(st.R.unbind(0)), list(st.U.unbind(0))
        rho0 = -omega * st.rho0
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

        on = st.active

        def keep(new, old):
            return torch.where(on, new, old)

        k = st.k + L * on.long()
        rnorm = keep(torch.sqrt(dot(R[0], R[0])), st.rnorm)
        return _BiCGLState(
            y=keep(y, st.y), R=keep(torch.stack(R), st.R),
            U=keep(torch.stack(U), st.U), rho0=keep(rho0, st.rho0),
            alpha=keep(alpha, st.alpha), omega=keep(omega, st.omega), k=k,
            rnorm=rnorm, active=on & self.cond(rnorm, ops.tol, k))


def bicgstab_l_solve(program: Program, setup: Callable, *args, ell: int = 2,
                     max_iterations: int = 1000,
                     rtol: float = DEFAULT_RTOL, atol: float = DEFAULT_ATOL,
                     reduce_sum: Callable = _identity,
                     name: str = "bicgstabl") -> KrylovResult:
    """BiCGStab(l) (Sleijpen & Fokkema 1993), PETSc's KSPBCGSL, the
    reference's linear type "bcgsl" (timestepper.F90:1735-1738), for
    A x = b from x = 0, where (matvec, precond, b) = setup(*args) is
    evaluated inside the solve's first piece (so that a Newton iteration
    can put its Jacobian there).

    Each sweep does l BiCG steps and an l-dimensional minimal-residual
    polynomial update, and counts l iterations, as in the JAX package.
    Right preconditioning runs the sweep on op = A∘M and maps the
    accumulated update through M once, in a last piece. The sweeps run
    in chunks of max(1, CHUNK // ell) (about as many operator
    applications as a BiCGStab chunk), masked after convergence.
    Host reads: one at the start and one per chunk; matvecs 2 ell per
    sweep run, masked included."""
    solver = _BiCGStabL(ell, rtol, atol, max_iterations, reduce_sum,
                        max(1, CHUNK // int(ell)))
    syncs0 = program.host_syncs
    ops, st, flags = program.run(
        f"{name}.start", lambda *a: solver.start(setup, *a), *args)
    active, k, conv = program.read(flags)
    chunks = 0
    while active:
        st, flags = program.loop(f"{name}.chunk", solver.chunk, st, ops)
        active, k, conv = program.read(flags)
        chunks += 1
    x = program.run(f"{name}.finish", lambda st, ops: ops.precond(st.y),
                    st, ops)
    swept = chunks * solver.sweeps
    return KrylovResult(
        x=x, iterations=k, residual_norm=st.rnorm, converged=bool(conv),
        host_syncs=program.host_syncs - syncs0,
        matvecs=2 * solver.L * swept,
        masked_iterations=solver.L * swept - k,
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
    """BiCGStab(l) from x = 0, run eagerly (bicgstab_l_solve)."""
    return bicgstab_l_solve(
        Program(), lambda: (matvec, precond, b), ell=ell,
        max_iterations=max_iterations, rtol=rtol, atol=atol,
        reduce_sum=reduce_sum)


def max_restarts(max_iterations: int, restart: int) -> int:
    """GMRES's and LGMRES's cycle cap for an iteration cap, as in the JAX
    package: ceil(max_iterations / restart), at least 1."""
    return max(1, -(-int(max_iterations) // max(restart, 1)))


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
    cycles = max_restarts(max_iterations, restart)
    if method == "gmres":
        return gmres(matvec, b, precond=precond, rtol=rtol, restart=restart,
                     max_restarts=cycles, basis_dtype=basis_dtype,
                     reduce_sum=reduce_sum)
    if method == "lgmres":
        return lgmres(matvec, b, precond=precond, rtol=rtol, restart=restart,
                      augment=augment, max_restarts=cycles,
                      basis_dtype=basis_dtype, reduce_sum=reduce_sum)
    if method in ("bcgsl", "bicgstabl"):
        return bicgstab_l(matvec, b, precond=precond, rtol=rtol, ell=ell,
                          max_iterations=max_iterations,
                          reduce_sum=reduce_sum)
    raise ValueError(f"unknown linear solver: {method!r}")
