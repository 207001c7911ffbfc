"""Small dense block kernels in element-major layout (counterpart of
waiwera_tpu/solver/smallblocks.py: invert_blocks_em, matmul_em,
apply_blocks_em, em_from_batch, batch_from_em).

Blocks are stored as [b*b, N]: row i*b+j holds block element (i, j), so
every operation is a handful of elementwise ops over [N] vectors.
"""

from __future__ import annotations

import torch


def _det_em(e, rows, cols):
    """Laplace-expansion determinant over element accessor e(i,j)."""
    if len(rows) == 1:
        return e(rows[0], cols[0])
    acc = None
    for k, c in enumerate(cols):
        term = e(rows[0], c) * _det_em(e, rows[1:], cols[:k] + cols[k + 1:])
        if k % 2 == 1:
            term = -term
        acc = term if acc is None else acc + term
    return acc


def invert_blocks_em(a2: torch.Tensor) -> torch.Tensor:
    """Inverse of [b*b, N] element-major blocks (b in 1..4) via
    adjugate/determinant."""
    bb = a2.shape[0]
    b = int(round(bb ** 0.5))
    if b * b != bb:
        raise ValueError(f"not a square block: {bb} elements")
    if b > 4:
        raise NotImplementedError(f"block size {b} > 4")

    def e(i, j):
        return a2[i * b + j]

    if b == 1:
        return 1.0 / a2
    idx = tuple(range(b))
    inv_det = 1.0 / _det_em(e, idx, idx)
    rows = []
    for i in range(b):
        for j in range(b):
            rs = tuple(r for r in idx if r != j)
            cs = tuple(c for c in idx if c != i)
            cof = _det_em(e, rs, cs)
            if (i + j) % 2 == 1:
                cof = -cof
            rows.append(cof * inv_det)
    return torch.stack(rows)


def matmul_em(a2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """[b*b, N] @ [b*b, N] blockwise product, element-major."""
    bb = a2.shape[0]
    b = int(round(bb ** 0.5))
    rows = []
    for i in range(b):
        for j in range(b):
            acc = None
            for k in range(b):
                t = a2[i * b + k] * b2[k * b + j]
                acc = t if acc is None else acc + t
            rows.append(acc)
    return torch.stack(rows)


def em_from_batch(a: torch.Tensor) -> torch.Tensor:
    """[N, b, b] -> [b*b, N]."""
    n, b, _ = a.shape
    return a.reshape(n, b * b).T


def batch_from_em(a2: torch.Tensor) -> torch.Tensor:
    """[b*b, N] -> [N, b, b]."""
    bb, n = a2.shape
    b = int(round(bb ** 0.5))
    return a2.T.reshape(n, b, b)


def apply_blocks_em(a2: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """y[n, i] = sum_j a2[i*b+j, n] * x[n, j] for x [N, b]."""
    bb = a2.shape[0]
    b = int(round(bb ** 0.5))
    n = x.shape[0]
    cols = []
    for i in range(b):
        acc = None
        for j in range(b):
            t = a2[i * b + j][:n] * x[:, j]
            acc = t if acc is None else acc + t
        cols.append(acc)
    return torch.stack(cols, dim=1)


def hessenberg_lstsq_res(H: torch.Tensor, beta: torch.Tensor, m: int):
    """(y, res): the least-squares solution of min ||beta e1 - H y|| for
    the [m+1, m] upper-Hessenberg H by Givens rotations, and the
    residual profile res[j] = |g[j+1]| after column j (the GMRES
    residual with j+1 Arnoldi vectors), in f64 on H's device with the
    1e-300 guards of the JAX package's smallblocks.hessenberg_lstsq_res.
    Nothing is read on the host: a rotation that the guard skips is the
    identity, a back-substitution pivot it skips gives 0 (its row made
    that of the identity with a zero right-hand side).

    Few launches, since an eager cycle is bound by them: each rotation
    G = [[c, s], [-s, c]] acts on the two rows of [R | g] as one 2 x 2
    product; g[j+1] = -s_j g[j] before rotation j + 1 (g[j+1] is zero
    until then), so res is |beta| times the running product of |s|; the
    back substitution is one triangular solve."""
    b = beta.to(torch.float64)
    Rg = torch.cat([H.to(torch.float64), H.new_zeros((m + 1, 1),
                                                     dtype=torch.float64)], 1)
    Rg[0, m] = b
    # made on the device: a Python number written into a CUDA tensor is
    # a host-to-device copy, which a graph capture refuses
    k = torch.arange(2, device=Rg.device)
    kf = k.to(torch.float64)
    identity = 1.0 - kf  # the skipped rotation's (c, s)
    swap = torch.stack([k, 1 - k])  # G = cs[swap] * sign
    sign = torch.stack([torch.ones_like(kf), 2.0 * kf - 1.0])
    s = []
    for j in range(m):
        ab = Rg[j:j + 2, j]
        r = torch.linalg.vector_norm(ab)
        cs = torch.where(r > 1e-300, ab / r, identity)
        Rg[j:j + 2] = (cs[swap] * sign) @ Rg[j:j + 2]
        s.append(cs[1:])
    res = torch.abs(b) * torch.cumprod(torch.abs(torch.cat(s)), 0)
    U = torch.triu(Rg[:m, :m])
    skip = torch.abs(torch.diagonal(U)) <= 1e-300
    U = torch.where(skip[:, None], torch.eye(m, dtype=U.dtype,
                                             device=U.device), U)
    rhs = torch.where(skip, 0.0, Rg[:m, m])
    y = torch.linalg.solve_triangular(U, rhs[:, None], upper=True)[:, 0]
    return y, res
