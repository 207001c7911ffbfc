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
