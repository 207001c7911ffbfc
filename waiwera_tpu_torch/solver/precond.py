"""Preconditioners for BSR systems (counterpart of
waiwera_tpu/solver/precond.py).

The PC types Waiwera uses (timestepper.F90:1743-1835) on the BSR/ELL
route, i.e. off the banded meshes:
- block-Jacobi at cell-block granularity (exact small-block inverse)
- block DILU with fixed-point (Jacobi-style) triangular sweeps, which
  the JSON names asm, ilu and sgs map to: the sequential triangular
  solve of PETSc's ILU is replaced by a few data-parallel relaxation
  sweeps (gathers, batched small-block products and fixed-order
  scatter-sums)
- a dense LU of the whole matrix, for small systems
- none

Factorisations run in f64 (the matrix's dtype); each apply runs in the
dtype it is given.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from waiwera_tpu_torch.ops.segment import SegmentSum
from waiwera_tpu_torch.solver.bsr import BSRMatrix, BSRStructure
from waiwera_tpu_torch.solver.smallblocks import (
    batch_from_em,
    em_from_batch,
    invert_blocks_em,
)

LU_MAX_UNKNOWNS = 20000


def invert_blocks(a: torch.Tensor) -> torch.Tensor:
    """Inverse of a batch of small blocks [N, b, b], b in 1..4
    (adjugate / determinant)."""
    return batch_from_em(invert_blocks_em(em_from_batch(a)))


def _apply(blocks: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """y[n] = blocks[n] @ x[n] for blocks [N, b, b] and x [N, b]."""
    return (blocks * x.unsqueeze(-2)).sum(-1)


def block_jacobi(matrix: BSRMatrix,
                 dtype=None) -> Callable[[torch.Tensor], torch.Tensor]:
    """z = D^{-1} r with D the cell-diagonal blocks, inverted in the
    matrix's dtype and applied in `dtype`."""
    inv = invert_blocks(matrix.diag_blocks())
    if dtype is not None:
        inv = inv.to(dtype)

    def apply(r: torch.Tensor) -> torch.Tensor:
        return _apply(inv, r.to(inv.dtype))

    return apply


class ILU0Data(NamedTuple):
    """Static split of the sparsity into strictly-lower and
    strictly-upper blocks (host-built, int64 tensors on the matrix's
    device), with the fixed-order sums of each part's blocks into their
    rows. lower_trans_pos: the position of the transposed block A_ji of
    each lower A_ij."""

    lower_pos: torch.Tensor
    lower_rows: torch.Tensor
    lower_cols: torch.Tensor
    upper_pos: torch.Tensor
    upper_rows: torch.Tensor
    upper_cols: torch.Tensor
    lower_sum: SegmentSum
    upper_sum: SegmentSum
    lower_trans_pos: torch.Tensor


def ilu0_split(structure: BSRStructure, device="cpu") -> ILU0Data:
    """The lower/upper split of a BSR structure, with the transposed
    position of every lower block (numpy searchsorted on the sorted
    row-major key, once)."""
    rows = np.asarray(structure.rows)
    cols = np.asarray(structure.indices)
    low = np.nonzero(cols < rows)[0]
    up = np.nonzero(cols > rows)[0]
    n = structure.num_rows
    trans = np.searchsorted(rows * n + cols, cols[low] * n + rows[low])

    def t(a):
        return torch.as_tensor(np.asarray(a, np.int64), device=device)

    return ILU0Data(
        lower_pos=t(low), lower_rows=t(rows[low]), lower_cols=t(cols[low]),
        upper_pos=t(up), upper_rows=t(rows[up]), upper_cols=t(cols[up]),
        lower_sum=SegmentSum(rows[low], n, device),
        upper_sum=SegmentSum(rows[up], n, device),
        lower_trans_pos=t(trans),
    )


def _transpose_blocks(matrix: BSRMatrix, split: ILU0Data) -> torch.Tensor:
    """Blocks A_ji for each strictly-lower block A_ij, at the positions
    ilu0_split found."""
    return matrix.data[split.lower_trans_pos]


def dilu(matrix: BSRMatrix, split: ILU0Data, sweeps: int = 3, dtype=None):
    """D-ILU / block SGS-style preconditioner with iterative triangular
    solves.

    M = (D~ + L) D~^{-1} (D~ + U) with the DILU-modified diagonal
    D~_i = A_ii - sum_{j<i} A_ij D_j^{-1} A_ji (one pass, with the
    unmodified inverse D_j^{-1}); each triangular solve is `sweeps`
    fixed-point iterations:
        y <- D~^{-1} (r - L y)   (forward)
        z <- y - D~^{-1} U z     (backward)
    """
    diag = matrix.diag_blocks()
    lower = matrix.data[split.lower_pos]
    upper = matrix.data[split.upper_pos]
    inv0 = invert_blocks(diag)
    trans = _transpose_blocks(matrix, split)
    corr = torch.einsum("kij,kjl,klm->kim", lower, inv0[split.lower_cols],
                        trans)
    dmod = split.lower_sum.add(diag, -corr)
    dinv = invert_blocks(dmod)
    if dtype is not None:
        dinv = dinv.to(dtype)
        lower = lower.to(dtype)
        upper = upper.to(dtype)
    lsum, lcols = split.lower_sum, split.lower_cols
    usum, ucols = split.upper_sum, split.upper_cols

    def apply(r: torch.Tensor) -> torch.Tensor:
        r = r.to(dinv.dtype)
        y = _apply(dinv, r)
        for _ in range(sweeps):
            ly = lsum.add(torch.zeros_like(r), _apply(lower, y[lcols]))
            y = _apply(dinv, r - ly)
        z = y
        for _ in range(sweeps):
            uz = usum.add(torch.zeros_like(r), _apply(upper, z[ucols]))
            z = y - _apply(dinv, uz)
        return z

    return apply


def lu(matrix: BSRMatrix, dtype=None):
    """Direct dense LU preconditioner (the reference's PCLU option,
    timestepper.F90:1823-1829): the matrix densified [n*b, n*b] and
    factorised once per Jacobian in its own dtype; refused above
    LU_MAX_UNKNOWNS unknowns."""
    s = matrix.structure
    n, b = s.num_rows, s.block_size
    nd = n * b
    if nd > LU_MAX_UNKNOWNS:
        raise ValueError(
            f"lu preconditioner: system too large ({nd} dof > 20000); "
            "use bjacobi/asm/ilu"
        )
    dev = matrix.data.device
    dense = matrix.data.new_zeros((n, n, b, b))
    dense.index_put_((torch.as_tensor(s.rows, device=dev),
                      torch.as_tensor(s.indices, device=dev)),
                     matrix.data, accumulate=True)
    dense = dense.permute(0, 2, 1, 3).reshape(nd, nd)
    lu_fac, piv = torch.linalg.lu_factor(dense)
    if dtype is not None:
        lu_fac = lu_fac.to(dtype)

    def apply(r: torch.Tensor) -> torch.Tensor:
        x = torch.linalg.lu_solve(lu_fac, piv,
                                  r.reshape(nd, 1).to(lu_fac.dtype))
        return x.reshape(n, b).to(r.dtype)

    return apply


def make_preconditioner(name: str, matrix: BSRMatrix,
                        split: Optional[ILU0Data] = None, sweeps: int = 3,
                        dtype=None):
    """PC factory by the reference's JSON names (timestepper.F90:
    1743-1835): bjacobi, asm/ilu/dilu/sgs (the data-parallel DILU), lu
    (dense direct, small systems), none; line and cpr need the banded
    layout and fall back to block-Jacobi on unstructured BSR."""
    if name == "none":
        return lambda r: r
    if name in ("bjacobi", "jacobi", "line", "zline", "cpr", "cprmg"):
        return block_jacobi(matrix, dtype=dtype)
    if name == "lu":
        return lu(matrix, dtype=dtype)
    if name in ("asm", "ilu", "dilu", "sgs"):
        if split is None:
            split = ilu0_split(matrix.structure, device=matrix.data.device)
        return dilu(matrix, split, sweeps=sweeps, dtype=dtype)
    raise ValueError(f"unknown preconditioner: {name!r}")
