"""Block SpMV through an ELL (padded fixed-width row) layout (counterpart
of waiwera_tpu/ops/ell.py).

Mesh matrices have bounded row degree (the diagonal plus one block per
cell face), so every block row is padded to the largest degree K and

    y[n] = sum_k data[n, k] @ x[indices[n, k]]

is one gather and one batched small product over K. The tables are
host-built from the BSR structure; converting assembled BSR data is one
gather per Jacobian. Padded slots point at the row's own column with
zero data, so the matvec needs no mask. The JAX package computes this
outside any Pallas kernel, and so does the port: gather + einsum.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from waiwera_tpu_torch.ops.segment import RowGather


class ELLStructure(NamedTuple):
    indices: torch.Tensor  # [N, K] int64 block column per slot (pad: own row)
    gather_pos: torch.Tensor  # [N, K] int64 into BSR data padded by one
    # trailing zero block (pad slots point at position nnzb)
    block_size: int
    rows: RowGather  # x[indices] (ops/segment.py), built once


class ELLMatrix(NamedTuple):
    indices: torch.Tensor  # [N, K]
    data: torch.Tensor  # [N, K, b, b] (pad slots zero)
    rows: RowGather  # x[indices] (ops/segment.py)

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        """y = A @ x with x, y [N, b]."""
        xg = self.rows(x)  # [N, K, b]
        return torch.einsum("nkij,nkj->ni", self.data,
                            xg.to(self.data.dtype))


def ell_structure(structure, device="cpu") -> ELLStructure:
    """ELL tables from a solver.bsr.BSRStructure, K = the largest row
    degree."""
    indptr = np.asarray(structure.indptr)
    rows = np.asarray(structure.rows)
    cols = np.asarray(structure.indices)
    n = structure.num_rows
    counts = np.diff(indptr)
    width = int(counts.max()) if len(counts) else 1
    nnzb = len(rows)
    indices = np.repeat(np.arange(n, dtype=np.int64)[:, None], width, axis=1)
    gather_pos = np.full((n, width), nnzb, dtype=np.int64)
    slot = np.arange(nnzb) - indptr[rows]  # position within each row
    indices[rows, slot] = cols
    gather_pos[rows, slot] = np.arange(nnzb)
    indices = torch.as_tensor(indices, device=device)
    return ELLStructure(
        indices=indices,
        gather_pos=torch.as_tensor(gather_pos, device=device),
        block_size=structure.block_size,
        rows=RowGather(indices),
    )


def to_ell(mat, ell: ELLStructure, dtype=None) -> ELLMatrix:
    """Assembled BSR data in the ELL layout (one gather), optionally cast
    to dtype."""
    b = ell.block_size
    data = torch.cat([mat.data, mat.data.new_zeros((1, b, b))])
    d = data[ell.gather_pos]  # [N, K, b, b]
    if dtype is not None:
        d = d.to(dtype)
    return ELLMatrix(indices=ell.indices, data=d, rows=ell.rows)
