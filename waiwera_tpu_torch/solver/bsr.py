"""Block sparse row (BSR) matrices (counterpart of
waiwera_tpu/solver/bsr.py).

The structure is host-built numpy; it decides whether the Jacobian is
banded (ops.dia.dia_structure). Assembled BSR data is needed off the
banded path only: the ELL operator, and the CPU reference of the bench.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from waiwera_tpu_torch.ops.segment import SegmentSum


class BSRStructure(NamedTuple):
    """Static sparsity, numpy int64 arrays."""

    indptr: np.ndarray  # [N+1]
    indices: np.ndarray  # [nnzb] column block of each stored block
    rows: np.ndarray  # [nnzb] row block of each stored block
    diag_pos: np.ndarray  # [N] position of the diagonal block of each row
    num_rows: int
    block_size: int


class BSRMatrix(NamedTuple):
    structure: BSRStructure
    data: torch.Tensor  # [nnzb, b, b]
    diag_pos: torch.Tensor  # [N] structure.diag_pos on the data's device

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        """y = A @ x with x, y of shape [N, b]: each row's blocks summed
        in storage order (ops/segment.py, the same bits on every
        device). Builds its row sum on the host at each call: off the
        solvers' path."""
        s = self.structure
        cols = torch.as_tensor(s.indices, device=x.device)
        prod = torch.einsum("kij,kj->ki", self.data, x[cols])
        rows = SegmentSum(s.rows, s.num_rows, device=x.device)
        return rows.add(torch.zeros_like(x), prod)

    def diag_blocks(self) -> torch.Tensor:
        """[N, b, b] diagonal blocks."""
        return self.data[self.diag_pos]


class Assembly(NamedTuple):
    """Device tables of assemble, built once on the host."""

    total: SegmentSum  # diagonal, (l, r) and (r, l) blocks -> positions
    diag_pos: torch.Tensor  # [N]


def assembly(structure: BSRStructure, face_cells: np.ndarray,
             device="cpu") -> Assembly:
    """The positions of the diagonal blocks and of every face's (l, r)
    and (r, l) blocks (face_block_positions) as one fixed-order sum
    (ops/segment.py, ROADMAP C15: two faces between one cell pair share
    a position; where no position repeats the sum is one gather)."""
    lr, rl = face_block_positions(structure, face_cells)
    index = np.concatenate([structure.diag_pos, lr, rl])
    return Assembly(
        total=SegmentSum(index, len(structure.indices), device),
        diag_pos=torch.as_tensor(structure.diag_pos, device=device),
    )


def assemble(structure: BSRStructure, tables: Assembly, diag: torch.Tensor,
             face_lr: torch.Tensor, face_rl: torch.Tensor) -> BSRMatrix:
    """Matrix data from diagonal blocks [N, b, b] and per-face
    off-diagonal blocks [F, b, b] summed at their positions in a fixed
    order, with nothing read from the host."""
    b = structure.block_size
    blocks = torch.cat([diag, face_lr, face_rl])
    data = tables.total.add(
        blocks.new_zeros((len(structure.indices), b, b)), blocks)
    return BSRMatrix(structure=structure, data=data,
                     diag_pos=tables.diag_pos)


def build_structure(num_cells: int, face_cells: np.ndarray,
                    block_size: int) -> BSRStructure:
    """Sparsity from mesh connectivity: a diagonal block per cell plus
    one block per face side."""
    rows = [np.arange(num_cells, dtype=np.int64)]
    cols = [np.arange(num_cells, dtype=np.int64)]
    if len(face_cells):
        rows.append(face_cells[:, 0])
        cols.append(face_cells[:, 1])
        rows.append(face_cells[:, 1])
        cols.append(face_cells[:, 0])
    rows = np.concatenate(rows).astype(np.int64)
    cols = np.concatenate(cols).astype(np.int64)
    # sort by (row, col) and merge duplicate faces between a cell pair
    order = np.lexsort((cols, rows))
    rows = rows[order]
    cols = cols[order]
    keep = np.ones(len(rows), dtype=bool)
    keep[1:] = (rows[1:] != rows[:-1]) | (cols[1:] != cols[:-1])
    rows = rows[keep]
    cols = cols[keep]
    indptr = np.zeros(num_cells + 1, dtype=np.int64)
    np.add.at(indptr[1:], rows, 1)
    indptr = np.cumsum(indptr)
    diag_pos = np.searchsorted(
        rows * num_cells + cols, np.arange(num_cells) * (num_cells + 1)
    )
    return BSRStructure(
        indptr=indptr,
        indices=cols,
        rows=rows,
        diag_pos=diag_pos,
        num_rows=num_cells,
        block_size=block_size,
    )


def face_block_positions(structure: BSRStructure, face_cells: np.ndarray):
    """Positions in the block data of the (l, r) and (r, l) blocks of
    each face."""
    n = structure.num_rows
    key = structure.rows * n + structure.indices
    fc = np.asarray(face_cells, np.int64)
    lr = np.searchsorted(key, fc[:, 0] * n + fc[:, 1])
    rl = np.searchsorted(key, fc[:, 1] * n + fc[:, 0])
    return lr, rl
