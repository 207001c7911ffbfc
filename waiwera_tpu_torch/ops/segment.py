"""Scatter-sums over static indices in a fixed order (ROADMAP C15).

index_add on a CUDA tensor sums with atomics in no fixed order, so two
runs of one model differ in round-off and then in Krylov counts. A
SegmentSum is built once on the host from an index that does not change
(a mesh's face cells, the cells of the sources, the rows of a BSR
matrix's lower blocks): a table of the entries that land in each row,
in index order, one row of the table per slot. Adding the slots one
after another sums every row's entries in index order on every device:
the result is that of index_add on the CPU, bit for bit but for the
sign of a zero, and it is differentiable by torch.func.jvp (gathers and
adds only).
"""

from __future__ import annotations

import copy
import math

import numpy as np
import torch


def _vector_rows(width: int, itemsize: int) -> bool:
    """Whether rows of `width` elements of `itemsize` bytes are what
    PyTorch's CUDA row gather (index, index_select and gather along dim
    0) copies with its vectorised kernel: one row per thread block, 16
    bytes per row at the port's widths, ~30 x below the card's bandwidth
    on an H100 (PERF.md §6). Such rows are gathered element by element
    instead."""
    return width > 1 and (width * itemsize) % 16 == 0


class RowGather:
    """x[index] along dim 0 for a static int64 index (a mesh's face
    cells, an ELL table, the columns of a BSR matrix's lower blocks).
    Rows whose bytes PyTorch would gather with its vectorised row kernel
    (_vector_rows) are gathered element by element from the flat tensor,
    at element positions built once per row width (at a piece's warm-up,
    before any capture); the result is x[index], bit for bit."""

    def __init__(self, index: torch.Tensor):
        self.index = index
        self._positions = {}

    def to(self, device) -> "RowGather":
        return RowGather(self.index.to(device))

    def positions(self, width: int) -> torch.Tensor:
        """[*index.shape, width] element positions of the rows."""
        pos = self._positions.get(width)
        if pos is None:
            pos = self._positions[width] = (
                self.index.unsqueeze(-1) * width
                + torch.arange(width, device=self.index.device))
        return pos

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        width = math.prod(x.shape[1:])
        if not _vector_rows(width, x.element_size()):
            if self.index.dim() == 1:
                return x.index_select(0, self.index)
            return x[self.index]
        return x.reshape(-1)[self.positions(width)].reshape(
            self.index.shape + x.shape[1:])


class SegmentSum:
    """out.index_add(dim, index, values) for a static index, summed in
    index order on every device."""

    def __init__(self, index, num_rows: int, device="cpu"):
        index = np.asarray(index, np.int64).reshape(-1)
        self.size = len(index)
        self.num_rows = num_rows
        counts = np.bincount(index, minlength=num_rows)
        depth = int(counts.max()) if self.size else 0
        order = np.argsort(index, kind="stable")
        first = np.cumsum(counts) - counts
        slot = np.arange(self.size) - first[index[order]]
        # entry index per (slot, row); empty slots point at a zero pad
        table = np.full((depth, num_rows), self.size, np.int64)
        table[slot, index[order]] = order
        self.slots = [RowGather(torch.as_tensor(t, device=device))
                      for t in table]

    def to(self, device) -> "SegmentSum":
        """The same sum with its tables on `device`."""
        out = copy.copy(self)
        out.slots = [t.to(device) for t in self.slots]
        return out

    def add(self, out: torch.Tensor, values: torch.Tensor,
            dim: int = 0) -> torch.Tensor:
        """out plus, in each row along dim, the values (along dim) whose
        index names that row."""
        if values.shape[dim] != self.size or out.shape[dim] != self.num_rows:
            raise ValueError(
                f"SegmentSum of {self.size} entries into {self.num_rows} "
                f"rows: values {tuple(values.shape)}, out "
                f"{tuple(out.shape)} along dim {dim}")
        pad = list(values.shape)
        pad[dim] = 1
        v = torch.cat([values, values.new_zeros(pad)], dim)
        for slot in self.slots:
            out = out + (slot(v) if dim == 0
                         else v.index_select(dim, slot.index))
        return out
