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

import numpy as np
import torch


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
        self.slots = [torch.as_tensor(t, device=device) for t in table]

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
            out = out + v.index_select(dim, slot)
        return out
