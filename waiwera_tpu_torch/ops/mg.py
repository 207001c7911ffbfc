"""Geometric multigrid on the pressure block: the CPR preconditioner
(counterpart of waiwera_tpu/ops/mg.py).

CPR (constrained pressure residual) preconditions with

    z_p = MG(A_pp) r_p          (scalar geometric V-cycle)
    z   = C z_p + D_block^-1 (r - A C z_p)

where A_pp is block element (0, 0) of every band. The box [nz, ny, nx] is
reconstructed from the band offsets {1, nx, nx*ny}; restriction and
prolongation are 2x2x2 aggregate sums and repeats, Galerkin coarse
operators come from masked aggregate sums of the bands, and the smoother
is damped Jacobi. Everything is plain PyTorch, many small ops per
V-cycle (no kernel of the JAX package is behind it), with no host read:
the levels are built inside a try's Jacobian piece and the V-cycle runs
inside every application, replayed as CUDA graphs on the card.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

# the JAX package's V-cycle settings: damped-Jacobi weight, one pre- and
# one post-smoothing sweep, 24 sweeps on the coarsest level, coarse
# over-correction 1.5 (piecewise-constant aggregation under-estimates
# smooth error); levels coarsen while the box is larger than 4 cells
OMEGA = 0.8
COARSE_SWEEPS = 24
ALPHA = 1.5
MIN_DIM = 4
MAX_LEVELS = 8


class _Level(NamedTuple):
    """7-point scalar operator on an even-padded box [nz, ny, nx]: d the
    diagonal, xp/xm/yp/ym/zp/zm the couplings to the +-x/y/z neighbours
    (zero where no face, including pad cells, whose diagonal is 1)."""

    d: torch.Tensor
    xp: torch.Tensor
    xm: torch.Tensor
    yp: torch.Tensor
    ym: torch.Tensor
    zp: torch.Tensor
    zm: torch.Tensor


def _pad_even(a: torch.Tensor, diag: bool = False) -> torch.Tensor:
    nz, ny, nx = a.shape
    pz, py, px = nz % 2, ny % 2, nx % 2
    if not (pz or py or px):
        return a
    out = a.new_full((nz + pz, ny + py, nx + px), 1.0 if diag else 0.0)
    out[:nz, :ny, :nx] = a
    return out


def _shift(a: torch.Tensor, axis: int, step: int) -> torch.Tensor:
    """Neighbour values along axis (+1: the value at index i+1), zeros in
    from the boundary."""
    out = torch.zeros_like(a)
    n = a.shape[axis]
    if step > 0:
        out.narrow(axis, 0, n - 1).copy_(a.narrow(axis, 1, n - 1))
    else:
        out.narrow(axis, 1, n - 1).copy_(a.narrow(axis, 0, n - 1))
    return out


def _matvec(lv: _Level, z: torch.Tensor) -> torch.Tensor:
    return (
        lv.d * z
        + lv.xp * _shift(z, 2, +1)
        + lv.xm * _shift(z, 2, -1)
        + lv.yp * _shift(z, 1, +1)
        + lv.ym * _shift(z, 1, -1)
        + lv.zp * _shift(z, 0, +1)
        + lv.zm * _shift(z, 0, -1)
    )


def _agg_sum(a: torch.Tensor) -> torch.Tensor:
    Z, Y, X = a.shape
    return a.reshape(Z // 2, 2, Y // 2, 2, X // 2, 2).sum(dim=(1, 3, 5))


def _parity_masks(shape, device):
    Z, Y, X = shape
    mx = (torch.arange(X, device=device) % 2 == 0).reshape(1, 1, X)
    my = (torch.arange(Y, device=device) % 2 == 0).reshape(1, Y, 1)
    mz = (torch.arange(Z, device=device) % 2 == 0).reshape(Z, 1, 1)
    return mx, my, mz


def _coarsen(lv: _Level) -> _Level:
    """Galerkin coarse operator of piecewise-constant 2x2x2 aggregation:
    A_c[I,J] = sum_{i in I, j in J} A[i,j]. Couplings inside an aggregate
    fold into the coarse diagonal; couplings across become the coarse
    bands."""
    mx, my, mz = _parity_masks(lv.d.shape, lv.d.device)

    def keep(mask, a):
        return torch.where(mask, a, 0.0)

    dc = _agg_sum(
        lv.d
        + keep(mx, lv.xp) + keep(~mx, lv.xm)
        + keep(my, lv.yp) + keep(~my, lv.ym)
        + keep(mz, lv.zp) + keep(~mz, lv.zm)
    )
    return _Level(
        d=_pad_even(dc, diag=True),
        xp=_pad_even(_agg_sum(keep(~mx, lv.xp))),
        xm=_pad_even(_agg_sum(keep(mx, lv.xm))),
        yp=_pad_even(_agg_sum(keep(~my, lv.yp))),
        ym=_pad_even(_agg_sum(keep(my, lv.ym))),
        zp=_pad_even(_agg_sum(keep(~mz, lv.zp))),
        zm=_pad_even(_agg_sum(keep(mz, lv.zm))),
    )


def build_levels(lv0: _Level):
    levels = [lv0]
    while (
        len(levels) < MAX_LEVELS
        and max(levels[-1].d.shape) > MIN_DIM
        and min(levels[-1].d.shape) >= 2
    ):
        levels.append(_coarsen(levels[-1]))
    return levels


def _safe_inv(d: torch.Tensor) -> torch.Tensor:
    tiny = 1e-300 if d.dtype == torch.float64 else 1e-30
    big = torch.abs(d) > tiny
    return torch.where(big, 1.0 / torch.where(big, d, 1.0), 1.0)


def vcycle(levels, r: torch.Tensor) -> torch.Tensor:
    """One V-cycle for A z = r on levels[0] (r in the level's padded
    shape, zero in pad cells): one damped-Jacobi sweep from z = 0, the
    coarse correction (over-corrected by ALPHA), one more sweep."""
    lv = levels[0]
    dinv = _safe_inv(lv.d)
    z = OMEGA * dinv * r
    if len(levels) == 1:
        for _ in range(COARSE_SWEEPS - 1):
            z = z + OMEGA * dinv * (r - _matvec(lv, z))
        return z
    rc = _agg_sum(r - _matvec(lv, z))
    Zc, Yc, Xc = rc.shape
    rc_p = rc.new_zeros(levels[1].d.shape)
    rc_p[:Zc, :Yc, :Xc] = rc
    zc = vcycle(levels[1:], rc_p)[:Zc, :Yc, :Xc]
    # each coarse value repeated over its 2 x 2 x 2 aggregate
    zf = zc[:, None, :, None, :, None].expand(Zc, 2, Yc, 2, Xc, 2)
    z = z + ALPHA * zf.reshape(2 * Zc, 2 * Yc, 2 * Xc)
    return z + OMEGA * dinv * (r - _matvec(lv, z))


def box_dims(offsets, num_rows: int):
    """[nz (with ghost layers), ny, nx] from band offsets
    {0, +-1, +-nx, +-nx*ny}; None if the bands are not a 3-D box."""
    pos = sorted(int(d) for d in offsets if int(d) > 0)
    if len(pos) != 3:
        return None
    sx, sy, sz = pos
    if sx != 1 or sy <= 1 or sz % sy != 0:
        return None
    if any(-d not in offsets for d in pos):
        return None
    return -(-num_rows // sz), sz // sy, sy


def pressure_levels(m64, dtype=None):
    """(levels, dims) of the MG hierarchy of the pressure-pressure
    scalar sub-matrix of a block-DIA matrix (element (0, 0) of every
    band), or None when the offsets are not a 3-D box stencil."""
    dims = box_dims(m64.offsets, m64.num_rows)
    if dims is None:
        return None
    nz, ny, nx = dims
    n = m64.num_rows
    total = nz * ny * nx
    offs = [int(d) for d in m64.offsets]
    bands = m64.bands
    dt = bands.dtype if dtype is None else dtype

    def band3(d, diag=False):
        v = bands.new_full((total,), 1.0 if diag else 0.0, dtype=dt)
        if d in offs:
            v[:n] = bands[offs.index(d), 0, :n].to(dt)
        return v.reshape(nz, ny, nx)

    sx, sy, sz = 1, nx, nx * ny
    lv0 = _Level(
        d=_pad_even(band3(0, diag=True), diag=True),
        xp=_pad_even(band3(sx)), xm=_pad_even(band3(-sx)),
        yp=_pad_even(band3(sy)), ym=_pad_even(band3(-sy)),
        zp=_pad_even(band3(sz)), zm=_pad_even(band3(-sz)),
    )
    return build_levels(lv0), dims


def cpr_apply(levels, dims, base_mv, dinv2_apply, n: int):
    """CPR application z = C z_p + D_block^-1 (r - A C z_p), one V-cycle
    for z_p."""
    nz, ny, nx = dims
    total = nz * ny * nx
    Zp, Yp, Xp = levels[0].d.shape

    def apply(r: torch.Tensor) -> torch.Tensor:
        r3 = r.new_zeros((Zp, Yp, Xp), dtype=levels[0].d.dtype)
        rp = r.new_zeros(total, dtype=levels[0].d.dtype)
        rp[:n] = r[:, 0]
        r3[:nz, :ny, :nx] = rp.reshape(nz, ny, nx)
        z3 = vcycle(levels, r3)
        zp = z3[:nz, :ny, :nx].reshape(total)[:n]
        z1 = torch.zeros_like(r)
        z1[:, 0] = zp.to(r.dtype)
        return z1 + dinv2_apply(r - base_mv(z1))

    return apply
