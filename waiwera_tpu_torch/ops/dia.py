"""Block-DIA (diagonal-band) matrices: detection, band fill, SpMV and the
band preconditioners (counterpart of waiwera_tpu/ops/dia.py).

On rectilinear meshes in natural order the Jacobian's nonzero blocks sit
on a few diagonals, offsets {0, +-1, +-nx, +-nx*ny} (blocks coupling a
ghost cell are structurally present but always zero and are dropped).
The matrix is kept as bands [D, b*b, N] with the cell axis last, the
element-major layout of the JAX package's DIAMatrix, and

    y[i] = sum_k B_k[i] @ x[i + d_k]    (x zero outside [0, N))

is computed by the hand-written CUDA kernel csrc/dia_spmv.cu (f32 and f64
instantiations) on CUDA tensors (dia_matvec) and by its plain PyTorch
version on CPU tensors (dia_matvec_reference). The TPU layout (8-way cell
interleave, n padded to a multiple of 2048, periodic-slice band plans) is
not carried over: bands are filled by indexed copies.

Meshes that are banded except for a face tail (MINC fracture-matrix
connections, boundary faces) take the hybrid split of the JAX package:
the longest prefix of canonically ordered faces that the JAX cover rule
(face_plan_direct) accepts goes into bands, the rest is applied by the
caller with a fixed-order scatter-sum (hybrid_split).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import numpy as np
import torch

from waiwera_tpu_torch.solver.smallblocks import (
    apply_blocks_em,
    batch_from_em,
    em_from_batch,
    invert_blocks_em,
    matmul_em,
)

MAX_BANDS = 16
MAX_PLAN_SEGMENTS = 32
DILU_SWEEPS = 3  # default fixed-point sweeps per triangular solve (DILU)


class DIAStructure(NamedTuple):
    """Static band offsets (host-built from a BSRStructure)."""

    offsets: tuple  # D python ints, sorted
    num_rows: int
    block_size: int


class BandFill(NamedTuple):
    """Where each live face's off-diagonal blocks go in the flattened
    bands [D*b*b*N]: J[l,r] of face faces[f] at lr_index[:, f] and
    J[r,l] at rl_index[:, f] ([b*b, F_live] int64 each)."""

    faces: torch.Tensor
    lr_index: torch.Tensor
    rl_index: torch.Tensor


class DIAMatrix(NamedTuple):
    offsets: tuple
    bands: torch.Tensor  # [D, b*b, N]; row i*b+j holds block element (i, j)
    block_size: int
    num_rows: int


def dia_structure(structure, is_ghost: np.ndarray,
                  max_bands: int = MAX_BANDS) -> Optional[DIAStructure]:
    """Detect a banded sparsity, or None. Blocks coupling a ghost cell to
    another cell are excluded: their values are identically zero
    (ghost decoupling), so dropping them is exact. Ghost diagonal
    (identity) blocks live on offset 0."""
    rows = structure.rows
    cols = structure.indices
    is_ghost = np.asarray(is_ghost)
    live = (rows == cols) | ~(is_ghost[rows] | is_ghost[cols])
    offs = np.unique(cols[live] - rows[live])
    if len(offs) > max_bands:
        return None
    return DIAStructure(
        offsets=tuple(int(d) for d in offs),
        num_rows=structure.num_rows,
        block_size=structure.block_size,
    )


def _periodic_segments(rows: np.ndarray):
    """Split strictly ascending rows into (S, q, p, r0) periodic chunks:
    rows[i] = r0 + (i//q)*p + i%q within each chunk (the JAX package's
    _periodic_segments, which its hybrid cover rule is built on)."""
    segs = []
    i = 0
    L = len(rows)
    while i < L:
        r0 = int(rows[i])
        q = 1
        while i + q < L and rows[i + q] == r0 + q:
            q += 1
        p = int(rows[i + q] - r0) if i + q < L else q
        if p < q or p <= 0:
            return None  # duplicate or non-ascending rows
        S = 1
        while True:
            nxt = i + S * q
            if nxt + q > L:
                break
            if not np.array_equal(rows[nxt:nxt + q],
                                  r0 + S * p + np.arange(q)):
                break
            S += 1
        segs.append((S, q, p, r0))
        i += S * q
        if len(segs) > MAX_PLAN_SEGMENTS:
            return None
    return segs


class FacePlan(NamedTuple):
    """The JAX package's periodic-slice face plan (face_plan_direct):
    per positive offset in face order, entries (d, f0, S, q, p, r0) —
    faces f0..f0+S*q join cells r0 + m*p + j and that plus d; f_live
    faces are covered, the rest is the indexed tail. Plans compare
    equal exactly when the JAX package's do."""

    entries: tuple
    f_live: int
    pad: int


def face_plan_direct(face_cells: np.ndarray, is_ghost: np.ndarray,
                     num_rows: int) -> Optional[FacePlan]:
    """The JAX package's face_plan_direct (waiwera_tpu/ops/dia.py:
    345-403): runs of one positive offset are taken in face order while
    they split into few periodic row segments; the first ghost face,
    repeated offset, unproductive run (fewer than 8 faces per segment),
    exhausted segment budget or out-of-range run ends the prefix. None
    when the prefix covers less than half the faces."""
    a = np.asarray(face_cells[:, 0], np.int64)
    b = np.asarray(face_cells[:, 1], np.int64)
    is_ghost = np.asarray(is_ghost)
    live = ~(is_ghost[a] | is_ghost[b])
    F = len(a)
    d = b - a
    entries = []
    used = set()
    f = 0
    while f < F:
        if not live[f] or d[f] <= 0:
            break
        off = int(d[f])
        if off in used:
            break
        end = f
        while end < F and live[end] and d[end] == off:
            end += 1
        segs = _periodic_segments(a[f:end])
        if segs is None or (end - f) < 8 * len(segs):
            break
        if len(entries) + len(segs) > MAX_PLAN_SEGMENTS:
            break
        if any(r0 + off + (S - 1) * p + q > num_rows
               for (S, q, p, r0) in segs):
            break
        fseg = f
        for (S, q, p, r0) in segs:
            entries.append((off, fseg, S, q, p, r0))
            fseg += S * q
        used.add(off)
        f = end
    if not entries or f < F // 2:
        return None
    pad = max(dd + p for (dd, f0, S, q, p, r0) in entries)
    return FacePlan(entries=tuple(entries), f_live=f, pad=pad)


def plan_bands(plan: FacePlan, num_rows: int,
               block_size: int) -> Optional[DIAStructure]:
    """The bands of a face plan's prefix: offset 0 and +-d of every
    planned offset; None above MAX_BANDS (the JAX package's
    hybrid_band_structures)."""
    used = {e[0] for e in plan.entries}
    offsets = sorted({0} | used | {-o for o in used})
    if len(offsets) > MAX_BANDS:
        return None
    return DIAStructure(offsets=tuple(offsets), num_rows=num_rows,
                        block_size=block_size)


def hybrid_split(face_cells: np.ndarray, is_ghost: np.ndarray,
                 num_rows: int, block_size: int):
    """(DIAStructure, f_live) of the banded prefix faces[:f_live] of a
    mesh that is banded except for a face tail, or None: the prefix is
    the JAX package's face plan (face_plan_direct), so the hybrid DILU,
    which factors the banded part only, is the JAX package's. None
    when there is no plan or it needs more than MAX_BANDS bands (the
    JAX package then takes its BSR/ELL route)."""
    plan = face_plan_direct(face_cells, is_ghost, num_rows)
    if plan is None:
        return None
    bands = plan_bands(plan, num_rows, block_size)
    return None if bands is None else (bands, plan.f_live)


def band_fill(dia: DIAStructure, face_cells: np.ndarray,
              is_ghost: np.ndarray, device="cpu") -> BandFill:
    """Index tables for bands_from_blocks. Faces must be in canonical
    orientation (cell_l < cell_r): J[l,r] sits on band +d at row l and
    J[r,l] on band -d at row r, with d = r - l. Pass a prefix of the
    faces (hybrid_split) to fill the bands of that prefix only."""
    fc = np.asarray(face_cells, np.int64)
    is_ghost = np.asarray(is_ghost)
    cl, cr = fc[:, 0], fc[:, 1]
    if np.any(cr <= cl):
        raise ValueError("faces are not in canonical orientation")
    live = np.flatnonzero(~(is_ghost[cl] | is_ghost[cr]))
    offsets = np.asarray(dia.offsets, np.int64)
    d = cr[live] - cl[live]
    bb = dia.block_size ** 2
    n = dia.num_rows
    e = np.arange(bb, dtype=np.int64)[:, None]

    def flat(bands, rows):
        return (bands[None, :] * bb + e) * n + rows[None, :]

    # offsets are sorted and hold +d and -d of every live face
    k_lr = np.searchsorted(offsets, d)
    k_rl = np.searchsorted(offsets, -d)
    return BandFill(
        faces=torch.as_tensor(live, device=device),
        lr_index=torch.as_tensor(flat(k_lr, cl[live]), device=device),
        rl_index=torch.as_tensor(flat(k_rl, cr[live]), device=device),
    )


def bands_from_blocks(dia: DIAStructure, fill: BandFill,
                      diag2: torch.Tensor, lr2: torch.Tensor,
                      rl2: torch.Tensor, dtype=None) -> DIAMatrix:
    """Fill the bands [D, b*b, N] from element-major block parts
    (diag2 [b*b, N], per-face lr2/rl2 [b*b, F]) by indexed copies: the
    counterpart of the JAX package's bands_from_blocks."""
    b = dia.block_size
    bb = b * b
    n = dia.num_rows
    if dtype is None:
        dtype = diag2.dtype
    D = len(dia.offsets)
    flat = torch.zeros(D * bb * n, dtype=dtype, device=diag2.device)
    k0 = dia.offsets.index(0)
    flat[k0 * bb * n:(k0 + 1) * bb * n] = diag2.reshape(-1).to(dtype)
    flat[fill.lr_index.reshape(-1)] = lr2[:, fill.faces].reshape(-1).to(
        dtype
    )
    flat[fill.rl_index.reshape(-1)] = rl2[:, fill.faces].reshape(-1).to(
        dtype
    )
    return DIAMatrix(
        offsets=dia.offsets,
        bands=flat.view(D, bb, n),
        block_size=b,
        num_rows=n,
    )


def to_dia(mat, dia: DIAStructure, dtype=None) -> DIAMatrix:
    """Assembled BSR data (solver.bsr.BSRMatrix) in band layout: each
    band's blocks gathered by their positions in the row-major key
    (found on the host), absent blocks zero."""
    s = mat.structure
    n, b = s.num_rows, s.block_size
    key = s.rows * n + s.indices
    nnzb = len(key)
    i = np.arange(n, dtype=np.int64)
    pos = np.full((len(dia.offsets), n), nnzb, dtype=np.int64)
    for k, d in enumerate(dia.offsets):
        j = i + d
        want = i * n + j
        p = np.minimum(np.searchsorted(key, want), nnzb - 1)
        found = (j >= 0) & (j < n) & (key[p] == want)
        pos[k, found] = p[found]
    data = torch.cat([mat.data, mat.data.new_zeros((1, b, b))])
    bands = data[torch.as_tensor(pos, device=data.device)]  # [D, N, b, b]
    bands = bands.reshape(len(dia.offsets), n, b * b).transpose(1, 2)
    if dtype is not None:
        bands = bands.to(dtype)
    return DIAMatrix(offsets=dia.offsets, bands=bands.contiguous(),
                     block_size=b, num_rows=n)


def dia_matvec_reference(m: DIAMatrix, x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch band SpMV (the JAX package's jnp_matvec): static
    zero-filled shifts and multiply-adds, in the bands' dtype."""
    b = m.block_size
    n = x.shape[0]
    x = x.to(m.bands.dtype)
    acc = [x.new_zeros(n) for _ in range(b)]
    for k, d in enumerate(m.offsets):
        xs = torch.zeros_like(x)  # xs[i] = x[i + d], zero out of range
        m_ = max(n - abs(d), 0)
        if m_ and d >= 0:
            xs[:m_] = x[d:d + m_]
        elif m_:
            xs[n - m_:] = x[:m_]
        for ii in range(b):
            row = acc[ii]
            for j in range(b):
                row = row + m.bands[k, ii * b + j, :n] * xs[:, j]
            acc[ii] = row
    return torch.stack(acc, dim=1)


class _DiaOffsets(ctypes.Structure):
    _fields_ = [("d", ctypes.c_int * MAX_BANDS)]


class LaunchCount:
    """Plain count of kernel launches; read and reset by callers. Every
    count is listed in LaunchCount.all, so that a captured CUDA graph can
    add its launches on each replay (solver/program.py)."""

    all: list = []

    def __init__(self):
        self.count = 0
        LaunchCount.all.append(self)


# launches of csrc/dia_spmv.cu (dia_matvec on CUDA tensors), by type
dia_spmv_launches = LaunchCount()  # dia_spmv_f32
dia_spmv_f64_launches = LaunchCount()  # dia_spmv_f64

_KERNELS = {
    torch.float32: ("dia_spmv_f32", dia_spmv_launches),
    torch.float64: ("dia_spmv_f64", dia_spmv_f64_launches),
}
_spmv_fns: dict = {}


def _spmv_kernel(dtype):
    fn = _spmv_fns.get(dtype)
    if fn is None:
        from waiwera_tpu_torch.ops import cuda_build

        fn = getattr(cuda_build.load("dia_spmv"), _KERNELS[dtype][0])
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, _DiaOffsets,
            ctypes.c_int, ctypes.c_int, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
        _spmv_fns[dtype] = fn
    return fn


def dia_matvec(m: DIAMatrix, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x, x and y [N, b], bands and x both f32 or both f64. CPU
    tensors take the plain version; CUDA tensors launch the kernel
    csrc/dia_spmv.cu of their type, or raise."""
    bands = m.bands
    if bands.dtype != x.dtype or bands.dtype not in _KERNELS:
        raise TypeError(
            f"dia_matvec takes f32 or f64 bands and x of one type "
            f"(bands {bands.dtype}, x {x.dtype})"
        )
    if x.device.type == "cpu" and bands.device.type == "cpu":
        return dia_matvec_reference(m, x)
    if x.device.type != "cuda" or bands.device != x.device:
        raise ValueError(
            f"dia_matvec: x on {x.device}, bands on {bands.device}; "
            "both must be on one CUDA device (or both on the CPU)"
        )
    b = m.block_size
    n = m.num_rows
    D = len(m.offsets)
    if not 1 <= b <= 4 or not 1 <= D <= MAX_BANDS:
        raise ValueError(f"dia_matvec kernel: block size {b}, {D} bands")
    if (bands.dim() != 3 or bands.shape[0] != D or bands.shape[1] != b * b
            or bands.shape[2] < n):
        raise ValueError(f"dia_matvec: bands shape {tuple(bands.shape)}")
    if tuple(x.shape) != (n, b):
        raise ValueError(f"dia_matvec: x shape {tuple(x.shape)} != {(n, b)}")
    if not (bands.is_contiguous() and x.is_contiguous()):
        raise ValueError("dia_matvec: bands and x must be contiguous")
    offs = _DiaOffsets()
    offs.d[:D] = m.offsets
    y = torch.empty_like(x)
    name, launches = _KERNELS[bands.dtype]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _spmv_kernel(bands.dtype)(
            bands.data_ptr(), x.data_ptr(), y.data_ptr(), offs, D, b, n,
            bands.shape[2], stream,
        )
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")
    launches.count += 1
    return y


def select_bands(m: DIAMatrix, offsets) -> DIAMatrix:
    """The matrix of the listed bands of m only (a copy of those bands)."""
    # stacked slices: indexing by a list would copy the list to the device
    bands = (torch.stack([m.bands[m.offsets.index(d)] for d in offsets])
             if offsets else m.bands[:0].clone())
    return m._replace(offsets=tuple(offsets), bands=bands)


# ---------------------------------------------------------------------
# Band preconditioners
# ---------------------------------------------------------------------


def dia_block_jacobi_em(dinv2: torch.Tensor, dtype=None):
    """z = D^{-1} r from element-major inverse diagonal blocks
    [b*b, N], applied in `dtype` (the factors are cast once)."""
    if dtype is not None:
        dinv2 = dinv2.to(dtype)

    def apply(r: torch.Tensor) -> torch.Tensor:
        return apply_blocks_em(dinv2, r.to(dinv2.dtype))

    return apply


def _shift_last(x: torch.Tensor, d: int) -> torch.Tensor:
    """xs[..., i] = x[..., i + d], zero-filled out of range."""
    if d == 0:
        return x
    out = torch.zeros_like(x)
    n = x.shape[-1]
    m_ = max(n - abs(d), 0)
    if m_ and d > 0:
        out[..., :m_] = x[..., d:d + m_]
    elif m_:
        out[..., n - m_:] = x[..., :m_]
    return out


def dia_dilu_em(m: DIAMatrix, sweeps: int = DILU_SWEEPS, dtype=None):
    """DILU / block-SGS on the bands (the JAX package's dia_dilu_em):
    M = (D~ + L) D~^{-1} (D~ + U) with D~_i = A_ii - sum_{d<0} A_{i,i+d}
    inv(A_{i+d,i+d}) A_{i+d,i}, factored in the bands' dtype, and both
    triangular solves as `sweeps` fixed-point iterations applied in
    `dtype`. L y and U z are band SpMVs over the negative and positive
    bands (dia_matvec: the CUDA kernel on the card)."""
    b = m.block_size
    n = m.num_rows
    offs = [int(d) for d in m.offsets]

    def band2(d):
        return m.bands[offs.index(d)][:, :n]  # [bb, n]

    diag2 = band2(0)
    inv0 = invert_blocks_em(diag2)
    dmod = diag2
    neg = [d for d in offs if d < 0]
    pos = [d for d in offs if d > 0]
    for d in neg:
        if -d not in offs:
            continue
        inv_s = _shift_last(inv0, d)
        bu_s = _shift_last(band2(-d), d)  # A_{i+d, i}
        dmod = dmod - matmul_em(matmul_em(band2(d), inv_s), bu_s)
    dinv = invert_blocks_em(dmod)
    m_a = m if dtype is None else m._replace(bands=m.bands.to(dtype))
    dinv_a = dinv if dtype is None else dinv.to(dtype)
    lower = select_bands(m_a, neg)
    upper = select_bands(m_a, pos)

    def apply(r: torch.Tensor) -> torch.Tensor:
        r = r.to(m_a.bands.dtype)
        # forward: (D~ + L) y = r via y <- D~^{-1} (r - L y)
        y = apply_blocks_em(dinv_a, r)
        for _ in range(sweeps):
            y = apply_blocks_em(dinv_a, r - dia_matvec(lower, y))
        # backward: (I + D~^{-1} U) z = y via z <- y - D~^{-1} U z
        z = y
        for _ in range(sweeps):
            z = y - apply_blocks_em(dinv_a, dia_matvec(upper, z))
        return z

    return apply


def _bmv(a: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """a[l] @ v[l] for blocks a [p, b, b] and vectors v [p, b]: one
    product and one sum over the whole batch."""
    return (a * v.unsqueeze(-2)).sum(-1)


def _bmm(a: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a[l] @ c[l] for blocks [p, b, b]."""
    return (a.unsqueeze(-1) * c.unsqueeze(-3)).sum(-2)


def dia_line_pc_em(m: DIAMatrix, dtype=None):
    """Exact block-tridiagonal line preconditioner along the outermost
    positive band with a negative partner (z in natural rectilinear
    order; the JAX package's dia_line_pc_em). A block Thomas
    factorisation over the Z layers in the bands' dtype, then per
    application a forward and a backward substitution: the JAX
    package's three lax.scans as Python loops over the Z layers, each
    layer's block products batched over its p lines ([Z, p, b, b]
    blocks: a product and a sum per block product, so that a layer is a
    handful of kernels, which a CUDA graph replays). None when no
    +-offset pair exists."""
    offs = [int(d) for d in m.offsets]
    pos = [d for d in offs if d > 0 and -d in offs]
    if not pos:
        return None
    p = max(pos)
    b = m.block_size
    bb = b * b
    n = m.num_rows
    Z = -(-n // p)
    npad = Z * p

    def pad3(x2, fill_eye=False):
        x2 = x2[:, :n]
        if npad > n:
            if fill_eye:
                eye = torch.eye(b, dtype=x2.dtype, device=x2.device)
                fill = eye.reshape(bb, 1).expand(bb, npad - n)
            else:
                fill = x2.new_zeros((bb, npad - n))
            x2 = torch.cat([x2, fill], dim=1)
        # [Z, p, b, b]: the blocks of layer z, line l
        return x2.reshape(bb, Z, p).permute(1, 2, 0).reshape(Z, p, b, b)

    d3 = pad3(m.bands[offs.index(0)], fill_eye=True)
    up3 = pad3(m.bands[offs.index(p)])  # A[(z,l),(z+1,l)] at layer z
    lo3 = pad3(m.bands[offs.index(-p)])  # A[(z,l),(z-1,l)] at layer z

    # block Thomas: W_z = (d_z - lo_z W_{z-1} up_{z-1})^-1
    W = []
    for z in range(Z):
        dmod = d3[z]
        if z > 0:
            dmod = dmod - _bmm(_bmm(lo3[z], W[-1]), up3[z - 1])
        W.append(batch_from_em(invert_blocks_em(em_from_batch(dmod))))
    W3 = torch.stack(W)
    if dtype is not None:
        W3, lo3, up3 = W3.to(dtype), lo3.to(dtype), up3.to(dtype)

    def apply(r: torch.Tensor) -> torch.Tensor:
        rp = r.to(W3.dtype)
        if npad > n:
            rp = torch.cat([rp, rp.new_zeros((npad - n, b))])
        r3 = rp.reshape(Z, p, b)
        # forward: y_z = W_z (r_z - lo_z y_{z-1})
        ys = []
        for z in range(Z):
            rz = r3[z] - _bmv(lo3[z], ys[-1]) if ys else r3[z]
            ys.append(_bmv(W3[z], rz))
        # backward: x_z = y_z - W_z up_z x_{z+1}
        xs = [ys[-1]]
        for z in range(Z - 2, -1, -1):
            xs.append(ys[z] - _bmv(W3[z], _bmv(up3[z], xs[-1])))
        return torch.cat(xs[::-1])[:n]

    return apply
