"""1-D interpolation tables with linear / step / pchip variants and
endpoint / integration averaging over an interval (counterpart of
waiwera_tpu/utils/interpolation.py, class InterpolationTable).

Tables are static: their data are fixed at construction (numpy, the
pchip derivatives included) and copied once to each (dtype, device)
they are evaluated in; evaluation points are tensors. Out-of-range
evaluation clamps to the end values, as the reference's coordinate
``find`` does (interpolation.F90:25-33, 140-175).

Used by the table relative permeability and capillary pressure curves,
the CO2 viscosity table and the rock controls; the source network's
per-source tables are evaluated batched (StackedTables,
SparseTableUpdate), one pass for all the tables of a stack.
"""

from __future__ import annotations

import numpy as np
import torch

from waiwera_tpu_torch.tensors import clip, maximum, minimum

INTERP_LINEAR = "linear"
INTERP_STEP = "step"
INTERP_PCHIP = "pchip"
AVERAGING_ENDPOINT = "endpoint"
AVERAGING_INTEGRATE = "integrate"


def _pchip_derivatives(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Fritsch-Carlson monotone cubic derivative estimates (per column).

    x: [n], y: [n, m] -> d: [n, m]
    """
    n = len(x)
    if n == 1:
        return np.zeros_like(y)
    h = np.diff(x)[:, None]  # [n-1, 1]
    delta = np.diff(y, axis=0) / h  # [n-1, m]
    d = np.zeros_like(y)
    if n == 2:
        d[0] = delta[0]
        d[1] = delta[0]
        return d
    # interior points: weighted harmonic mean where slopes agree in sign
    h0 = h[:-1]
    h1 = h[1:]
    w1 = 2 * h1 + h0
    w2 = h1 + 2 * h0
    with np.errstate(divide="ignore", invalid="ignore"):
        dk = (w1 + w2) / (w1 / delta[:-1] + w2 / delta[1:])
    sign_ok = (np.sign(delta[:-1]) * np.sign(delta[1:])) > 0
    d[1:-1] = np.where(sign_ok, np.nan_to_num(dk), 0.0)

    # endpoints: one-sided three-point estimate, clipped for monotonicity
    def _end(h_a, h_b, del_a, del_b):
        dd = ((2 * h_a + h_b) * del_a - h_a * del_b) / (h_a + h_b)
        dd = np.where(np.sign(dd) != np.sign(del_a), 0.0, dd)
        lim = np.abs(3 * del_a)
        dd = np.where(
            (np.sign(del_a) != np.sign(del_b)) & (np.abs(dd) > lim),
            3 * del_a,
            dd,
        )
        return dd

    d[0] = _end(h[0], h[1], delta[0], delta[1])
    d[-1] = _end(h[-1], h[-2], delta[-1], delta[-2])
    return d


class InterpolationTable:
    """Static 1-D table y(x) with vectorised evaluation and interval
    averaging.

    ``data`` is [n, 1 + m]: the first column is the coordinate, the
    others the values. Rows are sorted by coordinate at construction.
    """

    def __init__(self, data, interpolation: str = INTERP_LINEAR,
                 averaging: str = AVERAGING_INTEGRATE):
        data = np.asarray(data, dtype=np.float64)
        if data.ndim == 1:
            data = data[None, :]
        order = np.argsort(data[:, 0], kind="stable")
        data = data[order]
        self.x = np.ascontiguousarray(data[:, 0])
        self.y = np.ascontiguousarray(data[:, 1:])
        self.n = len(self.x)
        self.dim = self.y.shape[1]
        self.interpolation = interpolation
        self.averaging = averaging
        self.deriv = (_pchip_derivatives(self.x, self.y)
                      if interpolation == INTERP_PCHIP else None)
        self._on = {}

    def _tables(self, like: torch.Tensor):
        """(x, y, deriv) as tensors in the dtype and device of `like`,
        copied once per (dtype, device)."""
        key = (like.dtype, like.device)
        hit = self._on.get(key)
        if hit is None:
            def t(a):
                return None if a is None else torch.as_tensor(
                    a, dtype=like.dtype, device=like.device)

            hit = (t(self.x), t(self.y), t(self.deriv))
            self._on[key] = hit
        return hit

    # -- evaluation --------------------------------------------------

    def __call__(self, xi: torch.Tensor) -> torch.Tensor:
        """Interpolate all columns at xi (any shape): [..., dim]."""
        x, y, d = self._tables(xi)
        n = self.n
        if n == 1:
            return y[0].expand(xi.shape + (self.dim,))
        xc = clip(xi, float(self.x[0]), float(self.x[-1]))
        kr = torch.searchsorted(x, xc, right=True) - 1
        if self.interpolation == INTERP_STEP:
            return y[torch.clamp(kr, 0, n - 1)]
        k = torch.clamp(kr, 0, n - 2)
        x0 = x[k]
        h = x[k + 1] - x0
        s = (xc - x0) / torch.where(h > 0, h, 1.0)
        y0 = y[k]
        y1 = y[k + 1]
        if self.interpolation == INTERP_PCHIP:
            d0 = d[k] * h[..., None]
            d1 = d[k + 1] * h[..., None]
            s_ = s[..., None]
            h00 = (1 + 2 * s_) * (1 - s_) ** 2
            h10 = s_ * (1 - s_) ** 2
            h01 = s_ * s_ * (3 - 2 * s_)
            h11 = s_ * s_ * (s_ - 1)
            return h00 * y0 + h10 * d0 + h01 * y1 + h11 * d1
        return y0 + s[..., None] * (y1 - y0)

    def component(self, xi: torch.Tensor, index: int = 0) -> torch.Tensor:
        return self(xi)[..., index]

    # -- interval averaging -----------------------------------------

    def integral(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """Definite integral of each column over [a, b] (a <= b), with
        end-clamped extension outside the table."""
        x, y, d = self._tables(a)
        if self.n == 1:
            return (b - a)[..., None] * y[0]
        xa, xb = float(self.x[0]), float(self.x[-1])
        lo = minimum(b, xa) - minimum(a, xa)
        hi = maximum(b, xb) - maximum(a, xb)
        total = lo[..., None] * y[0] + hi[..., None] * y[-1]
        ac = clip(a, xa, xb)
        bc = clip(b, xa, xb)
        x0 = x[:-1]
        hseg = x[1:] - x0
        hsafe = torch.where(hseg > 0, hseg, 1.0)
        s0 = clip((ac[..., None] - x0) / hsafe, 0.0, 1.0)
        s1 = clip((bc[..., None] - x0) / hsafe, 0.0, 1.0)
        h = hseg[..., None]  # [nseg, 1]
        y0 = y[:-1]
        y1 = y[1:]
        if self.interpolation == INTERP_STEP:
            seg = (s1 - s0)[..., None] * h * y0
        elif self.interpolation == INTERP_PCHIP:
            d0 = d[:-1] * h
            d1 = d[1:] * h

            def anti(s):
                s = s[..., None]
                s2 = s * s
                s3 = s2 * s
                s4 = s2 * s2
                H00 = s - s3 + s4 / 2.0
                H10 = s2 / 2.0 - 2.0 * s3 / 3.0 + s4 / 4.0
                H01 = s3 - s4 / 2.0
                H11 = s4 / 4.0 - s3 / 3.0
                return H00 * y0 + H10 * d0 + H01 * y1 + H11 * d1

            seg = h * (anti(s1) - anti(s0))
        else:
            seg = (
                (s1 - s0)[..., None]
                * h
                * (y0 + 0.5 * (s0 + s1)[..., None] * (y1 - y0))
            )
        return total + torch.sum(seg, dim=-2)

    def average(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """Average of each column over the interval [a, b]: 'endpoint'
        averages the two endpoint evaluations, 'integrate' takes the
        exact integral (interpolation.F90:140-175). A zero-length
        interval is a point evaluation."""
        if self.averaging == AVERAGING_ENDPOINT:
            return 0.5 * (self(a) + self(b))
        length = b - a
        point = self(a)
        nonzero = torch.abs(length) > 0.0
        safe = torch.where(nonzero, length, 1.0)
        avg = self.integral(minimum(a, b), maximum(a, b)) / torch.abs(
            safe)[..., None]
        return torch.where(nonzero[..., None], avg, point)

    def inverse(self, yi: torch.Tensor, index: int = 0) -> torch.Tensor:
        """Inverse interpolation of one column (assumed monotone): x
        such that y[index](x) = yi, linear variant only."""
        x, y, _ = self._tables(yi)
        yv = y[:, index].contiguous()
        increasing = bool(self.y[-1, index] >= self.y[0, index])
        yq = yv if increasing else -yv
        ti = yi if increasing else -yi
        k = torch.clamp(torch.searchsorted(yq, ti, right=True) - 1, 0,
                        self.n - 2)
        y0 = yv[k]
        y1 = yv[k + 1]
        s = torch.where(torch.abs(y1 - y0) > 0, (yi - y0) / (y1 - y0), 0.0)
        s = clip(s, 0.0, 1.0)
        return x[k] + s * (x[k + 1] - x[k])


class StackedTables:
    """k tables evaluated batched: one pass for all of them instead of k
    evaluations, so that a source network's update is the same sequence
    of tensor operations whatever the number of sources.

    Tables are padded to a common knot count by appending knots a tiny
    (1e-12-relative) epsilon past the last coordinate with the last value
    repeated (and pchip derivative 0), so padded evaluation and
    integration reproduce the single-table end-clamping to machine
    precision. All tables share the interpolation variant and value
    dimension; averaging may differ per table (a row mask)."""

    def __init__(self, tables):
        tables = list(tables)
        if not tables:
            raise ValueError("empty table stack")
        interp = tables[0].interpolation
        dim = tables[0].dim
        for t in tables:
            if t.interpolation != interp or t.dim != dim:
                raise ValueError(
                    "stacked tables must share interpolation and dim"
                )
        self.k = len(tables)
        self.dim = dim
        self.interpolation = interp
        n = max(max(t.n for t in tables), 2)
        xs = np.zeros((self.k, n))
        ys = np.zeros((self.k, n, dim))
        ds = np.zeros((self.k, n, dim)) if interp == INTERP_PCHIP else None
        for i, t in enumerate(tables):
            xs[i, : t.n] = t.x
            ys[i, : t.n] = t.y
            if ds is not None and t.deriv is not None:
                ds[i, : t.n] = t.deriv
            if t.n < n:
                eps = max(abs(t.x[-1]) * 1e-12, 1e-30)
                xs[i, t.n:] = t.x[-1] + eps * np.arange(1, n - t.n + 1)
                ys[i, t.n:] = t.y[-1]
        self.n = n
        self.x, self.y, self.deriv = xs, ys, ds
        self.endpoint = np.asarray(
            [t.averaging == AVERAGING_ENDPOINT for t in tables])
        self._on = {}

    def _tables(self, like: torch.Tensor):
        """(x, y, deriv, endpoint mask) as tensors in the dtype and
        device of `like`, copied once per (dtype, device)."""
        key = (like.dtype, like.device)
        hit = self._on.get(key)
        if hit is None:
            def t(a):
                return None if a is None else torch.as_tensor(
                    a, dtype=like.dtype, device=like.device)

            hit = (t(self.x), t(self.y), t(self.deriv),
                   torch.as_tensor(self.endpoint, device=like.device))
            self._on[key] = hit
        return hit

    def __call__(self, xi: torch.Tensor) -> torch.Tensor:
        """xi: [k] (one abscissa per table) -> [k, dim]."""
        x, y, d, _ = self._tables(xi)
        rows = torch.arange(self.k, device=xi.device)[:, None]
        xc = clip(xi, x[:, 0], x[:, -1])
        kr = torch.searchsorted(x, xc[:, None], right=True) - 1  # [k, 1]
        if self.interpolation == INTERP_STEP:
            return y[rows, torch.clamp(kr, 0, self.n - 1)][:, 0]
        k = torch.clamp(kr, 0, self.n - 2)
        x0 = x[rows, k][:, 0]
        h = x[rows, k + 1][:, 0] - x0
        s = (xc - x0) / torch.where(h > 0, h, 1.0)
        y0 = y[rows, k][:, 0]
        y1 = y[rows, k + 1][:, 0]
        if self.interpolation == INTERP_PCHIP:
            d0 = d[rows, k][:, 0] * h[:, None]
            d1 = d[rows, k + 1][:, 0] * h[:, None]
            s_ = s[:, None]
            h00 = (1 + 2 * s_) * (1 - s_) ** 2
            h10 = s_ * (1 - s_) ** 2
            h01 = s_ * s_ * (3 - 2 * s_)
            h11 = s_ * s_ * (s_ - 1)
            return h00 * y0 + h10 * d0 + h01 * y1 + h11 * d1
        return y0 + s[:, None] * (y1 - y0)

    def _integral(self, x, y, d, a, b):
        """[k, dim] integrals over [a, b] (0-d, a <= b) of every table,
        end-clamped as InterpolationTable.integral."""
        xa, xb = x[:, :1], x[:, -1:]  # [k, 1]
        lo = minimum(b, xa) - minimum(a, xa)
        hi = maximum(b, xb) - maximum(a, xb)
        total = lo * y[:, 0] + hi * y[:, -1]
        ac = clip(a, xa, xb)
        bc = clip(b, xa, xb)
        x0 = x[:, :-1]
        hseg = x[:, 1:] - x0  # [k, nseg]
        hsafe = torch.where(hseg > 0, hseg, 1.0)
        s0 = clip((ac - x0) / hsafe, 0.0, 1.0)
        s1 = clip((bc - x0) / hsafe, 0.0, 1.0)
        h = hseg[..., None]  # [k, nseg, 1]
        y0 = y[:, :-1]
        y1 = y[:, 1:]
        if self.interpolation == INTERP_STEP:
            seg = (s1 - s0)[..., None] * h * y0
        elif self.interpolation == INTERP_PCHIP:
            d0 = d[:, :-1] * h
            d1 = d[:, 1:] * h

            def anti(s):
                s = s[..., None]
                s2 = s * s
                s3 = s2 * s
                s4 = s2 * s2
                H00 = s - s3 + s4 / 2.0
                H10 = s2 / 2.0 - 2.0 * s3 / 3.0 + s4 / 4.0
                H01 = s3 - s4 / 2.0
                H11 = s4 / 4.0 - s3 / 3.0
                return H00 * y0 + H10 * d0 + H01 * y1 + H11 * d1

            seg = h * (anti(s1) - anti(s0))
        else:
            seg = (
                (s1 - s0)[..., None]
                * h
                * (y0 + 0.5 * (s0 + s1)[..., None] * (y1 - y0))
            )
        return total + torch.sum(seg, dim=-2)

    def average(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """Average over [a, b] (0-d tensors, shared by all rows) ->
        [k, dim], per-row endpoint or integrate averaging."""
        x, y, d, endpoint = self._tables(a)
        av = a.expand(self.k)
        bv = b.expand(self.k)
        point = self(av)
        end = 0.5 * (point + self(bv))
        lo = minimum(a, b)
        hi = maximum(a, b)
        length = hi - lo
        nonzero = length > 0.0
        mean = self._integral(x, y, d, lo, hi) / torch.where(
            nonzero, length, 1.0)
        integrated = torch.where(nonzero, mean, point)
        return torch.where(endpoint[:, None], end, integrated)


class SparseTableUpdate:
    """Batched table evaluations put into a subset of rows of a dense
    per-item tensor: out = base with out[idx] <- tables(t0, t1). Rows not
    covered keep their `base` values."""

    def __init__(self, indices, stack: StackedTables):
        self.indices = np.asarray(indices, np.int64)
        self.stack = stack
        self._on = {}

    def _index(self, device) -> torch.Tensor:
        hit = self._on.get(device)
        if hit is None:
            hit = self._on[device] = torch.as_tensor(self.indices,
                                                     device=device)
        return hit

    def average_into(self, base: torch.Tensor, t0, t1,
                     column: int = 0) -> torch.Tensor:
        """t0, t1: Python numbers or 0-d tensors."""
        a = scalar_like(t0, base)
        b = scalar_like(t1, base)
        vals = self.stack.average(a, b)[:, column]
        return base.index_put((self._index(base.device),), vals)

    def eval_into(self, base: torch.Tensor, xi: torch.Tensor,
                  column: int = 0) -> torch.Tensor:
        """xi: full-length per-item abscissae; rows idx are replaced by
        their table evaluated at xi[idx]."""
        idx = self._index(base.device)
        vals = self.stack(xi[idx])[:, column]
        return base.index_put((idx,), vals)


def scalar_like(t, like: torch.Tensor) -> torch.Tensor:
    """A time as a 0-d tensor in the dtype and device of `like`: a fill,
    not a copy from the host."""
    if isinstance(t, torch.Tensor):
        return t.to(dtype=like.dtype, device=like.device)
    return like.new_full((), float(t))


def build_sparse_updates(tables_by_index):
    """[(index, table), ...] -> list of SparseTableUpdate, grouped so
    that each group's tables share interpolation variant and dim."""
    groups = {}
    for i, t in tables_by_index:
        if t is None:
            continue
        groups.setdefault((t.interpolation, t.dim), []).append((i, t))
    return [
        SparseTableUpdate([i for i, _ in items],
                          StackedTables([t for _, t in items]))
        for items in groups.values()
    ]


def from_json(data, spec: dict | None = None) -> InterpolationTable:
    """A table from JSON-style data ([[x, y...], ...]) and an optional
    spec with 'interpolation' and 'averaging' keys."""
    spec = spec or {}
    return InterpolationTable(
        data,
        interpolation=spec.get("interpolation", INTERP_LINEAR),
        averaging=spec.get("averaging", AVERAGING_INTEGRATE),
    )
