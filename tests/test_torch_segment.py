"""The fixed-order scatter-sum of waiwera_tpu_torch (ops/segment.py,
ROADMAP C15): the same values as index_add on the CPU, bit for bit, on
rows ([M, k] into [N, k]) and on element-major blocks ([b*b, M] into
[b*b, N]), with a non-zero base and rows that receive nothing;
differentiable by torch.func.jvp; wrong sizes are an error."""

import numpy as np
import pytest
import torch

from waiwera_tpu_torch.ops.segment import SegmentSum


def _case(seed=0, n=500, m=1700):
    rng = np.random.default_rng(seed)
    left = rng.integers(0, n - 7, m)  # the last rows receive nothing
    right = rng.integers(0, n - 7, m)
    return n, left, right, rng


def test_rows_equal_index_add_bitwise():
    n, left, right, rng = _case()
    vl = torch.as_tensor(rng.standard_normal((len(left), 3)) * 1e3)
    vr = torch.as_tensor(rng.standard_normal((len(right), 3)))
    base = torch.as_tensor(rng.standard_normal((n, 3)))
    want = base.index_add(0, torch.as_tensor(left), vl).index_add(
        0, torch.as_tensor(right), vr)
    s = SegmentSum(np.concatenate([left, right]), n)
    got = s.add(base, torch.cat([vl, vr]))
    assert torch.equal(got, want)
    assert torch.equal(got[-7:], base[-7:])


def test_element_major_equals_index_add_bitwise():
    n, left, right, rng = _case(seed=1)
    al = torch.as_tensor(rng.standard_normal((9, len(left))))
    ar = torch.as_tensor(rng.standard_normal((9, len(right))))
    base = torch.as_tensor(rng.standard_normal((9, n)))
    want = base.index_add(1, torch.as_tensor(left), al).index_add(
        1, torch.as_tensor(right), ar)
    s = SegmentSum(np.concatenate([left, right]), n)
    assert torch.equal(s.add(base, torch.cat([al, ar], 1), dim=1), want)


def test_jvp_and_errors():
    n, left, _, rng = _case(seed=2)
    s = SegmentSum(left, n)
    v = torch.as_tensor(rng.standard_normal((len(left), 2)))
    t = torch.as_tensor(rng.standard_normal((len(left), 2)))
    zeros = torch.zeros(n, 2, dtype=torch.float64)
    out, tan = torch.func.jvp(lambda x: s.add(zeros, x * x), (v,), (t,))
    idx = torch.as_tensor(left)
    assert torch.equal(out, zeros.index_add(0, idx, v * v))
    torch.testing.assert_close(tan, zeros.index_add(0, idx, 2.0 * v * t),
                               rtol=1e-15, atol=0.0)
    with pytest.raises(ValueError, match="SegmentSum"):
        s.add(zeros, v[:-1])
    empty = SegmentSum(np.zeros(0, np.int64), 4)
    assert torch.equal(empty.add(torch.ones(4), torch.zeros(0)),
                       torch.ones(4))
