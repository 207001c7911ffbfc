"""The benchmark's arithmetic: the spread, the union of device intervals
and its gaps, and the SpMV bytes."""

import random
import statistics

import pytest

from perfbench.lib import peaks, spmv, stats, trace


def test_spread_is_quartiles_over_median():
    v = [1.0, 2.0, 3.0, 4.0, 5.0, 6.0]
    q1, q2, q3 = statistics.quantiles(v, n=4)
    assert stats.spread(v) == pytest.approx((q3 - q1) / q2)


def test_union_and_gaps():
    iv = [(0, 10), (5, 20), (30, 40), (35, 36), (50, 60)]
    assert trace.union_seconds(iv) == pytest.approx(40e-9)
    assert trace.gaps(iv, 0, 70) == [(20, 30), (40, 50), (60, 70)]
    assert trace.gaps([], 3, 9) == [(3, 9)]


@pytest.mark.parametrize("seed", range(20))
def test_union_and_gaps_against_counting(seed):
    rng = random.Random(seed)
    iv = []
    for _ in range(rng.randint(1, 40)):
        s = rng.randint(0, 100)
        iv.append((s, s + rng.randint(0, 20)))
    busy = set()
    for s, e in iv:
        busy.update(range(s, e))
    assert trace.union_seconds(iv) * 1e9 == pytest.approx(len(busy))
    idle = set()
    for a, b in trace.gaps(iv, 0, 130):
        idle.update(range(a, b))
    assert idle == set(range(130)) - busy


def test_idle_share_reader():
    from perfbench.lib import harness

    read = harness.metric_reader("device_idle_share").read
    assert read({"trace": {"busy_s": 3.0, "window_s": 4.0}}) == \
        pytest.approx(25.0)
    assert read({"trace": {"busy_s": 0.0, "window_s": 4.0}}) is None
    assert read({"trace": None}) is None


def test_spmv_bytes_flagship():
    # 128 x 64 x 64 + 8,192 ghosts, b = 3, f32
    rows, faces = 532_480, 1_552_384
    want = 4 * ((rows + 2 * faces) * 9 + 2 * rows * 3)
    assert spmv.band_spmv_bytes(rows, faces, 3, "float32") == want
    assert spmv.band_spmv_bytes(rows, faces, 3, "float64") == 2 * want


def test_roofline_reader():
    from perfbench.lib import harness

    read = harness.metric_reader("dia_spmv_roofline").read
    sizes = {"rows": 100, "interior_faces": 200, "primary_variables": 2}
    nbytes = spmv.band_spmv_bytes(100, 200, 2, "float64")
    need = 10 * nbytes / peaks.HBM_BYTES_PER_S
    run = {"sizes": sizes, "launches": {"float32": 0, "float64": 10},
           "trace": {"kernel_s": {
               "void dia_spmv_kernel<double, 2>(double const*)": 4 * need,
               "other": 1.0}}}
    assert read(run) == pytest.approx(25.0)
    run["launches"]["float64"] = 0
    assert read(run) is None
