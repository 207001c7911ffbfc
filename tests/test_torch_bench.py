"""The port's bench (waiwera_tpu_torch/bench.py) and stream kernel on
the CPU, against bench.py where it has a counterpart.

- The settle protocol (time_step, 2 settle steps to keep the test
  short) on the flagship model of a 5 x 4 x 3 box against
  bench.py:time_step driving the JAX package: equal accepted
  count, tries, held and timed dt, simulated time and Newton iterations
  of the timed step; BiCGStab iterations within 2 (f32 dot products sum
  in another order, tests/test_torch_step.py).
- The stream kernel's plain version: out = 0.999999 * x in f32, bitwise
  equal to x * 0.999999, without a kernel launch; wrong inputs raise.
- The roofline section below timer noise records its skip marker, and
  does not measure the bandwidth.
- Simulation and Bench without a device raise where there is no CUDA
  device, and do not fall back to the CPU.
- On the card (marked cuda): stream_scale against its plain version,
  bitwise, at every size and offset of chip_smoke.check_stream_grid
  (with one size above 2^31 elements) with its launch counts, and
  measure_bandwidth below the published 3.35 TB/s x 1.05, through the
  vector kernel at every launch.
"""

import numpy as np
import pytest
import torch

from torch_parity import jax_sim, torch_sim
from waiwera_tpu_torch import bench as tbench
from waiwera_tpu_torch.ops import stream


def test_settle_protocol_matches_bench_py():
    import bench as jbench

    sj, st = jax_sim(), torch_sim()
    _, it_j, li_j = jbench.time_step(sj, jbench.make_step(sj), reps=1,
                                     settle=2)
    _, it_t, li_t = tbench.time_step(st, tbench.make_step(st), reps=1,
                                     settle=2)
    info_j, info_t = jbench.time_step.last_info, tbench.time_step.last_info
    for key in ("settle_accepted", "settle_tries", "dt_timed",
                "sim_time_reached"):
        assert info_t[key] == pytest.approx(info_j[key], rel=1e-12), key
    assert it_t == it_j
    assert abs(li_t - li_j) <= 2
    assert info_t["y_finite"] and info_t["krylov_matvecs"] > 0
    # CPU tensors take the plain SpMV: no kernel launch
    assert info_t["spmv_launches"] == 0


def test_stream_plain_version():
    x = torch.as_tensor(
        np.random.default_rng(0).uniform(0.5, 2.0, (8, 4099)),
        dtype=torch.float32)
    out = torch.empty_like(x)
    before = stream.stream_scale_launches.count
    assert stream.stream_scale(x, out) is out
    assert stream.stream_scale_launches.count == before
    assert torch.equal(out, x * 0.999999)
    assert torch.equal(out, torch.as_tensor(
        x.numpy() * np.float32(0.999999)))
    with pytest.raises(ValueError):
        stream.stream_scale(x, torch.empty(8, 4099, device="meta"))
    with pytest.raises(ValueError):
        stream.measure_bandwidth("cpu")


def test_roofline_skip_marker_below_timer_noise():
    calls = []

    def bandwidth():
        calls.append(1)
        return 3.0e12

    # a tiny mesh: the two chain slopes are equal to the timer's noise
    out = tbench.roofline_fields(nnz=540, nrows=60, npv=3, per=2.0e-5,
                                 norm_per=2.0e-5 - 3e-7,
                                 bandwidth=bandwidth)
    assert list(out) == ["spmv_skipped"]
    assert "below timer noise" in out["spmv_skipped"]
    assert not calls
    out = tbench.roofline_fields(nnz=9 * 10**6, nrows=10**6, npv=3,
                                 per=6e-5, norm_per=1e-5,
                                 bandwidth=bandwidth)
    spmv_bytes = 4.0 * (9 * 10**6 + 2 * 10**6 * 3)
    assert out["spmv_bytes"] == spmv_bytes
    assert out["spmv_roofline_fraction"] == pytest.approx(
        spmv_bytes / 5e-5 / 3.0e12)
    assert out["measured_bandwidth_gb_s"] == pytest.approx(3000.0)


def test_no_device_raises_without_cuda(monkeypatch):
    from waiwera_tpu_torch.mesh.rect import rectangular_mesh
    from waiwera_tpu_torch.sim.simulation import Simulation, resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    widths, origin = tbench.flagship_spacing(3, 2, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Simulation(tbench.flagship_config(3, 2, 2),
                   mesh=rectangular_mesh(*widths, origin=origin))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tbench.Bench()
    assert resolve_device("cpu") == torch.device("cpu")
    assert tbench.main(["--nx", "3", "--ny", "2", "--nz", "2"]) != 0


@pytest.mark.cuda
def test_cuda_stream_scale_matches_plain():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from chip_smoke import STREAM_SIZES, check_stream_grid

    # every size and offset of x and out, then one size above 2^31
    # elements at matched and at mismatched offsets: bitwise equal to
    # x * 0.999999 with its launch counts
    assert check_stream_grid(lambda msg: None) == len(STREAM_SIZES) * 16 + 2
    vec4 = stream.stream_scale_launches.count
    scalar = stream.stream_scalar_launches.count
    bw = stream.measure_bandwidth("cuda")
    assert 0.0 < bw < 1.05 * 3.35e12
    # fresh [8, 8Mi] buffers: every launch of the bandwidth path takes the
    # vector kernel, none the scalar one
    # (two chains of 4 and 24 launches, a warm-up and 3 timed each)
    assert stream.stream_scale_launches.count - vec4 == 4 * (4 + 24)
    assert stream.stream_scalar_launches.count == scalar
