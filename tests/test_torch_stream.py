"""The stream kernel's launch plan and plain version on the CPU
(waiwera_tpu_torch/ops/stream.py; the kernels, csrc/stream_scale.cu,
run only on the card: tests/test_torch_bench.py, marked cuda).

- stream_plan covers every element exactly once, in order; the vector
  kernel's body starts at 16-byte aligned addresses of x and out and is a
  multiple of 16 bytes long; the scalar head and tail hold at most 3
  elements each; x and out that differ in alignment modulo 16 bytes take
  the scalar kernel only; fresh [8, 8Mi] buffers take the vector kernel
  alone.
  For every size of the card's grid and element offsets 0-3 of x and
  of out each.
- The plain version is bitwise equal to the JAX kernel's arithmetic
  (bench.py:309, x * 0.999999 in f32 under jax.enable_x64(False)), as
  jnp computes it and as the Pallas kernel body computes it in
  interpret mode, on seeded inputs in the normal range; it launches
  nothing. Below the normal range XLA's CPU backend flushes to zero and
  the plain version keeps IEEE subnormals (a test of its own).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from waiwera_tpu_torch.ops import stream

SIZES = (0, 1, 3, 4, 5, 4099, 8 * 4099, 8 * 8 * 1024 * 1024)
X_BASE = 0x7F3A_0000_0000  # allocations: 512-byte aligned
OUT_BASE = 0x7F3A_4000_0200


@pytest.mark.parametrize("n", SIZES)
def test_plan_covers_each_element_once(n):
    for ox in range(4):
        for oo in range(4):
            x_ptr, out_ptr = X_BASE + 4 * ox, OUT_BASE + 4 * oo
            plan = stream.stream_plan(x_ptr, out_ptr, n)
            covered = [i for _, a, b in plan for i in (a, b)]
            assert covered == sorted(covered)
            assert all(b > a for _, a, b in plan)
            assert sum(b - a for _, a, b in plan) == n
            if n:
                assert plan[0][1] == 0 and plan[-1][2] == n
                assert all(p[2] == q[1] for p, q in zip(plan, plan[1:]))
            kinds = [k for k, _, _ in plan]
            assert set(kinds) <= {"vec4", "scalar"}
            assert kinds.count("vec4") <= 1
            if ox != oo:  # mismatched modulo 16 bytes
                assert kinds == (["scalar"] if n else [])
                continue
            for kind, a, b in plan:
                if kind == "vec4":
                    assert (x_ptr + 4 * a) % 16 == 0
                    assert (out_ptr + 4 * a) % 16 == 0
                    assert (4 * (b - a)) % 16 == 0
                else:
                    assert b - a <= 3
            head = (4 - ox) % 4
            assert ("vec4" in kinds) == (n - min(n, head) >= 4)


def test_fresh_buffers_take_the_vector_kernel_alone():
    n = stream.N_SUB * stream.N_LANE
    assert stream.stream_plan(X_BASE, OUT_BASE, n) == [("vec4", 0, n)]
    x = torch.empty((stream.N_SUB, 1024))
    out = torch.empty_like(x)
    assert stream.stream_plan(x.data_ptr(), out.data_ptr(), x.numel()) == [
        ("vec4", 0, x.numel())]


def _pallas_stream(x):
    """bench.py:309's kernel body over (8, 512) tiles, interpret mode."""

    def kern(x_ref, o_ref):
        o_ref[...] = x_ref[...] * 0.999999

    with jax.enable_x64(False):
        return pl.pallas_call(
            kern,
            out_shape=jax.ShapeDtypeStruct(x.shape, jnp.float32),
            grid=(x.shape[1] // 512,),
            in_specs=[pl.BlockSpec((8, 512), lambda i: (0, i))],
            out_specs=pl.BlockSpec((8, 512), lambda i: (0, i)),
            interpret=True,
        )(x)


TINY = np.finfo(np.float32).tiny  # the least normal f32


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plain_version_bitwise_equal_to_jax(seed):
    rng = np.random.default_rng(seed)
    # magnitudes from 1e-37 to 1e38 and both signs; values (and products)
    # below the normal range are the next test's
    x_np = (rng.standard_normal((8, 4096))
            * 10.0 ** rng.integers(-37, 38, (8, 4096))).astype(np.float32)
    x_np[np.abs(x_np) < 2 * TINY] = 1.0
    x = torch.as_tensor(x_np)
    out = torch.empty_like(x)
    vec4 = stream.stream_scale_launches.count
    scalar = stream.stream_scalar_launches.count
    assert stream.stream_scale(x, out) is out
    assert (stream.stream_scale_launches.count,
            stream.stream_scalar_launches.count) == (vec4, scalar)
    with jax.enable_x64(False):
        want = np.asarray(jnp.asarray(x_np) * 0.999999)
    assert want.dtype == np.float32
    np.testing.assert_array_equal(out.numpy().view(np.int32),
                                  want.view(np.int32))
    got = np.asarray(_pallas_stream(jnp.asarray(x_np)))
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_plain_version_keeps_subnormals():
    """Below the normal range the two differ, and only there: XLA's CPU
    backend flushes subnormal inputs to zero, while the plain version
    (like the CUDA kernels, built without fast math) keeps IEEE gradual
    underflow, equal to numpy's f32 multiply."""
    x_np = np.array([TINY / 2, -TINY / 3, TINY * 1.0000001, 1e-45],
                    np.float32)
    out = stream.stream_scale(torch.as_tensor(x_np),
                              torch.empty(4, dtype=torch.float32)).numpy()
    np.testing.assert_array_equal(
        out.view(np.int32), (x_np * np.float32(0.999999)).view(np.int32))
    assert (out[[0, 1, 2]] != 0).all()
    with jax.enable_x64(False):
        flushed = np.asarray(jnp.asarray(x_np) * 0.999999)
    np.testing.assert_array_equal(flushed, np.zeros(4, np.float32))
