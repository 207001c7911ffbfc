"""Band operators of waiwera_tpu_torch against waiwera_tpu.

- The port's plain SpMV (dia_matvec on CPU tensors) against the JAX
  package's jnp_matvec and its Pallas kernel in interpret mode, at
  b = 1..4 with odd, negative and out-of-range (|d| >= n) offsets:
  f32, rtol 2e-5, atol 2e-4 (tests/test_solver.py:723).
- Band fill from the f32 Jacobian parts of the flagship model on a
  small box (exact copies) and block-Jacobi.
- The f64 plain SpMV against jnp_matvec in f64 (rtol 1e-13), and the
  wrapper's refusal of mixed, f16 and bf16 types.
- The CUDA kernels (f32 and f64) against the plain version on the card
  (marked cuda; skip without a CUDA device). The machine with the card has no JAX,
  so JAX is imported inside the tests that use it; run the card's
  cases there with
  `python -m pytest --noconftest -m cuda tests/test_torch_dia.py`.
"""

import numpy as np
import pytest
import torch

from torch_parity import jax_sim, np_, torch_sim
from waiwera_tpu_torch.ops import dia as tdia

N_ROWS = 300
N_PAD = 2048  # the Pallas kernel's band width: a multiple of 2048
# |d| = n is the widest shift the JAX package's jnp_matvec takes
OFFSETS = (-300, -40, -7, -1, 0, 1, 13, 299, 300)
# shifts past the matrix (|d| > n) contribute nothing
OFFSETS_WIDE = (-301, -40, -7, -1, 0, 1, 13, 299, 512)


def _random_matrix(rng, b, n=N_ROWS, offsets=OFFSETS):
    bands = rng.standard_normal((len(offsets), b * b, n)).astype(np.float32)
    x = rng.standard_normal((n, b)).astype(np.float32)
    return bands, x


def _jax_matrix(bands, offsets, b, n):
    import jax.numpy as jnp
    from waiwera_tpu.ops import dia as jdia

    padded = np.zeros(bands.shape[:2] + (N_PAD,), np.float32)
    padded[:, :, :n] = bands
    return jdia.DIAMatrix(offsets=offsets, bands=jnp.asarray(padded),
                          block_size=b, num_rows=n)


def _torch_matrix(bands, offsets, b, n, device="cpu"):
    return tdia.DIAMatrix(offsets=offsets,
                          bands=torch.as_tensor(bands, device=device),
                          block_size=b, num_rows=n)


@pytest.mark.parametrize("b", [1, 2, 3, 4])
def test_plain_spmv_matches_jax(b):
    import jax.numpy as jnp
    from waiwera_tpu.ops import dia as jdia

    bands, x = _random_matrix(np.random.default_rng(10 + b), b)
    mj = _jax_matrix(bands, OFFSETS, b, N_ROWS)
    y_jnp = np.asarray(jdia.jnp_matvec(mj, jnp.asarray(x)))
    y_pal = np.asarray(jdia.pallas_matvec(mj, jnp.asarray(x)))
    before = tdia.dia_spmv_launches.count
    y_t = tdia.dia_matvec(_torch_matrix(bands, OFFSETS, b, N_ROWS),
                          torch.as_tensor(x))
    assert tdia.dia_spmv_launches.count == before  # CPU: no kernel launch
    assert y_t.dtype == torch.float32 and tuple(y_t.shape) == (N_ROWS, b)
    np.testing.assert_allclose(np_(y_t), y_jnp, rtol=2e-5, atol=2e-4)
    np.testing.assert_allclose(np_(y_t), y_pal, rtol=2e-5, atol=2e-4)


def _numpy_matvec(bands, offsets, x):
    """y[i] = sum_k B_k[i] @ x[i + d_k], x zero outside [0, n), in f64."""
    n, b = x.shape
    y = np.zeros((n, b))
    for k, d in enumerate(offsets):
        for i in range(max(0, -d), min(n, n - d)):
            y[i] += bands[k, :, i].reshape(b, b).astype(np.float64) @ x[i + d]
    return y


@pytest.mark.parametrize("b", [1, 3])
def test_plain_spmv_out_of_range_offsets(b):
    bands, x = _random_matrix(np.random.default_rng(20 + b), b,
                              offsets=OFFSETS_WIDE)
    y_t = tdia.dia_matvec(_torch_matrix(bands, OFFSETS_WIDE, b, N_ROWS),
                          torch.as_tensor(x))
    np.testing.assert_allclose(np_(y_t), _numpy_matvec(bands, OFFSETS_WIDE, x),
                               rtol=2e-5, atol=2e-4)


@pytest.fixture(scope="module")
def flagship_parts():
    """JAX f32 Jacobian parts of the small flagship box, and both
    systems."""
    import jax.numpy as jnp
    from waiwera_tpu.solver.system import MethodCoeffs

    sj = jax_sim()
    st = torch_sim()
    lhs0, _, _ = sj.lhs_at(sj.y0, sj.region0)
    coeffs = MethodCoeffs(c_lhs=jnp.asarray(1.0), dt_eff=jnp.asarray(1e4),
                          const=-lhs0)
    parts = sj.system.jacobian_parts(
        sj.y0, sj.region0, sj.rock, coeffs, jnp.asarray(0.0),
        jnp.asarray(1e4), tangent_dtype=jnp.float32,
    )
    return sj.system, st.system, [np.array(p) for p in parts]


def test_band_fill_and_block_jacobi(flagship_parts):
    import jax.numpy as jnp
    from waiwera_tpu.ops import dia as jdia
    from waiwera_tpu.solver.smallblocks import invert_blocks_em as jinv
    from waiwera_tpu_torch.solver.smallblocks import invert_blocks_em as tinv

    js, ts, parts = flagship_parts
    assert ts.dia.offsets == tuple(js.dia.offsets)
    n = ts.dia.num_rows
    mj = jdia.bands_from_blocks(js.dia, js.band_plan,
                                *(jnp.asarray(p) for p in parts))
    mt = tdia.bands_from_blocks(ts.dia, ts.band_fill,
                                *(torch.as_tensor(p) for p in parts))
    assert tuple(mt.bands.shape) == (len(ts.dia.offsets), 9, n)
    np.testing.assert_array_equal(np_(mt.bands),
                                  np.asarray(mj.bands)[:, :, :n])

    # SpMV of the filled operator and the block-Jacobi apply
    x = np.random.default_rng(2).standard_normal((n, 3)).astype(np.float32)
    np.testing.assert_allclose(
        np_(tdia.dia_matvec(mt, torch.as_tensor(x))),
        np.asarray(jdia.jnp_matvec(mj, jnp.asarray(x))),
        rtol=2e-5, atol=2e-4 * np.abs(parts[0]).max(),
    )
    pc_j = jdia.dia_block_jacobi_em(jinv(jnp.asarray(parts[0])), jnp.float32)
    pc_t = tdia.dia_block_jacobi_em(tinv(torch.as_tensor(parts[0])),
                                    torch.float32)
    zj = np.asarray(pc_j(jnp.asarray(x)))
    zt = np_(pc_t(torch.as_tensor(x)))
    assert zt.dtype == np.float32
    np.testing.assert_allclose(zt, zj, rtol=1e-4, atol=1e-5 * np.abs(zj).max())


def test_structure_tables(flagship_parts):
    """BSR structure and face block positions equal the JAX package's."""
    from waiwera_tpu.solver import bsr as jbsr
    from waiwera_tpu_torch.solver import bsr as tbsr

    js, ts, _ = flagship_parts
    for f in ("indptr", "indices", "rows", "diag_pos"):
        np.testing.assert_array_equal(getattr(ts.structure, f),
                                      np.asarray(getattr(js.structure, f)))
    fc = np_(ts.mesh.face_cells)
    lr_j, rl_j = jbsr.face_block_positions(js.structure, fc)
    lr_t, rl_t = tbsr.face_block_positions(ts.structure, fc)
    np.testing.assert_array_equal(lr_t, lr_j)
    np.testing.assert_array_equal(rl_t, rl_j)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    bands, x = _random_matrix(np.random.default_rng(1), 3)
    m = _torch_matrix(bands, OFFSETS, 3, N_ROWS)
    with pytest.raises(ValueError):
        # x on a device that is neither the CPU nor CUDA
        tdia.dia_matvec(m, torch.as_tensor(x, device="meta"))
    for xd, bd in ((torch.float64, torch.float32),
                   (torch.float32, torch.float64),
                   (torch.float16, torch.float16),
                   (torch.bfloat16, torch.bfloat16)):
        with pytest.raises(TypeError):
            tdia.dia_matvec(m._replace(bands=m.bands.to(bd)),
                            torch.as_tensor(x).to(xd))


@pytest.mark.parametrize("b", [1, 3])
def test_plain_spmv_f64_matches_jax(b):
    import jax.numpy as jnp
    from waiwera_tpu.ops import dia as jdia

    rng = np.random.default_rng(40 + b)
    bands = rng.standard_normal((len(OFFSETS), b * b, N_ROWS))
    x = rng.standard_normal((N_ROWS, b))
    mj = jdia.DIAMatrix(offsets=OFFSETS, bands=jnp.asarray(bands),
                        block_size=b, num_rows=N_ROWS)
    y_t = tdia.dia_matvec(_torch_matrix(bands, OFFSETS, b, N_ROWS),
                          torch.as_tensor(x))
    assert y_t.dtype == torch.float64
    np.testing.assert_allclose(np_(y_t),
                               np.asarray(jdia.jnp_matvec(mj, jnp.asarray(x))),
                               rtol=1e-13, atol=1e-13)


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 2, 3, 4])
def test_cuda_kernel_matches_plain(b):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    bands, x = _random_matrix(np.random.default_rng(30 + b), b, n=4099,
                              offsets=OFFSETS_WIDE)
    m = _torch_matrix(bands, OFFSETS_WIDE, b, 4099, device="cuda")
    xc = torch.as_tensor(x, device="cuda")
    before = tdia.dia_spmv_launches.count
    y = tdia.dia_matvec(m, xc)
    torch.cuda.synchronize()
    assert tdia.dia_spmv_launches.count == before + 1
    y_ref = tdia.dia_matvec_reference(m, xc)
    scale = float(y_ref.abs().max())
    torch.testing.assert_close(y, y_ref, rtol=1e-5, atol=1e-5 * scale)


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 2, 3, 4])
def test_cuda_f64_kernel_matches_plain(b):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    rng = np.random.default_rng(50 + b)
    bands = rng.standard_normal((len(OFFSETS_WIDE), b * b, 4099))
    x = torch.as_tensor(rng.standard_normal((4099, b)), device="cuda")
    m = _torch_matrix(bands, OFFSETS_WIDE, b, 4099, device="cuda")
    before = tdia.dia_spmv_f64_launches.count
    y = tdia.dia_matvec(m, x)
    torch.cuda.synchronize()
    assert tdia.dia_spmv_f64_launches.count == before + 1
    assert y.dtype == torch.float64
    y_ref = tdia.dia_matvec_reference(m, x)
    scale = float(y_ref.abs().max())
    torch.testing.assert_close(y, y_ref, rtol=1e-12, atol=1e-12 * scale)
