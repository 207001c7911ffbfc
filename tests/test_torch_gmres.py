"""Restarted GMRES of waiwera_tpu_torch against the JAX package's, on
the cases of tests/test_solver.py (:74 f64, :301 f32, :130 the f32
Arnoldi basis, :103 the tracer solve's basis memory policy), at the JAX
tests' tolerances: the same solution, the same inner iteration count,
no FutureWarning from the f32 basis update (ROADMAP C7), and one host
sync at the start plus one per restart cycle (the least squares runs on
the device)."""

import warnings

import numpy as np
import pytest
import torch


def _laplacian(n, b, seed=0):
    """tests/test_solver.py laplacian_1d as dense matrices: the JAX
    package's BSR matrix and its dense numpy form."""
    import jax.numpy as jnp
    from waiwera_tpu.solver import bsr

    rng = np.random.default_rng(seed)
    face_cells = np.stack([np.arange(n - 1), np.arange(1, n)], axis=1)
    structure = bsr.build_structure(n, face_cells, b)
    base = 2.0 * np.eye(b) + 0.1 * rng.standard_normal((b, b))
    diag = np.stack([base * (2.0 + 0.05 * i) for i in range(n)])
    off = -np.tile(np.eye(b), (n - 1, 1, 1)) * 0.9
    pos_lr, pos_rl = bsr.face_block_positions(structure, face_cells)
    mat = bsr.assemble(structure, jnp.asarray(diag), jnp.asarray(off),
                       jnp.asarray(off), jnp.asarray(pos_lr),
                       jnp.asarray(pos_rl))
    dense = np.zeros((n * b, n * b))
    for i in range(n):
        dense[i * b:(i + 1) * b, i * b:(i + 1) * b] = diag[i]
    for k, (i, j) in enumerate(face_cells):
        dense[i * b:(i + 1) * b, j * b:(j + 1) * b] = off[k]
        dense[j * b:(j + 1) * b, i * b:(i + 1) * b] = off[k]
    return mat, dense


def _torch_matvec(dense, b, dtype):
    A = torch.as_tensor(dense, dtype=dtype)
    return lambda v: (A @ v.reshape(-1)).reshape(-1, b)


@pytest.mark.parametrize("n, b, seed, restart", [
    (40, 2, 4, 20), (60, 2, 21, 8),
], ids=["restart20", "restart8"])
def test_gmres_f64_matches_jax(n, b, seed, restart):
    import jax.numpy as jnp
    from waiwera_tpu.solver import krylov as jk
    from waiwera_tpu_torch.solver import krylov as tk

    mat, dense = _laplacian(n, b)
    xstar = np.random.default_rng(seed).standard_normal((n, b))
    bj = mat.matvec(jnp.asarray(xstar))
    rj = jk.gmres(mat.matvec, bj, rtol=1e-10, restart=restart,
                  max_restarts=200)
    rt = tk.gmres(_torch_matvec(dense, b, torch.float64),
                  torch.as_tensor(np.array(bj)), rtol=1e-10,
                  restart=restart, max_restarts=200)
    assert rt.converged and bool(rj.converged)
    np.testing.assert_allclose(rt.x.numpy(), xstar, rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), rtol=1e-8,
                               atol=1e-10)
    assert rt.iterations == int(rj.iterations)
    cycles = -(-rt.iterations // restart)
    assert rt.host_syncs == 1 + cycles
    assert rt.matvecs == 1 + cycles * (restart + 1)


def test_gmres_float32_matches_jax():
    """tests/test_solver.py:301: an f32 system and solve."""
    import jax.numpy as jnp
    from waiwera_tpu.solver import krylov as jk
    from waiwera_tpu_torch.solver import krylov as tk

    mat, dense = _laplacian(32, 2)
    xstar = np.random.default_rng(8).standard_normal((32, 2))
    b64 = np.asarray(mat.matvec(jnp.asarray(xstar)))
    rt = tk.gmres(_torch_matvec(dense, 2, torch.float32),
                  torch.as_tensor(b64, dtype=torch.float32), rtol=1e-5,
                  restart=16)
    assert rt.x.dtype == torch.float32 and rt.converged
    d32 = jnp.asarray(dense, jnp.float32)
    rj = jk.gmres(lambda v: (d32 @ v.reshape(-1)).reshape(-1, 2),
                  jnp.asarray(b64, jnp.float32), rtol=1e-5, restart=16)
    assert bool(rj.converged)
    r = b64 - (dense @ rt.x.double().numpy().reshape(-1)).reshape(-1, 2)
    assert np.linalg.norm(r) <= 1e-5 * np.linalg.norm(b64) * 1.01
    np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), rtol=1e-4,
                               atol=1e-4)


def test_gmres_f32_basis_matches_jax():
    """tests/test_solver.py:130: the f32-stored Arnoldi basis reaches
    the solution at the same tolerance; H and the updates stay f64, and
    the basis update raises no FutureWarning (ROADMAP C7)."""
    import jax.numpy as jnp
    from waiwera_tpu.solver import krylov as jk
    from waiwera_tpu_torch.solver import krylov as tk

    mat, dense = _laplacian(60, 2)
    xstar = np.random.default_rng(21).standard_normal((60, 2))
    bj = mat.matvec(jnp.asarray(xstar))
    with warnings.catch_warnings():
        warnings.simplefilter("error", FutureWarning)
        rt = tk.gmres(_torch_matvec(dense, 2, torch.float64),
                      torch.as_tensor(np.array(bj)), rtol=1e-10,
                      restart=20, basis_dtype=torch.float32)
    assert rt.converged and rt.x.dtype == torch.float64
    np.testing.assert_allclose(rt.x.numpy(), xstar, rtol=1e-6, atol=1e-7)
    rj = jk.gmres(mat.matvec, bj, rtol=1e-10, restart=20,
                  basis_dtype=jnp.float32)
    assert abs(rt.iterations - int(rj.iterations)) <= 1
    np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), rtol=1e-6,
                               atol=1e-7)


def test_gmres_basis_memory_policy():
    """tests/test_solver.py:103: the tracer solve switches to the f32
    basis exactly when the f64 workspace would exceed the byte cap, and
    a million-dof shifted tridiagonal solve runs through that path."""
    from waiwera_tpu.sim import tracer as jtracer
    from waiwera_tpu_torch.sim.tracer import (
        GMRES_BASIS_BYTES_CAP,
        gmres_basis_dtype,
    )
    from waiwera_tpu_torch.solver import krylov as tk

    assert GMRES_BASIS_BYTES_CAP == jtracer.GMRES_BASIS_BYTES_CAP
    n_edge = GMRES_BASIS_BYTES_CAP // (31 * 8)
    for n in (10_000, 2_000_000, n_edge, n_edge + 1, 524_288 * 2,
              524_288 * 3):
        want = jtracer.gmres_basis_dtype(n, 8)
        got = gmres_basis_dtype(n, 8)
        assert (got is None) == (want is None), n
        assert got in (None, torch.float32)
    # the full-size tracer model: 2 tracers keep the f64 basis, 3 do not
    assert gmres_basis_dtype(524_288 * 2, 8) is None
    assert gmres_basis_dtype(524_288 * 3, 8) == torch.float32

    n = 1_050_000
    xstar = torch.as_tensor(np.random.default_rng(5).standard_normal(n))

    def mv(x):
        return 4.0 * x - torch.roll(x, 1) - torch.roll(x, -1)

    res = tk.gmres(mv, mv(xstar), rtol=1e-8, restart=30,
                   basis_dtype=torch.float32)
    assert res.converged
    assert float(torch.max(torch.abs(res.x - xstar))) < 1e-5


def test_solve_dispatch():
    """solve("gmres") caps the cycles at ceil(max_iterations / restart),
    as the JAX package; lgmres, bcgsl and bicgstabl dispatch to LGMRES and
    BiCGStab(l) and match the JAX package's solve."""
    from waiwera_tpu_torch.solver import krylov as tk

    _, dense = _laplacian(40, 2)
    mv = _torch_matvec(dense, 2, torch.float64)
    b = torch.as_tensor(np.random.default_rng(1).standard_normal((40, 2)))
    res = tk.solve("gmres", mv, b, rtol=1e-12, max_iterations=10, restart=5)
    assert res.matvecs == 1 + 2 * 6 and not res.converged
    res = tk.solve("gmres", mv, b, rtol=1e-10, restart=30)
    assert res.converged
    import jax.numpy as jnp
    from waiwera_tpu.solver import krylov as jk

    mat, _ = _laplacian(40, 2)
    for method in ("lgmres", "bcgsl", "bicgstabl"):
        rt = tk.solve(method, mv, b, rtol=1e-10)
        rj = jk.solve(method, mat.matvec, jnp.asarray(b.numpy()), rtol=1e-10)
        assert rt.converged and bool(rj.converged), method
        assert rt.iterations == int(rj.iterations), method
        np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), rtol=1e-8,
                                   atol=1e-10, err_msg=method)
