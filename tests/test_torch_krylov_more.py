"""LGMRES and BiCGStab(l) of waiwera_tpu_torch against the JAX package's,
on the cases of tests/test_solver.py (:84 lgmres and its augment=0
reduction to GMRES, :103 the f32 basis, :165 lgmres with block-Jacobi,
:178 and :189 bicgstab_l, :202 the dispatch of every method): the same
iteration count and convergence, x at rtol 1e-8, and the host syncs and
matvecs the port counts; bicgstab_l with an exact or near-exact lu
preconditioner (ROADMAP C16)."""

import warnings

import numpy as np
import pytest
import torch

from test_torch_bsr_precond import laplacian_pair
from torch_parity import np_


def _case(n, b, seed):
    """(JAX matrix, port matvec, port matrix, b as numpy, x*)."""
    import jax.numpy as jnp
    from waiwera_tpu_torch.ops import ell

    mj, mt = laplacian_pair(n, b)
    xstar = np.random.default_rng(seed).standard_normal((n, b))
    rhs = np.array(mj.matvec(jnp.asarray(xstar)))
    mv = ell.to_ell(mt, ell.ell_structure(mt.structure)).matvec
    return mj, mv, mt, rhs, xstar


def _same(rt, rj, xstar):
    assert rt.converged and bool(rj.converged)
    assert rt.iterations == int(rj.iterations)
    xj = np.asarray(rj.x)
    np.testing.assert_allclose(np_(rt.x), xstar, rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(np_(rt.x), xj, rtol=1e-8,
                               atol=1e-10 * np.abs(xj).max())


@pytest.mark.parametrize("n, b, seed, restart, augment, pc", [
    (60, 2, 7, 8, 2, None),
    (60, 2, 7, 8, 0, None),
    (50, 3, 8, 10, 3, "bjacobi"),
], ids=["augment2", "augment0", "bjacobi_augment3"])
def test_lgmres_matches_jax(n, b, seed, restart, augment, pc):
    import jax.numpy as jnp
    from waiwera_tpu.solver import krylov as jk
    from waiwera_tpu.solver import precond as jp
    from waiwera_tpu_torch.solver import krylov as tk
    from waiwera_tpu_torch.solver import precond as tp

    mj, mv, mt, rhs, xstar = _case(n, b, seed)
    pj = jp.block_jacobi(mj) if pc else None
    pt = tp.block_jacobi(mt) if pc else None
    rj = jk.lgmres(b=jnp.asarray(rhs), matvec=mj.matvec, precond=pj,
                   rtol=1e-10, restart=restart, augment=augment,
                   max_restarts=200)
    rt = tk.lgmres(mv, torch.as_tensor(rhs), precond=pt, rtol=1e-10,
                   restart=restart, augment=augment, max_restarts=200)
    _same(rt, rj, xstar)
    cycles = -(-rt.iterations // restart)
    assert rt.host_syncs == 1 + 2 * cycles
    assert rt.matvecs == 1 + cycles * (restart + 1)
    if augment == 0:
        # with no augmentation LGMRES is restarted GMRES
        rg = tk.gmres(mv, torch.as_tensor(rhs), rtol=1e-10, restart=restart,
                      max_restarts=200)
        assert rg.iterations == rt.iterations
        torch.testing.assert_close(rg.x, rt.x, rtol=0, atol=0)


def test_lgmres_f32_basis_matches_jax():
    """tests/test_solver.py:103's lgmres part: an f32-stored basis
    converges to the full-precision solution, with no FutureWarning from
    the basis update (ROADMAP C7: the port casts explicitly)."""
    import jax.numpy as jnp
    from waiwera_tpu.solver import krylov as jk
    from waiwera_tpu_torch.solver import krylov as tk

    mj, mv, _, rhs, xstar = _case(60, 2, 21)
    rj = jk.lgmres(b=jnp.asarray(rhs), matvec=mj.matvec, rtol=1e-10,
                   restart=20, augment=2, max_restarts=100,
                   basis_dtype=jnp.float32)
    with warnings.catch_warnings():
        warnings.simplefilter("error", FutureWarning)
        rt = tk.lgmres(mv, torch.as_tensor(rhs), rtol=1e-10, restart=20,
                       augment=2, max_restarts=100,
                       basis_dtype=torch.float32)
    assert rt.converged and bool(rj.converged)
    assert rt.x.dtype == torch.float64
    np.testing.assert_allclose(np_(rt.x), xstar, rtol=1e-6, atol=1e-7)
    assert rt.iterations == int(rj.iterations)
    with pytest.raises(ValueError, match="restart must exceed augment"):
        tk.lgmres(mv, torch.as_tensor(rhs), restart=2, augment=2)


@pytest.mark.parametrize("n, b, seed, ell, pc", [
    (60, 2, 9, 2, None), (70, 3, 10, 4, "ilu"),
], ids=["ell2", "ilu_ell4"])
def test_bicgstab_l_matches_jax(n, b, seed, ell, pc):
    import jax.numpy as jnp
    from waiwera_tpu.solver import krylov as jk
    from waiwera_tpu.solver import precond as jp
    from waiwera_tpu_torch.solver import krylov as tk
    from waiwera_tpu_torch.solver import precond as tp

    mj, mv, mt, rhs, xstar = _case(n, b, seed)
    pj = jp.make_preconditioner(pc, mj) if pc else None
    pt = tp.make_preconditioner(pc, mt) if pc else None
    rj = jk.bicgstab_l(mj.matvec, jnp.asarray(rhs), precond=pj, rtol=1e-10,
                       ell=ell)
    rt = tk.bicgstab_l(mv, torch.as_tensor(rhs), precond=pt, rtol=1e-10,
                       ell=ell)
    _same(rt, rj, xstar)
    sweeps = rt.iterations // ell
    assert rt.host_syncs == sweeps + 1
    assert rt.matvecs == 2 * ell * sweeps


def _lu_pair(mj, mt, eps, seed):
    """Both packages' lu preconditioner of the same matrix, its entries
    scaled by 1 + eps N(0, 1) (numpy seed): exact for eps 0."""
    import jax.numpy as jnp
    from waiwera_tpu.solver import precond as jp
    from waiwera_tpu_torch.solver import precond as tp

    data = np.asarray(mj.data)
    if eps:
        data = data * (1.0 + eps * np.random.default_rng(seed)
                       .standard_normal(data.shape))
    return (jp.lu(mj._replace(data=jnp.asarray(data))),
            tp.lu(mt._replace(data=torch.as_tensor(data))))


@pytest.mark.parametrize("n, b, seed, ell, eps", [
    (60, 2, 9, 1, 0.0), (70, 3, 10, 1, 0.0), (60, 2, 9, 2, 1e-6),
    (70, 3, 10, 2, 1e-4), (40, 4, 3, 4, 1e-4), (50, 3, 1, 4, 1e-4),
], ids=["exact_ell1", "exact_ell1_b3", "near_ell2", "near_ell2_b3",
        "near_ell4_b4", "near_ell4_b3"])
def test_bicgstab_l_exact_preconditioner_matches_jax(n, b, seed, ell, eps):
    """bicgstab_l with lu of the matrix itself (ell 1) or of the matrix
    perturbed by eps (ell 2 and 4), where both packages are stable: one
    sweep in both, and x at rtol 1e-8."""
    import jax.numpy as jnp
    from waiwera_tpu.solver import krylov as jk
    from waiwera_tpu_torch.solver import krylov as tk

    mj, mv, mt, rhs, xstar = _case(n, b, seed)
    pj, pt = _lu_pair(mj, mt, eps, seed + 100)
    rj = jk.bicgstab_l(mj.matvec, jnp.asarray(rhs), precond=pj, rtol=1e-10,
                       ell=ell)
    rt = tk.bicgstab_l(mv, torch.as_tensor(rhs), precond=pt, rtol=1e-10,
                       ell=ell)
    _same(rt, rj, xstar)
    assert rt.iterations == ell


@pytest.mark.parametrize("n, b, seed, ell", [
    (60, 2, 9, 2), (70, 3, 10, 2), (40, 4, 3, 4),
], ids=["ell2", "ell2_b3", "ell4_b4"])
def test_bicgstab_l_exact_preconditioner_follows_round_off(n, b, seed, ell):
    """ROADMAP C16, a reference fault the port keeps: with lu of the
    matrix itself the first BiCG step solves the system to round-off,
    and for ell >= 2 the next step divides round-off by round-off
    before the residual is tested, so neither package stops after its
    first sweep (ell = 1, tested before the second step, does)."""
    import jax.numpy as jnp
    from waiwera_tpu.solver import krylov as jk
    from waiwera_tpu_torch.solver import krylov as tk

    mj, mv, mt, rhs, xstar = _case(n, b, seed)
    pj, pt = _lu_pair(mj, mt, 0.0, 0)
    for res in (jk.bicgstab_l(mj.matvec, jnp.asarray(rhs), precond=pj,
                              rtol=1e-10, ell=ell),
                tk.bicgstab_l(mv, torch.as_tensor(rhs), precond=pt,
                              rtol=1e-10, ell=ell)):
        assert int(res.iterations) > ell
    one = tk.bicgstab_l(mv, torch.as_tensor(rhs), precond=pt, rtol=1e-10,
                        ell=1)
    assert one.converged and one.iterations == 1


@pytest.mark.parametrize("method", ["bcgs", "gmres", "lgmres", "bcgsl",
                                    "bicgstabl"])
def test_solve_dispatch_all_methods_matches_jax(method):
    """tests/test_solver.py:202: every KSP name through solve()."""
    import jax.numpy as jnp
    from waiwera_tpu.solver import krylov as jk
    from waiwera_tpu_torch.solver import krylov as tk

    mj, mv, _, rhs, xstar = _case(40, 2, 11)
    rj = jk.solve(method, mj.matvec, jnp.asarray(rhs), rtol=1e-10)
    rt = tk.solve(method, mv, torch.as_tensor(rhs), rtol=1e-10)
    _same(rt, rj, xstar)
