"""The timestep try as device pieces (solver/program.py) against the JAX
package, on the CPU:

- System.jacobian_parts with one primal per chain (torch.func.vmap over
  the seeds of one torch.func.jvp) against the JAX package's
  jax.linearize parts on tests/test_solver.py's _rect_system(5, 4, 3)
  ("we") and the flagship box ("wge"), at a perturbed two-phase state:
  f64 rtol 1e-12, f32 rtol 2e-5 / atol 2e-4 (tests/test_solver.py:723),
  both of each block's largest entry; against per-seed jvps written
  here, f64 rtol 1e-13; the cell chain's primal runs once;
- the chunked BiCGStab at chunk sizes 1, 3, 8 and 64 against the JAX
  package's lax.while_loop bicgstab: equal iteration counts, x within
  f64 rtol 1e-10, matvecs = 1 + 2 rounds + 2 (iterations + masked);
  iterations after convergence leave the state bitwise unchanged;
- method_coeffs with 0-d tensor times against the float formulas.

The pieces replayed as graphs are in test_torch_graph_program.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_bsr_precond import laplacian_pair
from torch_parity import (build_sim, jax_sim, np_, rect_system_pair,
                          two_phase_state)

DT = 1.0e4


# -- Jacobian parts ----------------------------------------------------


@pytest.fixture(scope="module", params=["we", "wge"])
def eos_pair(request):
    if request.param == "we":
        sj, st = rect_system_pair(5, 4, 3)
    else:
        sj, st = jax_sim(), build_sim(5, 4, 3, "cpu")
    y, region = two_phase_state(sj)
    return sj, st, y, region


def _coeffs(sj, st):
    from waiwera_tpu.solver.system import MethodCoeffs as JCoeffs
    from waiwera_tpu_torch.solver.system import MethodCoeffs as TCoeffs

    lhs0, _, _ = sj.lhs_at(sj.y0, sj.region0)
    cj = JCoeffs(c_lhs=jnp.asarray(1.0), dt_eff=jnp.asarray(DT),
                 const=-lhs0)
    ct = TCoeffs(c_lhs=torch.tensor(1.0, dtype=torch.float64),
                 dt_eff=torch.tensor(DT, dtype=torch.float64),
                 const=-torch.as_tensor(np.array(lhs0)))
    return cj, ct


def _close(pt, pj, rtol, atol):
    for a, b, name in zip(pt, pj, ("diag", "J_lr", "J_rl")):
        a = np_(a).astype(np.float64)
        b = np.asarray(b).astype(np.float64)
        assert a.shape == b.shape and np.isfinite(a).all(), name
        scale = np.abs(b).max(axis=0, keepdims=True) + 1e-30
        np.testing.assert_allclose(a / scale, b / scale, rtol=rtol,
                                   atol=atol, err_msg=name)


@pytest.mark.parametrize("dtype", ["f64", "f32"])
def test_jacobian_parts_one_primal_matches_jax(eos_pair, dtype,
                                               monkeypatch):
    sj, st, y, region = eos_pair
    cj, ct = _coeffs(sj, st)
    system = st.system
    calls = []
    derived = system.derived_state
    monkeypatch.setattr(system, "derived_state",
                        lambda *a: calls.append(1) or derived(*a))
    tdt = torch.float32 if dtype == "f32" else None
    pt = system.jacobian_parts(
        torch.as_tensor(y), torch.as_tensor(region), st.rock, ct,
        torch.tensor(0.0, dtype=torch.float64),
        torch.tensor(DT, dtype=torch.float64), tangent_dtype=tdt)
    # one primal of the cell chain per Jacobian (1 + npv before)
    assert len(calls) == 1
    assert all(p.dtype == (tdt or torch.float64) for p in pt)
    jdt = jnp.float32 if dtype == "f32" else None
    pj = jax.jit(lambda yy, rr: sj.system.jacobian_parts(
        yy, rr, sj.rock, cj, jnp.asarray(0.0), jnp.asarray(DT),
        tangent_dtype=jdt))(jnp.asarray(y), jnp.asarray(region))
    if dtype == "f32":
        _close(pt, pj, 2e-5, 2e-4)
    else:
        _close(pt, pj, 1e-12, 1e-12)


def _per_seed_parts(system, y, region, rock, coeffs, t0, t1):
    """The Jacobian parts from one jvp per seed (a primal each): npv
    jvps of the cell chain, npv of the flux against each side."""
    from waiwera_tpu_torch.physics import assembly

    npv = system.npv
    mesh = system.mesh
    n = mesh.num_cells
    cl, cr = system.cl, system.cr
    fluid, cond, _ = system.derived_state(y, region, rock)
    cond = fluid.pressure.new_zeros(n) if cond is None else cond

    def cell_chain(yv):
        f, c, _ = system.derived_state(yv, region, rock)
        c = f.pressure.new_zeros(n) if c is None else c
        return (f.float_fields(), c, system.lhs(f, rock),
                system.source_term(f, t0, t1))

    seeds = [torch.zeros_like(y).index_fill(1, torch.tensor([v]), 1.0)
             for v in range(npv)]
    tang = [torch.func.jvp(cell_chain, (y,), (s,))[1] for s in seeds]
    perm_l, perm_r = assembly.face_permeability_sides(rock, mesh)
    fl, fr = fluid.index(cl), fluid.index(cr)
    iso = system.isothermal

    def flux(a, b, c_l, c_r):
        return system._flux_pairs(
            fl.with_float_fields(a), fr.with_float_fields(b), perm_l, perm_r,
            None if iso else c_l, None if iso else c_r, mesh)[:, :npv]

    prim = (fl.float_fields(), fr.float_fields(), cond[cl], cond[cr])
    zl = tuple(torch.zeros_like(a) for a in prim[0])
    zc = torch.zeros_like(prim[2])
    dl, dr = [], []
    for df, dc, _, _ in tang:
        dl.append(torch.func.jvp(flux, prim, (
            tuple(a[cl] for a in df), zl, dc[cl], zc))[1])
        dr.append(torch.func.jvp(flux, prim, (
            zl, tuple(a[cr] for a in df), zc, dc[cr]))[1])
    dL = torch.stack([t[2] for t in tang])
    dq = torch.stack([t[3] for t in tang])
    dflux_l, dflux_r = torch.stack(dl), torch.stack(dr)
    c, d = coeffs.c_lhs, coeffs.dt_eff
    area = mesh.face_area
    vol = torch.where(mesh.cell_volume > 0.0, mesh.cell_volume, 1.0)
    av_l, av_r = area / vol[cl], area / vol[cr]
    g_l, g_r = mesh.is_ghost[cl], mesh.is_ghost[cr]
    both = g_l | g_r
    idx = [(i, v) for i in range(npv) for v in range(npv)]
    diag2 = torch.stack([c * dL[v][:, i] - d * dq[v][:, i] for i, v in idx])
    cl2 = torch.stack([torch.where(g_l, 0.0, d * av_l * dflux_l[v][:, i])
                       for i, v in idx])
    cr2 = torch.stack([torch.where(g_r, 0.0, -d * av_r * dflux_r[v][:, i])
                       for i, v in idx])
    diag2 = mesh.face_sum.add(diag2, torch.cat([cl2, cr2], 1), dim=1)
    eye2 = torch.eye(npv, dtype=y.dtype).reshape(-1, 1)
    diag2 = torch.where(mesh.is_ghost[None, :], eye2, diag2)
    lr2 = torch.stack([torch.where(both, 0.0, d * av_l * dflux_r[v][:, i])
                       for i, v in idx])
    rl2 = torch.stack([torch.where(both, 0.0, -d * av_r * dflux_l[v][:, i])
                       for i, v in idx])
    return diag2, lr2, rl2


def test_jacobian_parts_match_per_seed_jvps(eos_pair):
    sj, st, y, region = eos_pair
    _, ct = _coeffs(sj, st)
    yt, rt = torch.as_tensor(y), torch.as_tensor(region)
    t0 = torch.tensor(0.0, dtype=torch.float64)
    t1 = torch.tensor(DT, dtype=torch.float64)
    got = st.system.jacobian_parts(yt, rt, st.rock, ct, t0, t1)
    want = _per_seed_parts(st.system, yt, rt, st.rock, ct, t0, t1)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-13, atol=1e-13 * float(
            b.abs().max()))


# -- chunked BiCGStab ---------------------------------------------------


@pytest.fixture(scope="module")
def linear_pair():
    from waiwera_tpu.solver import precond as jp
    from waiwera_tpu_torch.solver import precond as tp

    mj, mt = laplacian_pair(40, 3, seed=3)
    rhs = np.random.default_rng(9).standard_normal((40, 3))
    return (mj, jp.block_jacobi(mj), mt, tp.block_jacobi(mt), rhs)


@pytest.mark.parametrize("chunk", [1, 3, 8, 64])
def test_bicgstab_chunks_match_jax(linear_pair, chunk, monkeypatch):
    from waiwera_tpu.solver import krylov as jk
    from waiwera_tpu_torch.solver import krylov as tk

    mj, pj, mt, pt, rhs = linear_pair
    monkeypatch.setattr(tk, "CHUNK", chunk)
    rj = jk.bicgstab(mj.matvec, jnp.asarray(rhs), precond=pj, rtol=1e-10)
    rt = tk.bicgstab(mt.matvec, torch.as_tensor(rhs), precond=pt,
                     rtol=1e-10)
    assert rt.converged and bool(rj.converged)
    assert rt.iterations == int(rj.iterations)
    np.testing.assert_allclose(np_(rt.x), np.asarray(rj.x), rtol=1e-10,
                               atol=1e-10 * np.abs(np.asarray(rj.x)).max())
    assert (rt.iterations + rt.masked_iterations) % chunk == 0
    assert rt.masked_iterations < chunk
    rounds = 1
    assert rt.matvecs == 1 + 2 * rounds + 2 * (rt.iterations
                                               + rt.masked_iterations)
    # one read per chunk and one per round
    assert rt.host_syncs == (rt.iterations + rt.masked_iterations) \
        // chunk + rounds


def test_bicgstab_masked_iterations_change_nothing(linear_pair):
    from waiwera_tpu_torch.solver import krylov as tk

    _, _, mt, pt, rhs = linear_pair
    solver = tk._BiCGStab(1e-10, tk.DEFAULT_ATOL, 1000, tk._identity, 64)
    ops, st, flags = solver.start(
        lambda: (mt.matvec, pt, torch.as_tensor(rhs)))
    active, k, go, _ = flags.tolist()
    assert not active and go and 0 < k < 64
    after, _ = solver.iterations(st, ops)
    for a, b in zip(st, after):
        assert torch.equal(a, b)


def test_bicgstab_breakdown_stays_masked():
    """A zero right-hand side: no round runs, x stays 0, and the masked
    iterations' NaNs (0/0 without the safe divisions) never reach x."""
    from waiwera_tpu_torch.solver import krylov as tk

    b = torch.zeros(6, 2, dtype=torch.float64)
    res = tk.bicgstab(lambda v: 2.0 * v, b)
    assert res.iterations == 0 and res.converged
    assert torch.equal(res.x, torch.zeros_like(b))
    assert res.matvecs == 2 + 2 * tk.CHUNK


# -- method coefficients -------------------------------------------------


def _float_coeffs(method, dt, dt_last, first, l1, l2):
    if method == "directss":
        return 0.0, -1.0, torch.zeros_like(l1)
    if method == "bdf2" and not first > 0.5:
        r = dt / dt_last
        return (1.0 + 2.0 * r, dt * (r + 1.0),
                -((r + 1.0) * (r + 1.0)) * l1 + (r * r) * l2)
    return 1.0, dt, -l1


@pytest.mark.parametrize("method,first", [
    ("beuler", 0.0), ("bdf2", 1.0), ("bdf2", 0.0), ("directss", 0.0)])
def test_method_coeffs_tensor_times(method, first):
    from waiwera_tpu_torch.solver.system import method_coeffs

    rng = np.random.default_rng(2)
    l1 = torch.as_tensor(rng.standard_normal((7, 3)))
    l2 = torch.as_tensor(rng.standard_normal((7, 3)))
    dt, dt_last = 3.7e4, 1.3e4
    got = method_coeffs(method, torch.tensor(dt, dtype=torch.float64),
                        torch.tensor(dt_last, dtype=torch.float64),
                        torch.tensor(first, dtype=torch.float64), l1, l2)
    c, d, const = _float_coeffs(method, dt, dt_last, first, l1, l2)
    assert got.c_lhs.dim() == 0 and got.dt_eff.dim() == 0
    assert float(got.c_lhs) == c and float(got.dt_eff) == d
    assert torch.equal(got.const, const)
