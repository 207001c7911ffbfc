"""GMRES and LGMRES as device pieces (solver/krylov.py gmres_solve,
lgmres_solve) on the CPU: the device Hessenberg least squares
(solver/smallblocks.py hessenberg_lstsq_res) against the JAX package's
on seeded Hessenbergs, f64, rtol 1e-12; each solver on a block ELL
system with block-Jacobi built inside its first piece, through the graph
program with the CPU stand-in for CUDA graphs (EmulatedGraphs, under the
guard that fails on host reads) bitwise equal to the eager program, with
equal iterations, matvecs and host reads (1 + cycles), and against the
JAX package's gmres/lgmres at tests/test_torch_krylov_more.py's
tolerances, with the basis in f64 and in f32; the gate of the graph
program (sim/simulation.py step_program_mode) by route, method and
preconditioner, Newton refusing a distributed System in a graph
program, and the bench's stage breakdown composed in graph mode."""

import time
import types

import numpy as np
import pytest
import torch

from test_torch_bsr_precond import laplacian_pair
from test_torch_graph_program import EmulatedGraphs
from torch_parity import build_sim, np_


def _hessenberg(m, seed, zero=None):
    """A seeded [m+1, m] upper Hessenberg with positive subdiagonal; zero
    = ("sub", j) zeroes its subdiagonal entry in column j (a lucky
    breakdown: the residual is 0 from there on), ("col", j) the whole
    column j (both 1e-300 guards: no rotation, and a zero pivot)."""
    rng = np.random.default_rng(seed)
    H = np.triu(rng.standard_normal((m + 1, m)), -1)
    H[np.arange(1, m + 1), np.arange(m)] = rng.uniform(0.1, 2.0, m)
    if zero is not None:
        kind, j = zero
        if kind == "sub":
            H[j + 1, j] = 0.0
        else:
            H[:, j] = 0.0
    return H, float(rng.uniform(0.5, 3.0))


@pytest.mark.parametrize("m, seed, zero", [
    (1, 0, None), (5, 1, None), (30, 2, None), (8, 3, ("sub", 3)),
    (8, 4, ("col", 5)),
], ids=["m1", "m5", "m30", "zero_subdiagonal", "zero_column"])
def test_hessenberg_lstsq_res_matches_jax(m, seed, zero):
    import jax.numpy as jnp
    from waiwera_tpu.solver.smallblocks import hessenberg_lstsq_res as jres
    from waiwera_tpu_torch.solver.smallblocks import hessenberg_lstsq_res

    H, beta = _hessenberg(m, seed, zero)
    yj, rj = jres(jnp.asarray(H), jnp.asarray(beta), m)
    yt, rt = hessenberg_lstsq_res(torch.as_tensor(H),
                                  torch.tensor(beta, dtype=torch.float64), m)
    assert yt.dtype == rt.dtype == torch.float64
    np.testing.assert_allclose(np_(yt), np.asarray(yj), rtol=1e-12,
                               atol=1e-12 * np.abs(np.asarray(yj)).max())
    np.testing.assert_allclose(np_(rt), np.asarray(rj), rtol=1e-12,
                               atol=1e-300)
    if zero is not None:
        j = zero[1]
        assert np.all(np_(rt)[j:] == 0.0) and np.all(np_(rt)[:j] > 0.0)
        if zero[0] == "col":
            assert float(yt[j]) == 0.0


def _ell_case(n=50, b=3, seed=8):
    """The block Laplacian of test_torch_bsr_precond as the JAX package's
    BSR matrix and the port's ELL data, with a right-hand side."""
    import jax.numpy as jnp
    from waiwera_tpu_torch.ops import ell

    mj, mt = laplacian_pair(n, b)
    es = ell.ell_structure(mt.structure)
    xstar = np.random.default_rng(seed).standard_normal((n, b))
    rhs = np.array(mj.matvec(jnp.asarray(xstar)))
    return mj, mt, es, rhs


def _solve(program, method, mt, es, data, rhs, basis_dtype):
    """One solve through `program`: the ELL matvec and block-Jacobi on
    the staged BSR data, built inside the solve's first piece."""
    from waiwera_tpu_torch.ops import ell
    from waiwera_tpu_torch.solver import bsr, krylov, precond

    def setup(data, b):
        mat = bsr.BSRMatrix(mt.structure, data, mt.diag_pos)
        return ell.to_ell(mat, es).matvec, precond.block_jacobi(mat), b

    args = program.stage("in", (data, rhs))
    kw = dict(rtol=1e-10, restart=10, max_restarts=200,
              basis_dtype=basis_dtype)
    if method == "gmres":
        res = krylov.gmres_solve(program, setup, *args, **kw)
    else:
        res = krylov.lgmres_solve(program, setup, *args, augment=3, **kw)
    return res._replace(x=program.hand_out(res.x))


@pytest.mark.parametrize("method", ["gmres", "lgmres"])
@pytest.mark.parametrize("basis", ["f64", "f32"])
def test_program_solve_graph_equals_eager_and_jax(method, basis):
    import jax.numpy as jnp
    from waiwera_tpu.solver import krylov as jk
    from waiwera_tpu.solver import precond as jp
    from waiwera_tpu_torch.solver.program import Program

    basis_dtype = torch.float32 if basis == "f32" else None
    mj, mt, es, rhs = _ell_case()
    graph = Program(EmulatedGraphs())
    # two right-hand sides through one captured program: the second
    # replays the first one's pieces on the new staged values
    for scale in (1.0, -0.5):
        b = torch.as_tensor(rhs * scale)
        rg = _solve(graph, method, mt, es, mt.data, b, basis_dtype)
        re_ = _solve(Program(), method, mt, es, mt.data, b, basis_dtype)
        assert torch.equal(rg.x, re_.x)
        for k in ("iterations", "converged", "matvecs", "host_syncs"):
            assert getattr(rg, k) == getattr(re_, k), k
        cycles = -(-rg.iterations // 10)
        assert rg.host_syncs == 1 + cycles
        assert rg.matvecs == 1 + cycles * 11
    assert graph.captures == 2 and graph.replays > 2

    kw = dict(precond=jp.block_jacobi(mj), rtol=1e-10, restart=10,
              max_restarts=200,
              basis_dtype=jnp.float32 if basis_dtype else None)
    bj = jnp.asarray(rhs * -0.5)
    rj = (jk.gmres(mj.matvec, bj, **kw) if method == "gmres"
          else jk.lgmres(b=bj, matvec=mj.matvec, augment=3, **kw))
    assert rg.converged and bool(rj.converged)
    if basis == "f64":
        assert rg.iterations == int(rj.iterations)
        rtol = 1e-8
    else:
        # tests/test_torch_gmres.py: the f32 basis rounds the directions
        assert abs(rg.iterations - int(rj.iterations)) <= 1
        rtol = 1e-6
    xj = np.asarray(rj.x)
    np.testing.assert_allclose(np_(rg.x), xj, rtol=rtol,
                               atol=rtol * np.abs(xj).max())


def _system(route, distributed=False):
    """What step_program_mode reads of a System: a CUDA device (no card
    is touched), the route and the rank count."""
    bands = None if route == "ell" else object()
    return types.SimpleNamespace(
        mesh=types.SimpleNamespace(is_ghost=types.SimpleNamespace(
            device=torch.device("cuda"))),
        distributed=distributed, bands=bands)


@pytest.mark.parametrize("route, method, pc, mode", [
    ("band", "bcgs", "bjacobi", "graph"),
    ("band", "gmres", "asm", "graph"),
    ("hybrid", "lgmres", "dilu", "graph"),
    ("ell", "lgmres", "asm", "graph"),
    ("ell", "bcgs", "none", "graph"),
    ("ell", "gmres", "line", "graph"),
    ("ell", "lgmres", "cpr", "graph"),
    ("band", "bcgs", "line", "graph"),
    ("band", "gmres", "cpr", "graph"),
    ("ell", "lgmres", "lu", "graph"),
    ("band", "bcgsl", "asm", "graph"),
    ("ell", "bcgsl", "bjacobi", "graph"),
    ("ranks", "bcgs", "bjacobi", "eager"),
])
def test_step_program_mode_table(route, method, pc, mode):
    from waiwera_tpu_torch.bench import newton_params
    from waiwera_tpu_torch.sim.simulation import step_program_mode

    system = _system("band" if route == "ranks" else route,
                     distributed=route == "ranks")
    params = newton_params(pc)._replace(linear_method=method)
    assert step_program_mode(system, params) == mode


@pytest.mark.parametrize("method, pc", [("bcgsl", "bjacobi"),
                                        ("bcgs", "lu"), ("gmres", "line")])
def test_newton_refuses_eager_methods_in_a_graph_program(method, pc):
    """A distributed System (ranks) raises in a graph program rather
    than running eagerly, whatever its method and preconditioner."""
    from waiwera_tpu_torch.bench import newton_params
    from waiwera_tpu_torch.solver.newton import newton_solve
    from waiwera_tpu_torch.solver.program import Program

    params = newton_params(pc)._replace(linear_method=method)
    with pytest.raises(ValueError, match="distributed System runs eagerly"):
        newton_solve(_system("band", distributed=True), None, None, None,
                     None, None, 0.0, 1.0e5, None, params=params,
                     program=Program(EmulatedGraphs()))


def test_stage_breakdown_in_graph_mode(monkeypatch):
    """The bench's stages in the step's mode (C20): through graph
    programs on the stand-in, the capped Newton body executes one chunk
    (krylov.CHUNK iterations, 1 of them unmasked) and the stage sum is
    composed from the executed iterations; the eager stage times are kept
    beside them."""
    from waiwera_tpu_torch import bench
    from waiwera_tpu_torch.sim import simulation
    from waiwera_tpu_torch.solver import krylov, program

    monkeypatch.setattr(simulation, "step_program_mode",
                        lambda system, params: "graph")
    monkeypatch.setattr(program, "CudaGraphs", EmulatedGraphs)
    sim = build_sim(5, 4, 3, "cpu")
    step = bench.make_step(sim)
    assert step.program_mode == "graph"
    lhs0, fluid0, _ = sim.lhs_at(sim.y0, sim.region0)
    fx0 = sim.initial_fluxes(sim.y0, sim.region0)
    t = time.perf_counter()
    res = step(sim.y0, sim.region0, fluid0.temperature, lhs0, lhs0, 0.0,
               1.0e4, 1.0e4, 1.0, fluid_last=fluid0, fluxes_last=fx0)[0]
    t = time.perf_counter() - t
    assert res.converged and res.masked_iterations > 0
    its, lin_its, masked = (res.iterations, res.linear_iterations,
                            res.masked_iterations)
    out = bench.stage_breakdown(sim, "bjacobi", t, its, lin_its, masked)
    assert out["stage_program"] == "graph"
    assert out["newton_body_executed_iterations"] == krylov.CHUNK
    assert out["linear_solve_executed_iterations_one"] % krylov.CHUNK == 0
    assert out["linear_solve_executed_iterations_one"] >= \
        out["linear_solve_iterations_one"] > 0
    for k in ("initial_residual", "linear_solve", "newton_body"):
        assert out[f"{k}_seconds"] > 0.0 and out[f"{k}_eager_seconds"] > 0.0
    e_step = lin_its + masked
    want = (out["initial_residual_seconds"]
            + its * out["newton_body_seconds"]
            + max(e_step - its * krylov.CHUNK, 0)
            * out["linear_solve_seconds"]
            / out["linear_solve_executed_iterations_one"])
    assert out["stage_sum_seconds"] == pytest.approx(want, rel=1e-12)
    assert out["stage_vs_step"] == pytest.approx(want / t, rel=1e-12)
