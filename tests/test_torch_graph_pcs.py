"""The line, CPR and LU preconditioners and BiCGStab(l) as device pieces
on the CPU, through the graph program with the stand-in for CUDA graphs
(EmulatedGraphs, under the guard that fails on host reads): whole
Timestepper runs bitwise equal to the same runs eagerly with equal counts
(the flagship box on the band route with bcgs + line, gmres + cpr on a
hierarchy of at least two levels, bcgs + lu and bcgsl + asm; the wedge
field on the ELL route with bcgsl + asm; the tetrahedral box with
lgmres + lu); krylov.bicgstab_l_solve through the stand-in bitwise equal
to the eager wrapper and against the JAX package's bicgstab_l at
tests/test_torch_krylov_more.py's tolerances for ell 1, 2 and 4, a
masked sweep changing nothing; the device lu (positions kept, no host
read) against the JAX package's on a seeded BSR matrix, f64, rtol
1e-12."""

import copy
import json

import numpy as np
import pytest
import torch

from chip_smoke import (tet_box_config, wedge_mesh, wedge_model_config,
                        write_gmsh)
from test_torch_bsr_precond import laplacian_pair
from test_torch_graph_program import EmulatedGraphs, no_host_reads
from torch_parity import RecordingLogger, build_sim, np_

F32 = {"dtype": "float32", "jacobian_dtype": "float32"}


def _run(sim_fn, config, monkeypatch, graph):
    """One Timestepper run of `config` on sim_fn()'s Simulation, through
    the stand-in graphs (graph) or eagerly."""
    from waiwera_tpu_torch.sim import simulation
    from waiwera_tpu_torch.sim.timestepper import Timestepper
    from waiwera_tpu_torch.solver import program

    if graph:
        monkeypatch.setattr(simulation, "step_program_mode",
                            lambda system, params: "graph")
        monkeypatch.setattr(program, "CudaGraphs", EmulatedGraphs)
    try:
        ts = Timestepper(copy.deepcopy(config), sim_fn(),
                         logger=RecordingLogger())
        assert ts.run()
    finally:
        monkeypatch.undo()
    return ts


def _same(g, e):
    assert g.tried == e.tried
    assert (g.stats["step_program"], e.stats["step_program"]) == (
        "graph", "eager")
    for k in ("tries", "newton_iterations", "linear_iterations", "matvecs",
              "masked_krylov_iterations", "host_syncs_step"):
        assert g.stats[k] == e.stats[k], k
    assert g.stats["graph_captures"] > 0 and e.stats["graph_captures"] == 0
    assert torch.equal(g.final_y, e.final_y)
    assert torch.equal(g.final_region, e.final_region)
    for a, b in zip(g.final_fluid, e.final_fluid):
        assert torch.equal(a, b)


@pytest.mark.parametrize("method, pc, linear, size", [
    ("bcgs", "line", F32, 1.0e3), ("gmres", "cpr", F32, 1.0e3),
    ("bcgs", "lu", {}, 1.0e4), ("bcgsl", "asm", {}, 1.0e4),
], ids=["bcgs_line", "gmres_cpr", "bcgs_lu", "bcgsl_asm"])
def test_band_route_program_equals_eager(method, pc, linear, size,
                                         monkeypatch):
    """The flagship box (5 x 4 x 3, band route) for 2 steps from `size`
    (cpr's first try fails from 1e4 s in both packages,
    tests/test_torch_precond.py)."""
    from waiwera_tpu_torch.ops import mg

    built = []
    levels = mg.build_levels

    def count_levels(lv0):
        out = levels(lv0)
        built.append(len(out))
        return out

    solver = {"linear": dict(linear, type=method,
                             preconditioner={"type": pc})}
    config = {"time": {"step": {"size": size, "adapt": {"on": True},
                                "maximum": {"number": 2},
                                "solver": solver}}}
    runs = []
    for graph in (True, False):
        monkeypatch.setattr(mg, "build_levels", count_levels)
        runs.append(_run(lambda: build_sim(5, 4, 3, "cpu"), config,
                         monkeypatch, graph))
        assert runs[-1].sim.system.dia is not None
    _same(*runs)
    if pc == "cpr":
        assert built and min(built) >= 2
    else:
        assert not built


def _wedge_config(tmp_path, solver):
    size = (6, 4, 4)  # tests/test_torch_mesh_run.py: the ELL route
    verts, wedges, pos = wedge_mesh(*size)
    path = str(tmp_path / "field.msh")
    write_gmsh(path, verts, [("wedge", wedges)], version="4.1", binary=True)
    config = wedge_model_config(path, *size, pos, steps=3, solver=solver)
    config.pop("output", None)
    return json.loads(json.dumps(config))


def _tet_config(tmp_path):
    """chip_smoke.py phase 10 (d)'s tetrahedral box (lgmres + lu) for 2
    steps."""
    config, _ = tet_box_config(str(tmp_path))
    config.pop("output", None)
    config["time"]["step"]["maximum"]["number"] = 2
    return json.loads(json.dumps(config))


@pytest.mark.parametrize("mesh, method, pc", [
    ("wedge", "bcgsl", "asm"), ("tetra", "lgmres", "lu"),
], ids=["wedge_bcgsl_asm", "tetra_lgmres_lu"])
def test_ell_route_program_equals_eager(mesh, method, pc, tmp_path,
                                        monkeypatch):
    from waiwera_tpu_torch.sim.simulation import Simulation

    if mesh == "wedge":
        config = _wedge_config(tmp_path, {"linear": {
            "type": method, "preconditioner": {"type": pc}}})
    else:
        config = _tet_config(tmp_path)
    runs = [_run(lambda: Simulation(copy.deepcopy(config), device="cpu"),
                 config, monkeypatch, graph) for graph in (True, False)]
    # the ELL operator: no band structure (wedges) or a hybrid one, on
    # which lu takes the assembled matrix (tetrahedra)
    assert runs[0].sim.system.dia is None
    _same(*runs)


def _bcgsl_case(n, b, seed):
    import jax.numpy as jnp
    from waiwera_tpu_torch.ops import ell

    mj, mt = laplacian_pair(n, b)
    xstar = np.random.default_rng(seed).standard_normal((n, b))
    rhs = np.array(mj.matvec(jnp.asarray(xstar)))
    return mj, mt, ell.ell_structure(mt.structure), rhs, xstar


def _bcgsl(program, mt, es, data, rhs, ell_, pc):
    """One bicgstab_l_solve through `program`: the ELL matvec and the
    preconditioner built on the staged BSR data inside its first
    piece."""
    from waiwera_tpu_torch.ops import ell
    from waiwera_tpu_torch.solver import bsr, krylov, precond

    split = precond.ilu0_split(mt.structure) if pc else None

    def setup(data, b):
        mat = bsr.BSRMatrix(mt.structure, data, mt.diag_pos)
        pc_ = precond.make_preconditioner(pc, mat, split) if pc else None
        return ell.to_ell(mat, es).matvec, pc_, b

    args = program.stage("in", (data, rhs))
    res = krylov.bicgstab_l_solve(program, setup, *args, ell=ell_,
                                  rtol=1e-10)
    return res._replace(x=program.hand_out(res.x))


@pytest.mark.parametrize("n, b, seed, ell_, pc", [
    (60, 2, 9, 1, None), (60, 2, 9, 2, None), (70, 3, 10, 4, "ilu"),
], ids=["ell1", "ell2", "ilu_ell4"])
def test_bicgstab_l_solve_graph_equals_eager_and_jax(n, b, seed, ell_, pc):
    import jax.numpy as jnp
    from waiwera_tpu.solver import krylov as jk
    from waiwera_tpu.solver import precond as jp
    from waiwera_tpu_torch.solver import krylov as tk
    from waiwera_tpu_torch.solver import precond as tp
    from waiwera_tpu_torch.solver.program import Program

    mj, mt, es, rhs, xstar = _bcgsl_case(n, b, seed)
    graph = Program(EmulatedGraphs())
    # two right-hand sides through one captured program
    for scale in (1.0, -0.5):
        rhs_t = torch.as_tensor(rhs * scale)
        rg = _bcgsl(graph, mt, es, mt.data, rhs_t, ell_, pc)
        re_ = _bcgsl(Program(), mt, es, mt.data, rhs_t, ell_, pc)
        assert torch.equal(rg.x, re_.x)
        for k in ("iterations", "converged", "matvecs", "host_syncs",
                  "masked_iterations"):
            assert getattr(rg, k) == getattr(re_, k), k
    assert graph.captures == 3 and graph.replays > 3  # start, chunk, finish
    # the eager wrapper runs the same pieces
    pt = tp.make_preconditioner(pc, mt) if pc else None
    rw = tk.bicgstab_l(lambda v: _matvec(mt, es, v), rhs_t,
                       precond=pt, rtol=1e-10, ell=ell_)
    assert torch.equal(rw.x, rg.x) and rw.host_syncs == rg.host_syncs

    pj = jp.make_preconditioner(pc, mj) if pc else None
    rj = jk.bicgstab_l(mj.matvec, jnp.asarray(rhs * -0.5), precond=pj,
                       rtol=1e-10, ell=ell_)
    assert rg.converged and bool(rj.converged)
    assert rg.iterations == int(rj.iterations)
    xj = np.asarray(rj.x)
    np.testing.assert_allclose(np_(rg.x), -0.5 * xstar, rtol=1e-6,
                               atol=1e-8)
    np.testing.assert_allclose(np_(rg.x), xj, rtol=1e-8,
                               atol=1e-10 * np.abs(xj).max())
    per_chunk = max(1, tk.CHUNK // ell_)
    chunks = -(-(rg.iterations // ell_) // per_chunk)
    assert rg.host_syncs == 1 + chunks
    assert rg.matvecs == 2 * ell_ * per_chunk * chunks


def _matvec(mt, es, v):
    from waiwera_tpu_torch.ops import ell

    return ell.to_ell(mt, es).matvec(v)


def test_bicgstab_l_masked_sweep_changes_nothing():
    """A chunk after convergence leaves every tensor of the state as it
    was, bit for bit, and counts no iteration."""
    from torch.utils import _pytree as pytree
    from waiwera_tpu_torch.solver import krylov

    _, mt, es, rhs, _ = _bcgsl_case(60, 2, 9)
    solver = krylov._BiCGStabL(2, 1e-10, 1e-50, 1000, lambda v: v, 2)
    ops, st, flags = solver.start(
        lambda: (lambda v: _matvec(mt, es, v), None, torch.as_tensor(rhs)))
    while bool(st.active):
        st, flags = solver.chunk(st, ops)
    assert int(flags[2]) == 1 and int(st.k) > 0
    with no_host_reads():
        after, flags2 = solver.chunk(st, ops)
    for a, c in zip(pytree.tree_leaves(st), pytree.tree_leaves(after)):
        assert torch.equal(a, c)
    assert torch.equal(flags, flags2)


def _random_bsr_pair(n, b, seed):
    """Both packages' BSR matrix on a seeded random graph of n cells
    (each cell joined to 3 others), diagonally dominant blocks."""
    import jax.numpy as jnp
    from waiwera_tpu.solver import bsr as jbsr
    from waiwera_tpu_torch.solver import bsr as tbsr

    rng = np.random.default_rng(seed)
    pairs = {tuple(sorted(rng.choice(n, 2, replace=False)))
             for _ in range(3 * n)}
    face_cells = np.array(sorted(pairs), dtype=np.int64)
    f = len(face_cells)
    diag = (8.0 * np.eye(b) + rng.standard_normal((n, b, b)))
    lr = rng.standard_normal((f, b, b))
    rl = rng.standard_normal((f, b, b))
    sj = jbsr.build_structure(n, face_cells, b)
    plr, prl = jbsr.face_block_positions(sj, face_cells)
    mj = jbsr.assemble(sj, jnp.asarray(diag), jnp.asarray(lr),
                       jnp.asarray(rl), jnp.asarray(plr), jnp.asarray(prl))
    st = tbsr.build_structure(n, face_cells, b)
    mt = tbsr.assemble(st, tbsr.assembly(st, face_cells),
                       torch.as_tensor(diag), torch.as_tensor(lr),
                       torch.as_tensor(rl))
    np.testing.assert_array_equal(np_(mt.data), np.asarray(mj.data))
    return mj, mt


@pytest.mark.parametrize("n, b", [(30, 3), (25, 2)])
def test_lu_on_the_device_matches_jax(n, b):
    """precond.lu built inside a piece of the stand-in graphs from its
    kept positions (no host read) against the JAX package's lu, f64,
    rtol 1e-12."""
    import jax.numpy as jnp
    from waiwera_tpu.solver import precond as jp
    from waiwera_tpu_torch.solver import precond as tp
    from waiwera_tpu_torch.solver.program import Program

    mj, mt = _random_bsr_pair(n, b, seed=n)
    positions = tp.dense_positions(mt.structure)
    r = np.random.default_rng(n + 1).standard_normal((n, b))
    prog = Program(EmulatedGraphs())
    data, rt = prog.stage("in", (mt.data, torch.as_tensor(r)))

    def piece(data, r):
        return tp.lu(mt._replace(data=data), positions=positions)(r)

    zt = prog.run("lu", piece, data, rt)
    zj = np.asarray(jp.lu(mj)(jnp.asarray(r)))
    np.testing.assert_allclose(np_(zt), zj, rtol=1e-12,
                               atol=1e-12 * np.abs(zj).max())
    # the eager lu without kept positions is the same function
    assert torch.equal(tp.lu(mt)(torch.as_tensor(r)), zt)
