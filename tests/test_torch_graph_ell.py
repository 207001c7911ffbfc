"""Whole Timestepper runs through the graph program on the CPU stand-in
for CUDA graphs (EmulatedGraphs, under the guard that fails on host
reads), each bitwise equal to the same run eagerly with equal counts:
the 5 x 4 x 3 production field of chip_smoke.py (the source network,
rock controls and tracers), its tracer step a program of its own; and
the wedge field of tests/test_torch_mesh_run.py on the ELL route (no
band structure) with lgmres + asm, bcgs + asm (the BSR assembly inside
a piece) and gmres + line (block-Jacobi on the ELL route). The BSR
positions of the faces of conforming wedge and tetrahedral meshes do not
repeat (no two faces join one cell pair)."""

import copy
import json

import numpy as np
import pytest
import torch

from chip_smoke import (network_model_config, tet_box, wedge_mesh,
                        wedge_model_config, write_gmsh)
from test_torch_graph_program import EmulatedGraphs
from torch_parity import RecordingLogger

WEDGE = (6, 4, 4)  # tests/test_torch_mesh_run.py: takes the ELL route


def _runs(config, monkeypatch, graph, tracers=False):
    """The config through Simulation + Timestepper on the CPU, the step's
    program (and with tracers the tracer step's) through the stand-in
    graphs (graph) or eagerly."""
    from waiwera_tpu_torch.sim import simulation
    from waiwera_tpu_torch.sim.timestepper import Timestepper
    from waiwera_tpu_torch.solver import program

    if graph:
        monkeypatch.setattr(simulation, "step_program_mode",
                            lambda system, params: "graph")
        if tracers:
            monkeypatch.setattr(simulation, "tracer_program_mode",
                                lambda system: "graph")
        monkeypatch.setattr(program, "CudaGraphs", EmulatedGraphs)
    try:
        sim = simulation.Simulation(copy.deepcopy(config), device="cpu")
        ts = Timestepper(copy.deepcopy(config), sim,
                         logger=RecordingLogger())
        assert ts.run()
    finally:
        monkeypatch.undo()
    return ts


def _same(g, e, tracers=False):
    assert g.tried == e.tried
    assert g.stats["step_program"] == "graph"
    assert e.stats["step_program"] == "eager"
    keys = ["tries", "newton_iterations", "linear_iterations", "matvecs",
            "masked_krylov_iterations", "host_syncs_step"]
    if tracers:
        keys += ["tracer_iterations", "tracer_converged",
                 "host_syncs_tracer"]
    for k in keys:
        assert g.stats[k] == e.stats[k], k
    assert g.stats["graph_captures"] > 0 and e.stats["graph_captures"] == 0
    assert torch.equal(g.final_y, e.final_y)
    assert torch.equal(g.final_region, e.final_region)
    for a, b in zip(g.final_fluid, e.final_fluid):
        assert torch.equal(a, b)


def test_tracer_step_program_equals_eager(monkeypatch):
    """The production field for 3 steps: its tries, tracer solves and
    final state (tracers included) bitwise equal through the stand-in
    graphs and eagerly; host reads per tracer solve 1 + cycles."""
    config = network_model_config(5, 4, 3, steps=3)
    g = _runs(config, monkeypatch, graph=True, tracers=True)
    e = _runs(config, monkeypatch, graph=False)
    _same(g, e, tracers=True)
    assert (g.stats["tracer_program"], e.stats["tracer_program"]) == (
        "graph", "eager")
    assert g.stats["tracer_graph_captures"] == 3  # start, cycle, finish
    assert g.stats["tracer_graph_replays"] > g.taken
    assert len(g.stats["tracer_iterations"]) == g.taken
    cycles = sum(-(-n // 30) for n in g.stats["tracer_iterations"])
    assert g.stats["host_syncs_tracer"] == g.taken + cycles
    assert torch.equal(g.final_tracer, e.final_tracer)
    assert float(g.final_tracer.abs().max()) > 0.0


@pytest.mark.parametrize("method, pc", [
    ("lgmres", "asm"), ("bcgs", "asm"), ("gmres", "line"),
], ids=["lgmres_asm", "bcgs_asm", "gmres_line"])
def test_ell_route_program_equals_eager(method, pc, tmp_path, monkeypatch):
    verts, wedges, pos = wedge_mesh(*WEDGE)
    path = str(tmp_path / "field.msh")
    write_gmsh(path, verts, [("wedge", wedges)], version="4.1", binary=True)
    solver = {"linear": {"type": method, "preconditioner": {"type": pc}}}
    config = wedge_model_config(path, *WEDGE, pos, steps=3, solver=solver)
    config = json.loads(json.dumps(config))
    config.pop("output", None)
    g = _runs(config, monkeypatch, graph=True)
    e = _runs(config, monkeypatch, graph=False)
    assert g.sim.system.bands is None  # the ELL route
    _same(g, e)


@pytest.mark.parametrize("kind", ["wedge", "tetra"])
def test_bsr_positions_do_not_repeat(kind):
    """No two faces share a cell pair on these meshes: every block
    position is written once, and bsr.assemble's fixed-order sum is one
    gather."""
    from waiwera_tpu_torch.mesh.core import build_mesh
    from waiwera_tpu_torch.solver import bsr

    if kind == "wedge":
        verts, cells, _ = wedge_mesh(*WEDGE)
        blocks = [("wedge", cells)]
    else:
        verts, cells, _ = tet_box(5, 4, 3)
        blocks = [("tetra", cells)]
    mesh = build_mesh(verts, blocks)
    fc = np.asarray(mesh.face_cells)
    st = bsr.build_structure(mesh.num_cells, fc, 2)
    lr, rl = bsr.face_block_positions(st, fc)
    pos = np.concatenate([st.diag_pos, lr, rl])
    assert len(np.unique(pos)) == len(pos) == len(st.indices)


@pytest.mark.parametrize("width, dtype", [
    (1, torch.float64), (2, torch.float64), (3, torch.float64),
    (4, torch.float32), (3, torch.float32), (4, torch.float64),
])
def test_row_gather_equals_indexing(width, dtype):
    """ops/segment.py RowGather: x[index] bit for bit for a 1-D and a 2-D
    index, whichever way its rows are gathered, and under torch.func.jvp
    vmapped over tangents (the Jacobian's use of SegmentSum)."""
    from waiwera_tpu_torch.ops.segment import RowGather, _vector_rows

    rng = np.random.default_rng(width)
    x = torch.as_tensor(rng.standard_normal((40, width)), dtype=dtype)
    for shape in ((57,), (20, 6)):
        index = torch.as_tensor(rng.integers(0, 40, shape))
        rows = RowGather(index)
        assert torch.equal(rows(x), x[index])
        assert torch.equal(rows(x[:, 0]), x[:, 0][index])
    assert _vector_rows(width, x.element_size()) == (
        (width * x.element_size()) % 16 == 0)
    tangents = torch.as_tensor(rng.standard_normal((3, 40, width)),
                               dtype=dtype)

    def jvp(t):
        return torch.func.jvp(lambda v: rows(v * v), (x,), (t,))

    p, t = torch.func.vmap(jvp, out_dims=(None, 0))(tangents)
    assert torch.equal(p, (x * x)[index])
    for k in range(3):
        assert torch.equal(t[k], (2 * x * tangents[k])[index])
