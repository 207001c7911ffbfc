"""The partitioner of waiwera_tpu_torch.parallel against waiwera_tpu's.

- build_partition: every PartitionPlan field equal (arrays element for
  element, dtypes included) on the 37-cell column at D = 8, a
  6 x 5 x 4 box at D = 4 (one face plan on every rank: natural order),
  chip_smoke's wedge field read from gmsh in RCM plan order, in square
  order and with its cells shuffled, at D = 4 (the graph partitioner
  and local RCM), and a MINC box at D = 3 (chains weighted and kept
  whole).
- rcm and partition_graph (csrc/graph.cpp): equal to waiwera_tpu.native
  element for element on seeded random graphs.
"""

import numpy as np
import pytest

from chip_smoke import wedge_mesh, write_gmsh
from torch_parity import jax_native


@pytest.fixture(scope="module", autouse=True)
def _jax_native_library():
    """The JAX package's plans and routines with its C++ library, as it
    runs where the library builds (torch_parity.jax_native: workers that
    race for its first build would compare the port with the package's
    fallbacks)."""
    jax_native()


def _assert_plans_equal(pt, pj):
    assert type(pt)._fields == type(pj)._fields
    for f in pj._fields:
        a, b = getattr(pt, f), getattr(pj, f)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype, f
            np.testing.assert_array_equal(a, b, err_msg=f)
        else:
            assert a == b, f


def _plans(mesh_j, mesh_t, d):
    from waiwera_tpu.parallel import build_partition as jbuild
    from waiwera_tpu_torch.parallel.partition import build_partition

    return build_partition(mesh_t, d), jbuild(mesh_j, d)


def test_column_plan_matches_jax():
    from waiwera_tpu.mesh.rect import column_mesh as jcol
    from waiwera_tpu_torch.mesh.rect import column_mesh as tcol

    pt, pj = _plans(jcol([10.0] * 37), tcol([10.0] * 37), 8)
    _assert_plans_equal(pt, pj)


def test_box_plan_matches_jax_natural_order():
    from waiwera_tpu.mesh.rect import rectangular_mesh as jrect
    from waiwera_tpu_torch.mesh.rect import rectangular_mesh as trect

    w = ([10.0] * 6, [10.0] * 5, [10.0] * 4)
    pt, pj = _plans(jrect(*w), trect(*w), 4)
    _assert_plans_equal(pt, pj)
    # one face plan on every rank: each rank's owned cells ascend
    for d in range(4):
        own = pt.local_cells[d][pt.owned_mask[d]]
        assert np.all(np.diff(own) > 0)


@pytest.mark.parametrize("order", ["rcm", "squares", "shuffled"])
def test_wedge_plan_matches_jax(order, tmp_path):
    from waiwera_tpu.mesh.gmsh import read_gmsh as jread
    from waiwera_tpu_torch.mesh.gmsh import read_gmsh as tread

    v, w, _ = wedge_mesh(8, 6, 4, order="squares" if order == "shuffled"
                         else order)
    if order == "shuffled":  # cells in a seeded random order
        w = w[np.random.default_rng(5).permutation(len(w))]
    fname = str(tmp_path / "wedge.msh")
    write_gmsh(fname, v, [("wedge", w)])
    pt, pj = _plans(jread(fname), tread(fname), 4)
    _assert_plans_equal(pt, pj)


def test_minc_plan_matches_jax():
    from torch_parity import jax_sim, torch_sim

    mj = jax_sim(5, 4, 4, minc=True).mesh
    mt = torch_sim(5, 4, 4, minc=True).mesh
    pt, pj = _plans(mj, mt, 3)
    _assert_plans_equal(pt, pj)
    # matrix cells live on their fracture cell's rank
    lvl = np.asarray(mt.minc_level)
    par = np.asarray(mt.minc_parent)
    mat = np.flatnonzero(lvl > 0)
    np.testing.assert_array_equal(pt.cell_device[mat],
                                  pt.cell_device[par[mat]])


def test_graph_routines_match_native():
    from waiwera_tpu import native
    from waiwera_tpu_torch.parallel import graph

    rng = np.random.default_rng(7)
    for _ in range(12):
        n = int(rng.integers(8, 400))
        m = int(rng.integers(n, 4 * n))
        fc = rng.integers(0, n, (m, 2))
        fc = fc[fc[:, 0] != fc[:, 1]]
        ids = np.sort(rng.choice(n, int(0.9 * n), replace=False))
        indptr, indices = graph.csr_adjacency(fc, ids, n)
        np.testing.assert_array_equal(
            graph.rcm(indptr, indices, len(ids)),
            native.rcm(indptr, indices, len(ids)))
        for parts in (2, 3, 4, 8):
            np.testing.assert_array_equal(
                graph.partition_graph(indptr, indices, len(ids), parts),
                native.partition_graph(indptr, indices, len(ids), parts))


def test_collectives_and_halo_exchange():
    """parallel/comm.py over 3 gloo ranks on the 37-cell column: the
    point-to-point rounds fill every halo slot with its owner's value
    (test_parallel.py:65-108 simulates the same rounds on the host), the
    sum and its forward-mode tangent, max, any and all_gather; and each
    rank's local mesh holds its own faces only (C18)."""
    from torch_ranks import collectives_rank
    from waiwera_tpu_torch.mesh.rect import column_mesh
    from waiwera_tpu_torch.parallel import launch
    from waiwera_tpu_torch.parallel.partition import build_partition

    mesh = column_mesh([10.0] * 37)
    out = launch.run(collectives_rank, ["cpu"] * 3, mesh, threads=1,
                     timeout=300)
    plan = build_partition(mesh, 3)
    for d, r in enumerate(out):
        lc = plan.local_cells[d]
        real = plan.owned_mask[d].copy()
        halo = np.arange(plan.n_owned_pad, plan.n_local)
        fc = plan.face_cells_local[d][plan.face_mask[d]]
        used = np.unique(fc.ravel())
        real[used[used >= plan.n_owned_pad]] = True
        np.testing.assert_array_equal(r["synced"][real], lc[real])
        assert np.all(r["synced"][halo][~real[halo]] == -1)
        assert r["sum_jvp"] == (14.0, 12.0)  # 1 + 4 + 9, 2 (1 + 2 + 3)
        assert r["max"] == 3.0 and r["any"]
        np.testing.assert_array_equal(r["gather"],
                                      [[0, 1], [10, 11], [20, 21]])
        assert r["counts"]["p2p_rounds"] == len(plan.p2p_perms)
        # ROADMAP C18: no pad faces on a rank, so no deep sums on cell 0
        assert r["local_faces"] == r["plan_faces"]
        assert r["face_sum_depth"] == r["max_cell_faces"]


def test_c17_reference_partition_falls_back_silently(tmp_path,
                                                      monkeypatch):
    """ROADMAP C17: without its C++ library (WAIWERA_TPU_NATIVE=0) the
    JAX package's build_partition keeps RCB and natural order without a
    word (partition.py:97-100, :265-266), so its plan for the same mesh
    changes; the port's partitioner raises instead."""
    import os
    import subprocess
    import sys

    from waiwera_tpu_torch.mesh.gmsh import read_gmsh
    from waiwera_tpu_torch.parallel import graph
    from waiwera_tpu_torch.parallel.partition import build_partition

    v, w, _ = wedge_mesh(8, 6, 4)
    fname = str(tmp_path / "wedge.msh")
    write_gmsh(fname, v, [("wedge", w)])
    out = str(tmp_path / "cells.npy")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    script = (
        "import sys, numpy as np, jax\n"
        "jax.config.update('jax_platforms', 'cpu')\n"
        "from waiwera_tpu.mesh.gmsh import read_gmsh\n"
        "from waiwera_tpu.parallel import build_partition\n"
        "np.save(sys.argv[2], build_partition(read_gmsh(sys.argv[1]), 4)"
        ".local_cells)\n")
    env = dict(os.environ, PYTHONPATH=root, JAX_PLATFORMS="cpu",
               WAIWERA_TPU_NATIVE="0")
    r = subprocess.run([sys.executable, "-c", script, fname, out], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    plan = build_partition(read_gmsh(fname), 4)
    assert not np.array_equal(np.load(out), plan.local_cells)

    def broken():
        raise RuntimeError("g++ failed")

    monkeypatch.setattr(graph, "_load", broken)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        build_partition(read_gmsh(fname), 4)
