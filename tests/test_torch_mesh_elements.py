"""build_mesh of waiwera_tpu_torch on every element type against the
JAX package's (which takes its cell and face geometry from its C++
library where that loads, and its face order from a stable C++ sort):
triangles, quadrilaterals with triangles, tetrahedra, pyramids, wedges
(in square order and in reverse Cuthill-McKee plan order) and a hexahedron
block with pyramids on top. Every Mesh field at rtol 1e-12 (atol 1e-12
of the field's largest entry), face_cells exactly, and the linear
operator's route (band, hybrid, ELL) equal to the JAX System's."""

import numpy as np
import pytest

from chip_smoke import tet_box, wedge_mesh
from test_torch_mesh import _MESH_FIELDS, _MESH_INT_FIELDS


def _perturb(verts, scale, seed=3):
    """Vertices moved by up to `scale` in each coordinate, so the faces
    are not orthogonal."""
    rng = np.random.default_rng(seed)
    return verts + rng.uniform(-scale, scale, verts.shape)


def _tri_grid(nx, ny):
    """A 2-D grid of unit squares, each split into 2 triangles."""
    X, Y = np.meshgrid(np.arange(nx + 1.0), np.arange(ny + 1.0))
    verts = np.stack([X.ravel(), Y.ravel()], axis=1)
    j, i = (a.ravel() for a in np.meshgrid(np.arange(ny), np.arange(nx),
                                           indexing="ij"))
    v00 = j * (nx + 1) + i
    v10, v01, v11 = v00 + 1, v00 + nx + 1, v00 + nx + 2
    quads = np.stack([v00, v10, v11, v01], axis=1)
    tris = np.concatenate([np.stack([v00, v10, v11], 1),
                           np.stack([v00, v11, v01], 1)])
    return verts, quads, tris


def _pyramid_box(nx, ny, nz):
    """Unit cubes, each split into 6 pyramids with their apex at the
    cube's centre (a vertex of its own)."""
    from chip_smoke import hex_box

    verts, hexes = hex_box(nx, ny, nz, ([1.0] * nx, [1.0] * ny, [1.0] * nz))
    centres = verts[hexes].mean(axis=1)
    apex = len(verts) + np.arange(len(hexes))
    faces = ((0, 3, 2, 1), (4, 5, 6, 7), (0, 1, 5, 4), (1, 2, 6, 5),
             (2, 3, 7, 6), (3, 0, 4, 7))
    pyr = np.stack([np.column_stack([hexes[:, list(f)], apex])
                    for f in faces], axis=1).reshape(-1, 5)
    return np.concatenate([verts, centres]), pyr


def _hex_with_pyramids():
    """A 3 x 2 x 2 hexahedron block, and a pyramid on each top face."""
    from chip_smoke import hex_box

    verts, hexes = hex_box(3, 2, 2, ([1.0] * 3, [1.0] * 2, [1.0] * 2))
    top = hexes[-6:, 4:]  # the top faces of the top layer
    apex = verts[top].mean(axis=1) + [0.0, 0.0, 0.5]
    ids = len(verts) + np.arange(len(top))
    pyr = np.column_stack([top, ids])
    return np.concatenate([verts, apex]), [("hexahedron", hexes),
                                           ("pyramid", pyr)]


def _mesh_case(kind):
    if kind == "triangle":
        verts, _, tris = _tri_grid(4, 3)
        return _perturb(verts, 0.1), [("triangle", tris)]
    if kind == "quad_triangle":
        verts, quads, _ = _tri_grid(4, 3)
        left = np.arange(12) % 4 < 2
        q = quads[~left]
        tris = np.concatenate([q[:, [0, 1, 2]], q[:, [0, 2, 3]]])
        return _perturb(verts, 0.1), [("quad", quads[left]),
                                      ("triangle", tris)]
    if kind == "tetra":
        verts, tets, _ = tet_box(3, 2, 2)
        return _perturb(verts, 0.05), [("tetra", tets)]
    if kind == "pyramid":
        verts, pyr = _pyramid_box(2, 2, 2)
        return _perturb(verts, 0.05), [("pyramid", pyr)]
    if kind in ("wedge", "wedge_plan_order"):
        # 6 x 4 squares: the smallest plan here whose reverse
        # Cuthill-McKee order gives no band layout
        verts, wedges, _ = (wedge_mesh(6, 4, 3) if kind == "wedge"
                            else wedge_mesh(4, 3, 3, order="squares"))
        return _perturb(verts, 2.0), [("wedge", wedges)]
    verts, blocks = _hex_with_pyramids()
    return _perturb(verts, 0.05), blocks


KINDS = ["triangle", "quad_triangle", "tetra", "pyramid", "wedge",
         "wedge_plan_order", "hex_pyramid"]


def _assert_same_mesh(mt, mj):
    """Every field of the two meshes equal: floating fields at rtol
    1e-12, face_cells and the other integer fields exactly, except the
    permeability direction of a face whose two largest normal components
    tie (argmax of |n| then follows round-off, which the C++ and numpy
    geometry place differently)."""
    assert (mt.dim, mt.num_cells, mt.num_interior_cells) == (
        mj.dim, mj.num_cells, mj.num_interior_cells)
    for name in _MESH_FIELDS:
        a, b = np.asarray(getattr(mt, name)), np.asarray(getattr(mj, name))
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a, b, rtol=1e-12,
                                   atol=1e-12 * np.abs(b).max(),
                                   err_msg=name)
    for name in _MESH_INT_FIELDS:
        a, b = np.asarray(getattr(mt, name)), np.asarray(getattr(mj, name))
        if name == "face_permeability_direction":
            diff = np.flatnonzero(a != b)
            n = np.abs(np.asarray(mj.face_normal)[diff])
            np.testing.assert_allclose(n[np.arange(len(diff)), a[diff]],
                                       n[np.arange(len(diff)), b[diff]],
                                       rtol=1e-12, err_msg=name)
            continue
        np.testing.assert_array_equal(a, b, err_msg=name)


def _route(system):
    if system.dia is not None:
        return "band"
    return "hybrid" if system.hybrid is not None else "ell"


@pytest.mark.parametrize("kind", KINDS)
def test_build_mesh_matches_jax(kind):
    from waiwera_tpu.mesh.core import build_mesh as jbuild
    from waiwera_tpu_torch.mesh.core import build_mesh as tbuild

    verts, blocks = _mesh_case(kind)
    mj = jbuild(verts, blocks)
    mt = tbuild(verts, blocks)
    _assert_same_mesh(mt, mj)
    assert (mt.cell_volume > 0).all()
    # the faces close every cell: sum of outward area vectors is zero
    n = mt.num_cells
    acc = np.zeros((n, 3))
    an = mt.face_normal * mt.face_area[:, None]
    np.add.at(acc, mt.face_cells[:, 0], an)
    np.add.at(acc, mt.face_cells[:, 1], -an)
    ean = mt.exterior_face_normal * mt.exterior_face_area[:, None]
    np.add.at(acc, mt.exterior_face_cell, ean)
    assert np.abs(acc).max() < 1e-9 * np.abs(an).max()


@pytest.mark.parametrize("kind", KINDS)
def test_route_matches_jax(kind):
    """Both packages' System on the mesh pick the same route for the
    linear operator."""
    from waiwera_tpu.mesh.core import build_mesh as jbuild
    from waiwera_tpu.sim.simulation import Simulation as JSim
    from waiwera_tpu_torch.mesh.core import build_mesh as tbuild
    from waiwera_tpu_torch.sim.simulation import Simulation as TSim

    verts, blocks = _mesh_case(kind)
    cfg = {"eos": {"name": "w"}, "initial": {"primary": [2.0e5],
                                             "region": 1}}
    sj = JSim(dict(cfg), mesh=jbuild(verts, blocks))
    st = TSim(dict(cfg), mesh=tbuild(verts, blocks), device="cpu")
    assert _route(st.system) == _route(sj.system)
    if st.system.dia is not None:
        assert st.system.dia.offsets == tuple(sj.system.dia.offsets)
    if kind == "wedge":
        # the RCM plan order has too many bands for either layout
        assert _route(st.system) == "ell"
