"""Mesh geometry of waiwera_tpu_torch against waiwera_tpu: a rectilinear
box with uneven spacing, an origin, gravity from the config and two
boundary entries, in the canonical face order of MeshArrays; column,
1-D, 2-D, thickness and radial meshes; and gravity by mesh dimension
(f64, rtol 1e-12: same formulas, same order)."""

import numpy as np
import pytest

from torch_parity import np_

DX, DY, DZ = [30.0, 50.0, 80.0, 40.0], [20.0, 60.0, 35.0], [10.0, 25.0]
ORIGIN = [100.0, -50.0, -35.0]


def _boundaries():
    nx, ny = len(DX), len(DY)
    top = list(range(nx * ny, 2 * nx * ny))
    west = [j * nx for j in range(ny)] + [nx * ny + j * nx for j in range(ny)]
    return [
        {"primary": [1.0e5, 20.0, 1.0e3], "region": 1,
         "faces": {"cells": top, "normal": [0.0, 0.0, 1.0]}},
        {"primary": [2.0e5, 30.0, 0.0], "region": 1,
         "faces": [{"cells": west, "normal": [-1.0, 0.0, 0.0]}]},
    ]


def _meshes(gravity=(0.0, 0.0, -9.81)):
    from waiwera_tpu.mesh import core as jcore
    from waiwera_tpu.mesh.device import mesh_arrays as jarrays
    from waiwera_tpu.mesh.rect import rectangular_mesh as jrect
    from waiwera_tpu_torch.mesh import core as tcore
    from waiwera_tpu_torch.mesh.device import mesh_arrays as tarrays
    from waiwera_tpu_torch.mesh.rect import rectangular_mesh as trect

    out = []
    for rect, core, arrays in ((jrect, jcore, jarrays),
                               (trect, tcore, tarrays)):
        m = rect(DX, DY, DZ, origin=ORIGIN)
        core.add_boundaries(m, _boundaries(), 3)
        core.set_gravity(m, gravity)
        out.append((m, arrays(m)))
    return out


def test_mesh_arrays_match_jax():
    (mj, aj), (mt, at) = _meshes()
    assert at.num_cells == aj.num_cells == mj.num_cells
    assert at.num_interior_cells == 24
    for f in ("face_cells", "face_permeability_direction", "is_ghost"):
        np.testing.assert_array_equal(np_(getattr(at, f)),
                                      np.asarray(getattr(aj, f)), err_msg=f)
    for f in ("face_area", "face_distance", "face_distance12",
              "face_gravity_normal", "cell_volume"):
        np.testing.assert_allclose(np_(getattr(at, f)),
                                   np.asarray(getattr(aj, f)),
                                   rtol=1e-12, atol=1e-12, err_msg=f)
    np.testing.assert_allclose(mt.cell_centroid, mj.cell_centroid,
                               rtol=1e-12, atol=1e-9)


def test_boundary_faces_join_their_ghost_cells():
    """Each boundary entry's faces are the ones that join its own ghost
    cells to the interior (the face indices of the second entry start
    after the first entry's)."""
    _, (mt, _) = _meshes()
    assert [len(b.cells) for b in mt.boundaries] == [12, 6]
    for b in mt.boundaries:
        np.testing.assert_array_equal(mt.face_cells[b.faces, 1], b.cells)
        assert not mt.is_ghost[mt.face_cells[b.faces, 0]].any()


def test_two_dimensional_mesh_raises():
    """2-D quadrilateral meshes build, and so do triangles: a triangle
    pair builds to the JAX package's mesh (every element type:
    tests/test_torch_mesh_elements.py)."""
    from waiwera_tpu.mesh.core import build_mesh as jbuild
    from waiwera_tpu_torch.mesh.core import build_mesh
    from waiwera_tpu_torch.mesh.rect import rectangular_mesh

    assert rectangular_mesh(DX, DY).dim == 2
    verts = np.array([[0.0, 0.0], [1.0, 0.0], [0.0, 1.0], [1.2, 0.9]])
    tris = np.array([[0, 1, 2], [1, 3, 2]])
    mt = build_mesh(verts, [("triangle", tris)])
    mj = jbuild(verts, [("triangle", tris)])
    assert mt.dim == 2 and mt.num_cells == 2
    np.testing.assert_array_equal(mt.face_cells, mj.face_cells)
    for name in _MESH_FIELDS:
        np.testing.assert_allclose(getattr(mt, name), getattr(mj, name),
                                   rtol=1e-12, atol=1e-12, err_msg=name)


_MESH_FIELDS = ("cell_centroid", "cell_volume", "face_area", "face_normal",
                "face_centroid", "face_distance", "face_distance12",
                "face_gravity_normal", "exterior_face_centroid",
                "exterior_face_normal", "exterior_face_area", "gravity")
_MESH_INT_FIELDS = ("face_cells", "face_permeability_direction",
                    "exterior_face_cell", "is_ghost")


def _mesh_pair(kind):
    from waiwera_tpu.mesh import rect as jrect
    from waiwera_tpu_torch.mesh import rect as trect

    rng = np.random.default_rng(11)
    if kind == "column":
        dz = rng.uniform(2.0, 30.0, 7)
        return [m.column_mesh(dz, area=3.5, top=12.0) for m in (jrect, trect)]
    dx, dy = rng.uniform(5.0, 40.0, 5), rng.uniform(3.0, 20.0, 4)
    if kind == "row":
        return [m.rectangular_mesh(dx) for m in (jrect, trect)]
    kw = {
        "plane": dict(origin=[10.0, -7.0]),
        "thickness": dict(thickness=2.5, gravity=[0.0, -9.8]),
        "radial": dict(radial=True, thickness=4.0),
    }[kind]
    return [m.rectangular_mesh(dx, dy, **kw) for m in (jrect, trect)]


@pytest.mark.parametrize("kind", ["column", "row", "plane", "thickness",
                                  "radial"])
def test_two_dimensional_meshes_match_jax(kind):
    """Host geometry and, with a boundary on the first cell, the device
    arrays with their face permutation and sign."""
    from waiwera_tpu.mesh import core as jcore
    from waiwera_tpu.mesh.device import mesh_arrays as jarrays
    from waiwera_tpu_torch.mesh import core as tcore
    from waiwera_tpu_torch.mesh.device import (fluxes_to_host_order,
                                               mesh_arrays as tarrays)

    mj, mt = _mesh_pair(kind)
    assert mt.dim == mj.dim == 2
    assert mt.radial == mj.radial and mt.thickness == mj.thickness
    spec = [{"primary": [1.0e5, 20.0, 0.0], "region": 1,
             "faces": {"cells": [0], "normal": [0.0, 1.0]}}]
    jcore.add_boundaries(mj, spec, 3)
    tcore.add_boundaries(mt, spec, 3)
    assert mt.num_cells == mj.num_cells == mt.num_interior_cells + 1
    for f in _MESH_INT_FIELDS:
        np.testing.assert_array_equal(getattr(mt, f), getattr(mj, f),
                                      err_msg=f)
    for f in _MESH_FIELDS:
        np.testing.assert_allclose(getattr(mt, f), getattr(mj, f),
                                   rtol=1e-12, atol=1e-12, err_msg=f)
    aj, at = jarrays(mj), tarrays(mt)
    for f in ("face_cells", "face_permeability_direction"):
        np.testing.assert_array_equal(np_(getattr(at, f)),
                                      np.asarray(getattr(aj, f)), err_msg=f)
    for f in ("face_area", "face_distance", "face_gravity_normal",
              "cell_volume"):
        np.testing.assert_allclose(np_(getattr(at, f)),
                                   np.asarray(getattr(aj, f)),
                                   rtol=1e-12, atol=1e-12, err_msg=f)
    np.testing.assert_array_equal(at.face_perm, aj.face_perm)
    np.testing.assert_array_equal(at.face_sign, aj.face_sign)
    from waiwera_tpu.mesh.device import fluxes_to_host_order as jhost
    import torch

    fx = np.random.default_rng(5).standard_normal((len(at.face_perm), 4))
    np.testing.assert_array_equal(
        fluxes_to_host_order(at, torch.as_tensor(fx)), jhost(aj, fx))


def test_column_has_its_vertical_in_y():
    from waiwera_tpu_torch.mesh.rect import column_mesh

    m = column_mesh([10.0, 20.0, 30.0], area=4.0)
    np.testing.assert_allclose(m.cell_centroid[:, 1], [-5.0, -20.0, -45.0])
    np.testing.assert_allclose(m.cell_volume, [40.0, 80.0, 120.0])
    np.testing.assert_allclose(np.abs(m.face_gravity_normal), 9.8)
    np.testing.assert_array_equal(m.face_permeability_direction, [1, 1])


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("gravity", [None, 9.81, 0, [0.0, -3.0],
                                     [1.0, 2.0, -3.0]],
                         ids=["default", "scalar", "zero", "vec2", "vec3"])
def test_gravity_by_dimension_matches_jax(gravity, dim):
    """A scalar or default gravity points down the last mesh dimension;
    the default is 0 for 2-D meshes."""
    from waiwera_tpu.sim.simulation import Simulation as JSim
    from waiwera_tpu_torch.sim.simulation import Simulation as TSim

    cfg = {} if gravity is None else {"gravity": gravity}
    g = TSim._resolve_gravity(cfg, dim)
    np.testing.assert_array_equal(g, JSim._resolve_gravity(cfg, dim))
    if gravity is None:
        assert g[dim - 1] == (0.0 if dim == 2 else -9.8)
    elif np.ndim(gravity) == 0:
        assert g[dim - 1] == -float(gravity) and np.count_nonzero(g) <= 1


@pytest.mark.parametrize("mesh_cfg, gravity", [
    ({"type": "column", "dz": [5.0, 10.0, 15.0], "area": 2.0}, 9.8),
    ({"type": "column", "dz": [5.0, 10.0, 15.0]}, None),
    ({"type": "rectangular", "dx": [10.0, 20.0], "dy": [5.0, 5.0, 8.0],
      "thickness": 3.0}, [0.0, -9.8]),
    ({"type": "rectangular", "dx": [10.0, 20.0], "dy": [5.0, 5.0, 8.0],
      "radial": True}, 5.0),
    ({"type": "rectangular", "dx": [10.0, 20.0], "dy": [5.0, 7.0],
      "dz": [4.0, 6.0]}, None),
    ({"type": "rectangular", "dx": [10.0, 20.0], "dy": [5.0, 7.0],
      "dz": [4.0, 6.0]}, 3.0),
], ids=["column_scalar", "column_default", "plane_vector", "radial_scalar",
        "box_default", "box_scalar"])
def test_mesh_and_gravity_from_config_match_jax(mesh_cfg, gravity):
    """Simulation(config) builds the mesh from the config and sets
    gravity by the mesh's dimension, whether the config names one or
    not."""
    from waiwera_tpu.sim.simulation import Simulation as JSim
    from waiwera_tpu_torch.sim.simulation import Simulation as TSim

    cfg = {"eos": {"name": "wae"}, "mesh": mesh_cfg,
           "initial": {"primary": [2.0e5, 30.0, 1.0e4], "region": 1},
           "boundaries": [{"primary": [1.0e5, 20.0, 1.0e4], "region": 1,
                           "faces": {"cells": [0], "normal": [0, 1]}}]}
    if gravity is not None:
        cfg["gravity"] = gravity
    sj, st = JSim(cfg), TSim(cfg, device="cpu")
    np.testing.assert_array_equal(st.mesh.gravity, sj.mesh.gravity)
    for f in ("face_gravity_normal", "face_area", "face_distance",
              "cell_volume"):
        np.testing.assert_allclose(np_(getattr(st.mesh_dev, f)),
                                   np.asarray(getattr(sj.mesh_dev, f)),
                                   rtol=1e-12, atol=1e-12, err_msg=f)
    np.testing.assert_array_equal(np_(st.mesh_dev.face_cells),
                                  np.asarray(sj.mesh_dev.face_cells))
    lj, _, _ = sj.lhs_at(sj.y0, sj.region0)
    lt, _, _ = st.lhs_at(st.y0, st.region0)
    np.testing.assert_allclose(np_(lt), np.asarray(lj), rtol=1e-12)
    np.testing.assert_allclose(
        np_(st.initial_fluxes(st.y0, st.region0)),
        np.asarray(sj.initial_fluxes(sj.y0, sj.region0)), rtol=1e-10,
        atol=1e-20)


def test_passed_mesh_keeps_its_gravity():
    """An explicitly passed mesh keeps its gravity unless the config
    sets one."""
    from waiwera_tpu_torch.mesh.rect import column_mesh
    from waiwera_tpu_torch.sim.simulation import Simulation

    cfg = {"eos": {"name": "wae"}}
    kept = Simulation(cfg, mesh=column_mesh([5.0, 5.0], gravity=[0.0, -1.5]),
                      device="cpu")
    np.testing.assert_array_equal(kept.mesh.gravity, [0.0, -1.5, 0.0])
    over = Simulation(dict(cfg, gravity=2.0),
                      mesh=column_mesh([5.0, 5.0], gravity=[0.0, -1.5]),
                      device="cpu")
    np.testing.assert_array_equal(over.mesh.gravity, [0.0, -2.0, 0.0])
