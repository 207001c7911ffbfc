"""The mesh file readers of waiwera_tpu_torch against the JAX package's:
gmsh 2.2 and 4.1, ASCII and binary, and ExodusII as NetCDF-3 and as
HDF5, each file written here from an in-repo mesh (the JAX package's
fixtures live outside this tree, ROADMAP C1) and read by both packages
to equal meshes, equal to build_mesh of the same cells; and the AUTOUGH2
listing reader on a listing written here."""

import numpy as np
import pytest

from chip_smoke import wedge_mesh, write_exodus, write_gmsh
from test_torch_mesh_elements import _assert_same_mesh, _mesh_case

FORMATS = [("2.2", False), ("2.2", True), ("4.1", False), ("4.1", True)]


def _cases():
    """(name, vertices, cell blocks): a wedge field, a 2-D mesh of
    quadrilaterals and triangles, and hexahedra with pyramids."""
    verts, wedges, _ = wedge_mesh(3, 2, 2)
    return [("wedge", verts, [("wedge", wedges)]),
            ("quad_triangle",) + _mesh_case("quad_triangle"),
            ("hex_pyramid",) + _mesh_case("hex_pyramid")]


@pytest.mark.parametrize("version, binary", FORMATS,
                         ids=[f"{v}_{'binary' if b else 'ascii'}"
                              for v, b in FORMATS])
def test_gmsh_matches_jax(version, binary, tmp_path):
    from waiwera_tpu.mesh.core import build_mesh as jbuild
    from waiwera_tpu.mesh.gmsh import read_gmsh as jread
    from waiwera_tpu_torch.mesh.gmsh import read_gmsh as tread

    for name, verts, blocks in _cases():
        path = str(tmp_path / f"{name}.msh")
        # a line element between two blocks of one type is skipped, and
        # the two blocks become one
        etype, conn = blocks[0]
        lines = ("line", conn[:2, :2])
        write_gmsh(path, verts, [(etype, conn[:3]), lines,
                                 (etype, conn[3:])] + blocks[1:],
                   version=version, binary=binary)
        mt, mj = tread(path), jread(path)
        _assert_same_mesh(mt, mj)
        _assert_same_mesh(mt, jbuild(verts, blocks))


def test_exodus_matches_jax(tmp_path):
    """NetCDF-3 through scipy (both packages), and the HDF5 variant
    through h5py, with a degenerate z dropped from a 2-D mesh."""
    import h5py
    from waiwera_tpu.mesh.exodus import read_exodus as jread
    from waiwera_tpu_torch.mesh.exodus import read_exodus as tread
    from chip_smoke import EXODUS_TYPES

    for name, verts, blocks in _cases():
        path = str(tmp_path / f"{name}.exo")
        write_exodus(path, verts, blocks)
        mt = tread(path)
        _assert_same_mesh(mt, jread(path))
        h5 = str(tmp_path / f"{name}_h5.exo")
        with h5py.File(h5, "w") as f:
            v3 = np.zeros((len(verts), 3))
            v3[:, : verts.shape[1]] = verts
            for axis, coord in zip("xyz", v3.T):
                f[f"coord{axis}"] = coord
            for b, (etype, conn) in enumerate(blocks, start=1):
                f[f"connect{b}"] = conn + 1
                f[f"connect{b}"].attrs["elem_type"] = EXODUS_TYPES[etype]
        mh = tread(h5)
        assert mh.dim == verts.shape[1]
        _assert_same_mesh(mh, jread(h5))
        _assert_same_mesh(mh, mt)


def test_mesh_file_through_simulation(tmp_path):
    """config["mesh"] names a file: exodus by suffix, gmsh otherwise, in
    both packages; an unknown element type is an error in both."""
    from waiwera_tpu.sim.simulation import Simulation as JSim
    from waiwera_tpu_torch.sim.simulation import Simulation as TSim

    name, verts, blocks = _cases()[0]
    write_gmsh(str(tmp_path / "m.msh"), verts, blocks)
    write_exodus(str(tmp_path / "m.exo"), verts, blocks)
    cfg = {"eos": {"name": "w"}, "initial": {"primary": [2.0e5],
                                             "region": 1}}
    for fn in ("m.msh", "m.exo"):
        spec = {"filename": str(tmp_path / fn)}
        st = TSim(dict(cfg, mesh=spec), device="cpu")
        sj = JSim(dict(cfg, mesh=spec))
        _assert_same_mesh(st.mesh, sj.mesh)
        assert st.mesh.num_cells == len(blocks[0][1])
    (tmp_path / "bad.msh").write_bytes(
        b"$MeshFormat\n2.2 0 8\n$EndMeshFormat\n$Nodes\n1\n1 0 0 0\n"
        b"$EndNodes\n$Elements\n1\n1 9 2 0 0 1 1 1 1 1 1\n$EndElements\n")
    for sim in (lambda c: TSim(c, device="cpu"), JSim):
        with pytest.raises(KeyError):
            sim(dict(cfg, mesh=str(tmp_path / "bad.msh")))


def _listing(path):
    """An AUTOUGH2-style listing: two ELEMENT TABLEs (3 elements, 3
    columns, one of them a two-word name) and a GENERATION TABLE."""
    rows = [[1.0e6, 20.0, 0.0], [1.1e6, 21.0, 0.1], [1.25e6, 22.5, 0.0]]

    def table(scale):
        head = " " * 14
        for k, word in enumerate(("Pressure", "Temperature")):
            c = 14 + 13 * k + 7
            head = head.ljust(c - len(word) // 2) + word
        head = head.ljust(14 + 26 + 1) + "Vapour saturation"
        out = [" ELEMENT TABLE", "", " ELEMENT INDEX" + head[14:],
               " " * 16 + "(Pa)        (deg C)", ""]
        for i, r in enumerate(rows):
            out.append(f"   aa {i + 1:2d}  {i + 1:4d}"
                       + "".join(f"{v * scale:13.5E}" for v in r))
        return out

    lines = [" AUTOUGH2 listing", "",
             " OUTPUT AFTER     5 TIME STEPS     0.10000E+05 SECONDS", ""]
    lines += table(1.0)
    lines += ["", " OUTPUT AFTER    10 TIME STEPS     0.25000E+05 SECONDS",
              ""]
    lines += table(1.01)
    lines += ["", " OUTPUT AFTER    10 TIME STEPS     0.25000E+05 SECONDS",
              " GENERATION TABLE", "",
              " ELEMENT SOURCE INDEX Generation rate          Enthalpy", "",
              "   aa  1  wel 1   1" + f"{-2.0:15.5E}{1.0e6:20.5E}",
              "", " @@@@"]
    path.write_text("\n".join(lines) + "\n")


def test_read_listing_matches_jax(tmp_path):
    from waiwera_tpu.utils.autough2 import read_listing as jread
    from waiwera_tpu_torch.utils.autough2 import read_listing as tread

    path = tmp_path / "model.listing"
    _listing(path)
    for table in ("element", "generation"):
        tt, dt = tread(str(path), table=table)
        tj, dj = jread(str(path), table=table)
        np.testing.assert_array_equal(tt, tj)
        assert list(dt) == list(dj)
        for k in dj:
            np.testing.assert_array_equal(dt[k], dj[k])
    _, gen = tread(str(path), table="generation")
    np.testing.assert_array_equal(gen["Generation rate"], [[-2.0]])
    np.testing.assert_array_equal(gen["Enthalpy"], [[1.0e6]])
    times, tables = tread(str(path))
    np.testing.assert_array_equal(times, [1.0e4, 2.5e4])
    assert list(tables) == ["Pressure", "Temperature", "Vapour saturation"]
    np.testing.assert_allclose(tables["Pressure"][1], [1.01e6, 1.111e6,
                                                       1.2625e6])


def test_readers_on_a_device_match_the_host_path(tmp_path):
    """gmsh and ExodusII read with device= (the device geometry path,
    here on the CPU device) give the host path's mesh and the JAX
    package's."""
    from waiwera_tpu.mesh.exodus import read_exodus as jexo
    from waiwera_tpu.mesh.gmsh import read_gmsh as jmsh
    from waiwera_tpu_torch.mesh.exodus import read_exodus
    from waiwera_tpu_torch.mesh.gmsh import read_gmsh

    for name, verts, blocks in _cases():
        msh = str(tmp_path / f"{name}.msh")
        exo = str(tmp_path / f"{name}.exo")
        write_gmsh(msh, verts, blocks, version="4.1", binary=True)
        write_exodus(exo, verts, blocks)
        for read, jread, path in ((read_gmsh, jmsh, msh),
                                  (read_exodus, jexo, exo)):
            md = read(path, device="cpu")
            np.testing.assert_array_equal(md.face_cells,
                                          read(path).face_cells)
            _assert_same_mesh(md, read(path))
            _assert_same_mesh(md, jread(path))
