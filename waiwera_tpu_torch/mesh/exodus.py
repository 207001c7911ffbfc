"""ExodusII mesh reader (counterpart of waiwera_tpu/mesh/exodus.py).

Replaces the reference's DMPlexCreateFromFile exodus path
(mesh.F90:940). ExodusII files are NetCDF: classic NetCDF-3, read with
scipy's netcdf_file (dimensions num_nodes, num_dim, num_el_blk; the
variables coord, or coordx/coordy/coordz, and connect<i> per element
block with an elem_type attribute), or the NetCDF-4 (HDF5) variant, read
with utils/hdf5.py (no h5py).
"""

from __future__ import annotations

import numpy as np

from waiwera_tpu_torch.mesh.core import Mesh, build_mesh
from waiwera_tpu_torch.utils import hdf5

_TYPE_MAP = {
    "HEX": "hexahedron",
    "HEX8": "hexahedron",
    "HEXAHEDRON": "hexahedron",
    "TETRAHEDRON": "tetra",
    "TETRA": "tetra",
    "TETRA4": "tetra",
    "TET4": "tetra",
    "WEDGE": "wedge",
    "WEDGE6": "wedge",
    "PYRAMID": "pyramid",
    "PYRA5": "pyramid",
    "PYRAMID5": "pyramid",
    "QUAD": "quad",
    "QUAD4": "quad",
    "SHELL4": "quad",
    "TRI": "triangle",
    "TRI3": "triangle",
    "TRIANGLE": "triangle",
}


def _element_type(etype) -> str:
    if isinstance(etype, bytes):
        etype = etype.decode()
    etype = etype.strip().upper()
    if etype not in _TYPE_MAP:
        raise ValueError(f"unsupported exodus element {etype!r}")
    return _TYPE_MAP[etype]


def read_exodus(filename: str, gravity=None, radial: bool = False,
                thickness: float = 1.0, device=None) -> Mesh:
    with open(filename, "rb") as fh:
        magic = fh.read(4)
    if magic[:3] == b"\x89HD" or magic[1:4] == b"HDF":
        coords, blocks = _read_exodus_hdf5(filename)
    else:
        coords, blocks = _read_exodus_netcdf3(filename)
    return build_mesh(coords, blocks, gravity=gravity, radial=radial,
                      thickness=thickness, device=device)


def _read_exodus_netcdf3(filename: str):
    from scipy.io import netcdf_file

    f = netcdf_file(filename, "r", mmap=False)
    try:
        dims = f.dimensions
        num_dim = int(dims["num_dim"])
        if "coord" in f.variables:
            coords = np.array(f.variables["coord"][:]).T  # [nn, dim]
        else:
            coords = np.stack([np.array(f.variables[name][:]) for name in
                               ("coordx", "coordy", "coordz")[:num_dim]],
                              axis=1)
        coords = coords[:, :num_dim].astype(np.float64)
        num_blocks = int(dims.get("num_el_blk", 1) or 1)
        blocks = []
        for b in range(1, num_blocks + 1):
            var = f.variables[f"connect{b}"]
            etype = _element_type(var.elem_type)
            # connectivity is 1-based
            blocks.append((etype, np.array(var[:]).astype(np.int64) - 1))
    finally:
        f.close()
    return coords, blocks


def _read_exodus_hdf5(filename: str):
    """NetCDF-4 (HDF5-based) exodus variant."""
    with hdf5.File(filename, "r") as f:
        # netCDF-4 stores dimensions as phony datasets or attributes;
        # the coord variables give the dimension instead
        if "coord" in f:
            coords = np.array(f["coord"]).T
        else:
            coords = np.stack([np.array(f[name]) for name in
                               ("coordx", "coordy", "coordz") if name in f],
                              axis=1)
        # a degenerate third dimension of a 2-D mesh is dropped
        if (coords.shape[1] == 3 and np.allclose(coords[:, 2], coords[0, 2])
                and "connect1" in f):
            et = f["connect1"].attrs.get("elem_type", b"")
            if isinstance(et, bytes):
                et = et.decode()
            if et.strip().upper() in ("QUAD", "QUAD4", "TRI", "TRI3"):
                coords = coords[:, :2]
        blocks = []
        b = 1
        while f"connect{b}" in f:
            var = f[f"connect{b}"]
            etype = _element_type(var.attrs.get("elem_type", ""))
            blocks.append((etype, np.array(var).astype(np.int64) - 1))
            b += 1
    return coords.astype(np.float64), blocks
