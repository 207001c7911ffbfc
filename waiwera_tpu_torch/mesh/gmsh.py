"""Gmsh .msh file reader, formats 2.2 (ASCII and binary) and 4.1 (ASCII
and binary) (counterpart of waiwera_tpu/mesh/gmsh.py).

Replaces the reference's DMPlexCreateFromFile gmsh path (mesh.F90:940).
Only the elements of the highest dimension (3-D volumes, or 2-D surfaces)
become cells; lower-dimensional elements are skipped. Cell numbering
follows file order (the natural order of all I/O), vertices are the
node tags in ascending order, and consecutive elements of one type form
one cell block: the JAX package's mesh, read with numpy arrays instead
of a Python dict per node and a list per element.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Tuple

import numpy as np

from waiwera_tpu_torch.mesh.core import Mesh, build_mesh

# gmsh element type -> (name, num nodes)
_TYPES = {
    1: ("line", 2),
    2: ("triangle", 3),
    3: ("quad", 4),
    4: ("tetra", 4),
    5: ("hexahedron", 8),
    6: ("wedge", 6),
    7: ("pyramid", 5),
    15: ("point", 1),
}
_DIM = {
    "point": 0,
    "line": 1,
    "triangle": 2,
    "quad": 2,
    "tetra": 3,
    "hexahedron": 3,
    "wedge": 3,
    "pyramid": 3,
}

# nodes: (tags [nn] int64, coordinates [nn, 3] f64) in file order;
# elements: [(type name, node tags [ne, nv] int64)] chunks in file order
Nodes = Tuple[np.ndarray, np.ndarray]
Elements = List[Tuple[str, np.ndarray]]


def _read_sections(data: bytes) -> Dict[str, Tuple[int, int]]:
    """Locate $Section ... $EndSection byte ranges."""
    sections = {}
    pos = 0
    while True:
        start = data.find(b"$", pos)
        if start < 0:
            break
        eol = data.find(b"\n", start)
        name = data[start + 1: eol].strip().decode()
        if name.startswith("End"):
            pos = eol + 1
            continue
        end_tag = ("$End" + name).encode()
        end = data.find(end_tag, eol)
        if end < 0:
            raise ValueError(f"unterminated gmsh section {name}")
        sections[name] = (eol + 1, end)
        pos = end + len(end_tag)
    return sections


def read_gmsh(filename: str, gravity=None, radial: bool = False,
              thickness: float = 1.0, device=None) -> Mesh:
    with open(filename, "rb") as f:
        data = f.read()
    sections = _read_sections(data)
    if "MeshFormat" not in sections:
        raise ValueError("not a gmsh file (no $MeshFormat)")
    s, e = sections["MeshFormat"]
    fmt_line = data[s:e].split(b"\n")[0].split()
    version = float(fmt_line[0])
    binary = int(fmt_line[1]) == 1

    if version >= 4.0:
        if binary:
            # endianness probe: the int 1 follows the format line
            raw = data[s:e].split(b"\n", 1)[1][:4]
            swap = len(raw) == 4 and struct.unpack("<i", raw)[0] != 1
            nodes, elements = _read_msh41_binary(data, sections, swap)
        else:
            nodes, elements = _read_msh41_ascii(data, sections)
    elif binary:
        nodes, elements = _read_msh22_binary(data, sections)
    else:
        nodes, elements = _read_msh22_ascii(data, sections)
    return _mesh_from_elements(nodes, elements, gravity=gravity,
                               radial=radial, thickness=thickness,
                               device=device)


def _mesh_from_elements(nodes: Nodes, elements: Elements, **kw) -> Mesh:
    """The mesh of the highest-dimensional elements: vertices are the
    node tags in ascending order (a repeated tag keeps its last
    coordinates), consecutive chunks of one element type merge into one
    cell block."""
    elements = [(t, c) for t, c in elements if len(c)]
    max_dim = max((_DIM[t] for t, _ in elements), default=0)
    if max_dim < 2:
        raise ValueError("mesh has no 2D/3D cells")
    tags, coords = nodes
    order = np.argsort(tags, kind="stable")
    tags_s = tags[order]
    last = np.ones(len(tags_s), dtype=bool)
    last[:-1] = tags_s[1:] != tags_s[:-1]
    ids = tags_s[last]
    coords = coords[order][last]
    if max_dim == 2:
        coords = coords[:, :2]

    blocks: List[Tuple[str, List[np.ndarray]]] = []
    for t, conn in elements:
        if _DIM[t] != max_dim:
            continue
        idx = np.minimum(np.searchsorted(ids, conn), len(ids) - 1)
        missing = ids[idx] != conn
        if np.any(missing):
            raise KeyError(f"element node {int(conn[missing][0])} is not "
                           "among the mesh's nodes")
        if blocks and blocks[-1][0] == t:
            blocks[-1][1].append(idx)
        else:
            blocks.append((t, [idx]))
    cell_blocks = [(t, np.concatenate(c)) for t, c in blocks]
    return build_mesh(coords, cell_blocks, **kw)


def _read_msh22_ascii(data, sections):
    s, e = sections["Nodes"]
    toks = np.array(data[s:e].split())
    nn = int(toks[0])
    rec = toks[1: 1 + 4 * nn].reshape(nn, 4)
    nodes = (rec[:, 0].astype(np.int64), rec[:, 1:].astype(np.float64))
    s, e = sections["Elements"]
    vals = np.array(data[s:e].split()).astype(np.int64).tolist()
    ne = vals[0]
    elements: Elements = []
    pos = 1
    run_name, run = None, []
    for _ in range(ne):
        etype, ntags = vals[pos + 1], vals[pos + 2]
        name, nv = _TYPES[etype]
        if name != run_name and run:
            elements.append((run_name, np.asarray(run, np.int64)))
            run = []
        run_name = name
        run.append(vals[pos + 3 + ntags: pos + 3 + ntags + nv])
        pos += 3 + ntags + nv
    if run:
        elements.append((run_name, np.asarray(run, np.int64)))
    return nodes, elements


def _read_msh22_binary(data, sections):
    s, e = sections["Nodes"]
    nl = data.find(b"\n", s)
    nn = int(data[s:nl])
    rec = np.frombuffer(data, dtype=np.dtype([("id", "<i4"), ("x", "<f8", 3)]),
                        count=nn, offset=nl + 1)
    nodes = (rec["id"].astype(np.int64), rec["x"].astype(np.float64))

    s, e = sections["Elements"]
    nl = data.find(b"\n", s)
    ne = int(data[s:nl])
    pos = nl + 1
    elements: Elements = []
    read = 0
    while read < ne:
        etype, nfollow, ntags = struct.unpack_from("<3i", data, pos)
        pos += 12
        name, nv = _TYPES[etype]
        width = 1 + ntags + nv
        block = np.frombuffer(data, dtype="<i4", count=nfollow * width,
                              offset=pos).reshape(nfollow, width)
        elements.append((name, block[:, 1 + ntags:].astype(np.int64)))
        pos += 4 * nfollow * width
        read += nfollow
    return nodes, elements


def _read_msh41_binary(data, sections, swap=False):
    """Gmsh 4.1 binary: size_t (8-byte) counts and tags, int entity
    headers, double coordinates (gmsh doc 'MSH file format 4.1')."""
    end = ">" if swap else "<"
    u8 = struct.Struct(end + "Q")
    i4 = struct.Struct(end + "i")

    def read_u8(pos):
        return u8.unpack_from(data, pos)[0], pos + 8

    def read_i4(pos):
        return i4.unpack_from(data, pos)[0], pos + 4

    s, e = sections["Nodes"]
    pos = s
    num_blocks, pos = read_u8(pos)
    pos += 24  # number of nodes, min and max tag
    tags, coords = [], []
    for _ in range(num_blocks):
        pos += 8  # entity dim and tag
        parametric, pos = read_i4(pos)
        nb, pos = read_u8(pos)
        tags.append(np.frombuffer(data, dtype=end + "u8", count=nb,
                                  offset=pos).astype(np.int64))
        pos += 8 * nb
        ncoord = 3 + (3 if parametric else 0)
        block = np.frombuffer(data, dtype=end + "f8", count=nb * ncoord,
                              offset=pos).reshape(nb, ncoord)
        coords.append(block[:, :3].astype(np.float64))
        pos += 8 * nb * ncoord
    nodes = (np.concatenate(tags), np.concatenate(coords).reshape(-1, 3))

    s, e = sections["Elements"]
    pos = s
    num_blocks, pos = read_u8(pos)
    pos += 24  # number of elements, min and max tag
    elements: Elements = []
    for _ in range(num_blocks):
        pos += 8  # entity dim and tag
        etype, pos = read_i4(pos)
        nb, pos = read_u8(pos)
        name, nv = _TYPES[etype]
        block = np.frombuffer(data, dtype=end + "u8", count=nb * (1 + nv),
                              offset=pos).reshape(nb, 1 + nv)
        pos += 8 * nb * (1 + nv)
        elements.append((name, block[:, 1:].astype(np.int64)))
    return nodes, elements


def _read_msh41_ascii(data, sections):
    s, e = sections["Nodes"]
    toks = np.array(data[s:e].split())
    num_blocks = int(toks[0])
    pos = 4
    tags, coords = [], []
    for _ in range(num_blocks):
        nb = int(toks[pos + 3])
        pos += 4
        tags.append(toks[pos: pos + nb].astype(np.int64))
        pos += nb
        coords.append(toks[pos: pos + 3 * nb].astype(np.float64)
                      .reshape(nb, 3))
        pos += 3 * nb
    nodes = (np.concatenate(tags), np.concatenate(coords).reshape(-1, 3))
    s, e = sections["Elements"]
    toks = np.array(data[s:e].split())
    num_blocks = int(toks[0])
    pos = 4
    elements: Elements = []
    for _ in range(num_blocks):
        etype = int(toks[pos + 2])
        nb = int(toks[pos + 3])
        pos += 4
        name, nv = _TYPES[etype]
        block = toks[pos: pos + nb * (1 + nv)].astype(np.int64)
        elements.append((name, block.reshape(nb, 1 + nv)[:, 1:]))
        pos += nb * (1 + nv)
    return nodes, elements
