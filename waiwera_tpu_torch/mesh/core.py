"""Finite-volume mesh geometry and connectivity (counterpart of
waiwera_tpu/mesh/core.py, numpy geometry path).

Host-side (NumPy) replacement for the reference's PETSc DMPlex stack:
- cell/face connectivity by vectorised face dedup (DMPlex cones/supports)
- FV geometry equivalent to DMPlexComputeGeometryFVM + Waiwera's
  modifications (mesh.F90:341-580): 2-D thickness / radial Pappus
  corrections, non-orthogonal distance correction, gravity normals,
  permeability directions
- Dirichlet boundaries as appended ghost cells with zero volume and
  centroid on the face (mesh.F90:583-667)

Cell order is the input (natural) order. Elements: triangles and
quadrilaterals in 2-D; tetrahedra, pyramids, wedges and hexahedra in
3-D, in blocks of one type each (mixed meshes have several blocks).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np

# face templates per element type: local vertex indices per face, in
# cyclic order; the orientation is normalised numerically (outward check)
_FACES_3D = {
    "tetra": [(0, 2, 1), (0, 1, 3), (1, 2, 3), (2, 0, 3)],
    "pyramid": [(0, 3, 2, 1), (0, 1, 4), (1, 2, 4), (2, 3, 4), (3, 0, 4)],
    "wedge": [(0, 2, 1), (3, 4, 5), (0, 1, 4, 3), (1, 2, 5, 4), (2, 0, 3, 5)],
    "hexahedron": [
        (0, 3, 2, 1),
        (4, 5, 6, 7),
        (0, 1, 5, 4),
        (1, 2, 6, 5),
        (2, 3, 7, 6),
        (3, 0, 4, 7),
    ],
}
# edges of the 2-D elements: the 'faces' of a 2-D mesh
_EDGES_2D = {
    "triangle": [(0, 1), (1, 2), (2, 0)],
    "quad": [(0, 1), (1, 2), (2, 3), (3, 0)],
}


@dataclass
class BoundarySpec:
    """One 'boundaries' entry from JSON: Dirichlet condition applied in
    ghost cells across the listed faces."""

    primary: np.ndarray  # [npv] boundary primary variables
    region: int
    cells: np.ndarray  # ghost cell indices (into the padded cell range)
    faces: np.ndarray  # face indices of the boundary faces
    tracer: Optional[np.ndarray] = None  # boundary tracer values


@dataclass
class Mesh:
    dim: int
    num_interior_cells: int
    num_cells: int  # interior + boundary ghost
    cell_centroid: np.ndarray  # [N, 3]
    cell_volume: np.ndarray  # [N]
    face_cells: np.ndarray  # [F, 2]
    face_area: np.ndarray  # [F]
    face_normal: np.ndarray  # [F, 3]
    face_centroid: np.ndarray  # [F, 3]
    is_ghost: np.ndarray  # [N] bool
    gravity: np.ndarray  # [3]
    # exterior faces of the input mesh (closed / no-flux unless a
    # boundary condition opens them)
    exterior_face_cell: np.ndarray  # [Fb]
    exterior_face_centroid: np.ndarray  # [Fb, 3]
    exterior_face_normal: np.ndarray  # [Fb, 3]
    exterior_face_area: np.ndarray  # [Fb]
    # filled by _finish_face_geometry
    face_distance: np.ndarray = None  # [F, 2]
    face_distance12: np.ndarray = None  # [F]
    face_gravity_normal: np.ndarray = None  # [F]
    face_permeability_direction: np.ndarray = None  # [F] int (0-based)
    boundaries: List[BoundarySpec] = field(default_factory=list)
    radial: bool = False
    thickness: float = 1.0

    @property
    def num_faces(self) -> int:
        return len(self.face_area)


def _polygon_geometry(verts: np.ndarray):
    """Area vector and centroid of polygons given as [n, k, 3] vertex
    coords (k >= 3). Fan triangulation around the vertex mean, as in
    PETSc's FV geometry. Returns (area_normal [n,3], centroid [n,3])."""
    mean = verts.mean(axis=1, keepdims=True)  # [n, 1, 3]
    k = verts.shape[1]
    areas = np.zeros((verts.shape[0], 3))
    cent = np.zeros((verts.shape[0], 3))
    total = np.zeros(verts.shape[0])
    for i in range(k):
        a = verts[:, i] - mean[:, 0]
        b = verts[:, (i + 1) % k] - mean[:, 0]
        tri_n = 0.5 * np.cross(a, b)  # [n, 3]
        tri_c = (verts[:, i] + verts[:, (i + 1) % k] + mean[:, 0]) / 3.0
        tri_a = np.linalg.norm(tri_n, axis=1)
        areas += tri_n
        cent += tri_c * tri_a[:, None]
        total += tri_a
    total = np.where(total > 0, total, 1.0)
    return areas, cent / total[:, None]


def _pad3(x: np.ndarray) -> np.ndarray:
    """Pad [n, dim] coordinates to [n, 3]."""
    if x.shape[1] == 3:
        return x
    out = np.zeros((x.shape[0], 3))
    out[:, : x.shape[1]] = x
    return out


def _edge_geometry(verts: np.ndarray):
    """2-D 'faces' are edges [n, 2, 3]. Returns (area_normal [n, 3], the
    in-plane normal scaled by the edge length, centroid [n, 3])."""
    d = verts[:, 1] - verts[:, 0]
    # normal perpendicular to the edge in the xy-plane
    n = np.stack([d[:, 1], -d[:, 0], np.zeros(len(d))], axis=1)
    return n, 0.5 * (verts[:, 0] + verts[:, 1])


def _extract_faces(dim: int, cell_blocks, cell_offsets):
    """All (cell, face) pairs, block by block and template by template:
    (sorted vertex keys [nf_all, kmax], cell index [nf_all], vertex ids
    in cyclic order [nf_all, kmax]); faces with fewer than kmax vertices
    (triangles of a 3-D mesh) are padded with -1 in front."""
    kmax = 4 if dim == 3 else 2
    keys, cells, faces = [], [], []
    for (etype, conn), off in zip(cell_blocks, cell_offsets):
        templates = _FACES_3D[etype] if dim == 3 else _EDGES_2D[etype]
        nc = len(conn)
        for tmpl in templates:
            fv = conn[:, list(tmpl)]
            pad = np.full((nc, kmax - fv.shape[1]), -1, dtype=fv.dtype)
            keys.append(np.concatenate([pad, np.sort(fv, axis=1)], axis=1))
            faces.append(np.concatenate([pad, fv], axis=1))
            cells.append(off + np.arange(nc))
    return (np.concatenate(keys), np.concatenate(cells),
            np.concatenate(faces))


def _cell_geometry_2d(pts: np.ndarray):
    """Area and centroid of polygons [nc, k, 3] (shoelace over triangles
    around the vertex mean)."""
    vmean = pts.mean(axis=1)
    k = pts.shape[1]
    area = np.zeros(len(pts))
    cent = np.zeros((len(pts), 3))
    for i in range(k):
        a = pts[:, i] - vmean
        b = pts[:, (i + 1) % k] - vmean
        tri = 0.5 * (a[:, 0] * b[:, 1] - a[:, 1] * b[:, 0])
        tri_c = (pts[:, i] + pts[:, (i + 1) % k] + vmean) / 3.0
        area += tri
        cent += tri[:, None] * tri_c
    return np.abs(area), cent / np.where(area != 0, area, 1.0)[:, None]


def _cell_geometry_3d(pts: np.ndarray, templates):
    """Volume and centroid of polyhedra [nc, nv, 3] with the given face
    templates: tetrahedra (cell mean, face mean, edge)."""
    vmean = pts.mean(axis=1)  # [nc, 3]
    vol = np.zeros(len(pts))
    cent = np.zeros((len(pts), 3))
    for tmpl in templates:
        fverts = pts[:, list(tmpl)]  # [nc, k, 3]
        fmean = fverts.mean(axis=1)
        k = fverts.shape[1]
        for i in range(k):
            a = fverts[:, i]
            b = fverts[:, (i + 1) % k]
            d1 = fmean - vmean
            d2 = a - vmean
            d3 = b - vmean
            tv = np.einsum("ij,ij->i", d1, np.cross(d2, d3)) / 6.0
            tc = (vmean + fmean + a + b) / 4.0
            vol += tv
            cent += tv[:, None] * tc
    return np.abs(vol), cent / np.where(vol != 0, vol, 1.0)[:, None]


def _face_geometry_3d(v3: np.ndarray, fv: np.ndarray):
    """(area_normal, centroid) of the faces given as padded vertex id
    rows [n, 4]: triangles (first slot -1) and quadrilaterals."""
    area_n = np.zeros((len(fv), 3))
    cent = np.zeros((len(fv), 3))
    tri = fv[:, 0] < 0
    for sel, cols in ((tri, slice(1, None)), (~tri, slice(None))):
        if np.any(sel):
            area_n[sel], cent[sel] = _polygon_geometry(v3[fv[sel][:, cols]])
    return area_n, cent


def _geometry(v3, dim, cell_blocks, cell_offsets, num_cells):
    """Cell and face geometry with numpy on the host (the reference
    path of build_mesh): (cell_volume, cell_centroid, cell_a, cell_b,
    area_normal, face_centroid, ext_cell, ext_area_normal,
    ext_centroid), interior normals oriented from cell_a to cell_b and
    exterior normals outward."""
    # ---- cell geometry -------------------------------------------
    cell_volume = np.zeros(num_cells)
    cell_centroid = np.zeros((num_cells, 3))
    for (etype, conn), off in zip(cell_blocks, cell_offsets):
        cells = slice(off, off + len(conn))
        if dim == 2:
            vol, cent = _cell_geometry_2d(v3[conn])
        else:
            vol, cent = _cell_geometry_3d(v3[conn], _FACES_3D[etype])
        cell_volume[cells] = vol
        cell_centroid[cells] = cent

    def face_geom(fv):
        if dim == 2:
            return _edge_geometry(v3[fv])
        return _face_geometry_3d(v3, fv)

    # ---- face extraction + dedup ---------------------------------
    keys, fcells, fverts = _extract_faces(dim, cell_blocks, cell_offsets)
    order = np.lexsort(keys.T[::-1])
    keys_s = keys[order]
    fcells_s = fcells[order]
    fverts_s = fverts[order]
    new_face = np.ones(len(keys_s), dtype=bool)
    new_face[1:] = np.any(keys_s[1:] != keys_s[:-1], axis=1)
    face_id = np.cumsum(new_face) - 1
    num_unique = face_id[-1] + 1
    counts = np.bincount(face_id, minlength=num_unique)
    if np.any(counts > 2):
        raise ValueError("mesh has faces shared by more than two cells")

    # interior faces: two supports
    first_idx = np.nonzero(new_face)[0]
    interior_ids = np.nonzero(counts == 2)[0]
    cell_a = fcells_s[first_idx[interior_ids]]
    idx_second = np.nonzero(~new_face)[0]
    cell_b = np.full(num_unique, -1, dtype=np.int64)
    cell_b[face_id[idx_second]] = fcells_s[idx_second]
    cell_b = cell_b[interior_ids]
    area_normal, fcentroid = face_geom(fverts_s[first_idx[interior_ids]])

    # exterior faces: one support
    ext_ids = np.nonzero(counts == 1)[0]
    ext_cell = fcells_s[first_idx[ext_ids]]
    ext_area_normal, ext_centroid = face_geom(fverts_s[first_idx[ext_ids]])

    # orient interior normals from cell_a to cell_b
    d12 = cell_centroid[cell_b] - cell_centroid[cell_a]
    flip = np.einsum("ij,ij->i", d12, area_normal) < 0
    area_normal[flip] *= -1.0
    # orient exterior normals outward
    d_out = ext_centroid - cell_centroid[ext_cell]
    eflip = np.einsum("ij,ij->i", d_out, ext_area_normal) < 0
    ext_area_normal[eflip] *= -1.0

    return (cell_volume, cell_centroid, cell_a, cell_b, area_normal,
            fcentroid, ext_cell, ext_area_normal, ext_centroid)


def build_mesh(
    vertices: np.ndarray,
    cell_blocks: Sequence[Tuple[str, np.ndarray]],
    gravity=None,
    radial: bool = False,
    thickness: float = 1.0,
    device=None,
) -> Mesh:
    """Build mesh connectivity and FV geometry from vertices [nv, dim]
    and cells: cell_blocks [(element_type, connectivity [nc_e, nvpe])],
    element types "triangle" and "quad" in 2-D, "tetra", "pyramid",
    "wedge" and "hexahedron" in 3-D, vertex indices 0-based. Cells are
    numbered block by block in input order (this is the natural order).
    Gravity defaults to 9.8 m/s2 down the last mesh dimension.

    device: None computes the geometry and the face-key sort with numpy
    on the host (the reference path); a torch device computes them
    there in f64 (mesh/geometry.py: the same face order, geometry equal
    to rounding). The Mesh is host numpy either way."""
    vertices = np.asarray(vertices, dtype=np.float64)
    dim = vertices.shape[1]
    g3 = np.zeros(3)
    if gravity is None:
        g3[dim - 1] = -9.8
    else:
        g = np.asarray(gravity, dtype=np.float64)
        g3[: len(g)] = g

    cell_blocks = [(etype, np.asarray(c, dtype=np.int64))
                   for etype, c in cell_blocks]
    sizes = [len(c) for _, c in cell_blocks]
    cell_offsets = np.concatenate([[0], np.cumsum(sizes)])[:-1]
    num_cells = int(sum(sizes))
    v3 = _pad3(vertices)

    if device is None:
        geom = _geometry(v3, dim, cell_blocks, cell_offsets, num_cells)
    else:
        from waiwera_tpu_torch.mesh.geometry import mesh_geometry

        geom = mesh_geometry(v3, dim, cell_blocks, cell_offsets, num_cells,
                             device)
    (cell_volume, cell_centroid, cell_a, cell_b, area_normal, fcentroid,
     ext_cell, ext_area_normal, ext_centroid) = geom

    area = np.linalg.norm(area_normal, axis=1)
    ext_area = np.linalg.norm(ext_area_normal, axis=1)
    mesh = Mesh(
        dim=dim,
        num_interior_cells=num_cells,
        num_cells=num_cells,
        cell_centroid=cell_centroid,
        cell_volume=cell_volume,
        face_cells=np.stack([cell_a, cell_b], axis=1),
        face_area=area,
        face_normal=area_normal / np.where(area > 0, area, 1.0)[:, None],
        face_centroid=fcentroid,
        is_ghost=np.zeros(num_cells, dtype=bool),
        gravity=g3,
        exterior_face_cell=ext_cell,
        exterior_face_centroid=ext_centroid,
        exterior_face_normal=(
            ext_area_normal / np.where(ext_area > 0, ext_area, 1.0)[:, None]
        ),
        exterior_face_area=ext_area,
        radial=radial,
        thickness=thickness,
    )

    # 2-D thickness / radial corrections (mesh.F90:341-440)
    if dim == 2:
        if radial:
            two_pi = 2.0 * np.pi
            mesh.cell_volume = (
                mesh.cell_volume * two_pi * np.abs(cell_centroid[:, 0])
            )
            mesh.face_area = (
                mesh.face_area * two_pi * np.abs(mesh.face_centroid[:, 0])
            )
            mesh.exterior_face_area = (
                mesh.exterior_face_area * two_pi
                * np.abs(mesh.exterior_face_centroid[:, 0])
            )
        else:
            mesh.cell_volume = mesh.cell_volume * thickness
            mesh.face_area = mesh.face_area * thickness
            mesh.exterior_face_area = mesh.exterior_face_area * thickness

    _finish_face_geometry(mesh)
    return mesh


def set_gravity(mesh: Mesh, gravity) -> None:
    """Set the gravity vector and recompute face gravity normals
    (including boundary faces added so far)."""
    g3 = np.zeros(3)
    g = np.asarray(gravity, dtype=np.float64)
    g3[: len(g)] = g
    mesh.gravity = g3
    mesh.face_gravity_normal = mesh.face_normal @ g3


def _finish_face_geometry(mesh: Mesh):
    """Distances (with non-orthogonal correction, face.F90:230-249),
    gravity normal, permeability direction."""
    c1 = mesh.cell_centroid[mesh.face_cells[:, 0]]
    c2 = mesh.cell_centroid[mesh.face_cells[:, 1]]
    n = mesh.face_normal
    d1 = np.einsum("ij,ij->i", mesh.face_centroid - c1, n)
    d2 = np.einsum("ij,ij->i", c2 - mesh.face_centroid, n)
    d12 = np.einsum("ij,ij->i", c2 - c1, n)
    s = d1 + d2
    corr = d12 / np.where(s != 0, s, 1.0)
    mesh.face_distance = np.stack([d1 * corr, d2 * corr], axis=1)
    mesh.face_distance12 = d12
    mesh.face_gravity_normal = n @ mesh.gravity
    mesh.face_permeability_direction = np.argmax(
        np.abs(n[:, : mesh.dim]), axis=1
    ).astype(np.int32)


def add_boundaries(mesh: Mesh, boundary_specs: List[dict], npv: int):
    """Create Dirichlet ghost cells from JSON 'boundaries' entries.

    Each spec: {"primary": [...], "region": r,
                "faces": {"cells": [...], "normal": [...]}}
    (or a list of such face groups). For each listed cell, its exterior
    face whose outward normal best matches the given normal is opened
    (mesh.F90:1069-1264 analogue). Ghost cells get zero volume and
    centroid on the face (mesh.F90:583-667).
    """
    if not boundary_specs:
        return
    ghost_index = mesh.num_cells
    add_face_cells = []
    add_area = []
    add_normal = []
    add_centroid = []
    specs_out = []

    for spec in boundary_specs:
        faces_spec = spec.get("faces", {})
        face_groups = faces_spec if isinstance(faces_spec, list) else [
            faces_spec
        ]
        ghosts = []
        for fg in face_groups:
            cells = np.atleast_1d(np.asarray(fg.get("cells", []), np.int64))
            n3 = np.zeros(3)
            normal_spec = np.asarray(
                fg.get("normal", [0.0] * mesh.dim), float
            )
            n3[: len(normal_spec)] = normal_spec
            nrm = np.linalg.norm(n3)
            if nrm > 0:
                n3 = n3 / nrm
            for c in cells:
                # candidate exterior faces of cell c
                cand = np.nonzero(mesh.exterior_face_cell == c)[0]
                if len(cand) == 0:
                    raise ValueError(
                        f"boundary cell {c} has no exterior face"
                    )
                best = cand[np.argmax(mesh.exterior_face_normal[cand] @ n3)]
                add_face_cells.append([c, ghost_index])
                add_area.append(mesh.exterior_face_area[best])
                add_normal.append(mesh.exterior_face_normal[best])
                add_centroid.append(mesh.exterior_face_centroid[best])
                ghosts.append(ghost_index)
                ghost_index += 1
        primary = np.atleast_1d(
            np.asarray(spec.get("primary", np.zeros(npv)), dtype=np.float64)
        )
        first_face = mesh.num_faces + len(add_area) - len(ghosts)
        specs_out.append(
            BoundarySpec(
                primary=primary,
                region=int(spec.get("region", 1)),
                cells=np.asarray(ghosts, dtype=np.int64),
                faces=np.arange(first_face, first_face + len(ghosts),
                                dtype=np.int64),
                tracer=(
                    np.atleast_1d(np.asarray(spec["tracer"], np.float64))
                    if spec.get("tracer") is not None
                    else None
                ),
            )
        )

    n_new = ghost_index - mesh.num_cells
    if n_new == 0:
        mesh.boundaries.extend(specs_out)
        return

    add_face_cells = np.asarray(add_face_cells, dtype=np.int64)
    add_area = np.asarray(add_area)
    add_normal = np.asarray(add_normal)
    add_centroid = np.asarray(add_centroid)

    # extend cell arrays: ghost centroids on their faces
    mesh.cell_centroid = np.concatenate([mesh.cell_centroid, add_centroid])
    mesh.cell_volume = np.concatenate([mesh.cell_volume, np.zeros(n_new)])
    mesh.is_ghost = np.concatenate(
        [mesh.is_ghost, np.ones(n_new, dtype=bool)]
    )
    mesh.num_cells = ghost_index

    # extend face arrays; boundary face distances: [d1, 0]
    c1 = mesh.cell_centroid[add_face_cells[:, 0]]
    d1 = np.einsum("ij,ij->i", add_centroid - c1, add_normal)
    mesh.face_cells = np.concatenate([mesh.face_cells, add_face_cells])
    mesh.face_area = np.concatenate([mesh.face_area, add_area])
    mesh.face_normal = np.concatenate([mesh.face_normal, add_normal])
    mesh.face_centroid = np.concatenate([mesh.face_centroid, add_centroid])
    mesh.face_distance = np.concatenate(
        [mesh.face_distance, np.stack([d1, np.zeros_like(d1)], axis=1)]
    )
    mesh.face_distance12 = np.concatenate([mesh.face_distance12, d1])
    mesh.face_gravity_normal = np.concatenate(
        [mesh.face_gravity_normal, add_normal @ mesh.gravity]
    )
    mesh.face_permeability_direction = np.concatenate([
        mesh.face_permeability_direction,
        np.argmax(np.abs(add_normal[:, : mesh.dim]), axis=1).astype(
            np.int32
        ),
    ])
    mesh.boundaries.extend(specs_out)
