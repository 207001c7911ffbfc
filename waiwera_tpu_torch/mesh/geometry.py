"""Mesh geometry on a torch device (the device path of
mesh/core.py build_mesh; counterpart of the geometry half of
waiwera_tpu/native: cell_geom_*, polygon_geom and sort_rows).

The same formulas as core.py's numpy functions, in f64 and in the same
operation order (vertex means as sequential sums, cross and dot products
written out), so that the geometry agrees with the numpy path to
rounding:

- cells: the shoelace fan around the vertex mean in 2-D, the tet fan
  (cell mean, face mean, edge) in 3-D;
- faces: all (cell, face) vertex keys, deduplicated by a lexicographic
  sort of the keys done as stable torch.sort passes from the last key
  column to the first (equal to numpy's stable lexsort, so the face
  order is the numpy path's exactly), then the fan geometry of each
  face and its orientation.

The results come back to the host as numpy arrays, as build_mesh's Mesh
holds them.
"""

from __future__ import annotations

import numpy as np
import torch

from waiwera_tpu_torch.mesh.core import _EDGES_2D, _FACES_3D


def _mean(x: torch.Tensor) -> torch.Tensor:
    """[n, k, 3] -> [n, 3]: the sum over k in order, over k."""
    s = x[:, 0]
    for i in range(1, x.shape[1]):
        s = s + x[:, i]
    return s / x.shape[1]


def _cross(a, b):
    return torch.stack([a[:, 1] * b[:, 2] - a[:, 2] * b[:, 1],
                        a[:, 2] * b[:, 0] - a[:, 0] * b[:, 2],
                        a[:, 0] * b[:, 1] - a[:, 1] * b[:, 0]], dim=1)


def _dot(a, b):
    return a[:, 0] * b[:, 0] + a[:, 1] * b[:, 1] + a[:, 2] * b[:, 2]


def _norm(a):
    return torch.sqrt(a[:, 0] * a[:, 0] + a[:, 1] * a[:, 1]
                      + a[:, 2] * a[:, 2])


def _cell_geometry_2d(pts):
    vmean = _mean(pts)
    k = pts.shape[1]
    area = pts.new_zeros(len(pts))
    cent = pts.new_zeros((len(pts), 3))
    for i in range(k):
        a = pts[:, i] - vmean
        b = pts[:, (i + 1) % k] - vmean
        tri = 0.5 * (a[:, 0] * b[:, 1] - a[:, 1] * b[:, 0])
        tri_c = (pts[:, i] + pts[:, (i + 1) % k] + vmean) / 3.0
        area = area + tri
        cent = cent + tri[:, None] * tri_c
    return torch.abs(area), cent / torch.where(area != 0, area, 1.0)[:, None]


def _cell_geometry_3d(pts, templates):
    vmean = _mean(pts)
    vol = pts.new_zeros(len(pts))
    cent = pts.new_zeros((len(pts), 3))
    for tmpl in templates:
        fverts = pts[:, list(tmpl)]
        fmean = _mean(fverts)
        k = fverts.shape[1]
        for i in range(k):
            a = fverts[:, i]
            b = fverts[:, (i + 1) % k]
            d1 = fmean - vmean
            tv = _dot(d1, _cross(a - vmean, b - vmean)) / 6.0
            tc = (vmean + fmean + a + b) / 4.0
            vol = vol + tv
            cent = cent + tv[:, None] * tc
    return torch.abs(vol), cent / torch.where(vol != 0, vol, 1.0)[:, None]


def _polygon_geometry(verts):
    mean = _mean(verts)
    k = verts.shape[1]
    areas = verts.new_zeros((verts.shape[0], 3))
    cent = verts.new_zeros((verts.shape[0], 3))
    total = verts.new_zeros(verts.shape[0])
    for i in range(k):
        a = verts[:, i] - mean
        b = verts[:, (i + 1) % k] - mean
        tri_n = 0.5 * _cross(a, b)
        tri_c = (verts[:, i] + verts[:, (i + 1) % k] + mean) / 3.0
        tri_a = _norm(tri_n)
        areas = areas + tri_n
        cent = cent + tri_c * tri_a[:, None]
        total = total + tri_a
    total = torch.where(total > 0, total, 1.0)
    return areas, cent / total[:, None]


def _face_geometry(v3, fv, dim):
    """(area_normal, centroid) of faces given as padded vertex rows."""
    if dim == 2:
        e = v3[fv]
        d = e[:, 1] - e[:, 0]
        n = torch.stack([d[:, 1], -d[:, 0], torch.zeros_like(d[:, 0])], 1)
        return n, 0.5 * (e[:, 0] + e[:, 1])
    area_n = v3.new_zeros((len(fv), 3))
    cent = v3.new_zeros((len(fv), 3))
    tri = fv[:, 0] < 0
    for sel, cols in ((tri, slice(1, None)), (~tri, slice(None))):
        rows = torch.nonzero(sel).reshape(-1)
        if len(rows):
            a, c = _polygon_geometry(v3[fv[rows][:, cols]])
            area_n[rows] = a
            cent[rows] = c
    return area_n, cent


def lexsort_rows(keys: torch.Tensor) -> torch.Tensor:
    """The stable lexicographic argsort of integer rows [n, k] (first
    column most significant): np.lexsort(keys.T[::-1]), as stable sorts
    from the last column to the first."""
    order = torch.arange(keys.shape[0], device=keys.device)
    for c in range(keys.shape[1] - 1, -1, -1):
        order = order[torch.sort(keys[order, c], stable=True).indices]
    return order


def mesh_geometry(v3: np.ndarray, dim: int, cell_blocks, cell_offsets,
                  num_cells: int, device):
    """core._geometry on `device`; the same outputs as numpy arrays."""
    device = torch.device(device)
    v = torch.as_tensor(v3, dtype=torch.float64, device=device)
    blocks = [(etype, torch.as_tensor(conn, device=device))
              for etype, conn in cell_blocks]

    cell_volume = v.new_zeros(num_cells)
    cell_centroid = v.new_zeros((num_cells, 3))
    for (etype, conn), off in zip(blocks, cell_offsets):
        if dim == 2:
            vol, cent = _cell_geometry_2d(v[conn])
        else:
            vol, cent = _cell_geometry_3d(v[conn], _FACES_3D[etype])
        cell_volume[off: off + len(conn)] = vol
        cell_centroid[off: off + len(conn)] = cent

    # every (cell, face) pair: sorted vertex keys, padded with -1 in
    # front to kmax columns, and the vertices in cyclic order
    kmax = 4 if dim == 3 else 2
    keys, fcells, fverts = [], [], []
    for (etype, conn), off in zip(blocks, cell_offsets):
        templates = _FACES_3D[etype] if dim == 3 else _EDGES_2D[etype]
        cells = off + torch.arange(len(conn), device=device)
        for tmpl in templates:
            fv = conn[:, list(tmpl)]
            pad = fv.new_full((len(conn), kmax - fv.shape[1]), -1)
            keys.append(torch.cat([pad, torch.sort(fv, dim=1).values], 1))
            fverts.append(torch.cat([pad, fv], 1))
            fcells.append(cells)
    keys = torch.cat(keys)
    order = lexsort_rows(keys)
    keys_s = keys[order]
    fcells_s = torch.cat(fcells)[order]
    fverts_s = torch.cat(fverts)[order]
    new_face = torch.ones(len(keys_s), dtype=torch.bool, device=device)
    new_face[1:] = torch.any(keys_s[1:] != keys_s[:-1], dim=1)
    face_id = torch.cumsum(new_face.to(torch.int64), 0) - 1
    counts = torch.bincount(face_id)
    if bool(torch.any(counts > 2)):
        raise ValueError("mesh has faces shared by more than two cells")

    first_idx = torch.nonzero(new_face).reshape(-1)
    interior_ids = torch.nonzero(counts == 2).reshape(-1)
    cell_a = fcells_s[first_idx[interior_ids]]
    idx_second = torch.nonzero(~new_face).reshape(-1)
    cell_b = torch.full((len(counts),), -1, dtype=torch.int64, device=device)
    cell_b[face_id[idx_second]] = fcells_s[idx_second]
    cell_b = cell_b[interior_ids]
    area_normal, fcentroid = _face_geometry(
        v, fverts_s[first_idx[interior_ids]], dim)
    ext_ids = torch.nonzero(counts == 1).reshape(-1)
    ext_cell = fcells_s[first_idx[ext_ids]]
    ext_area_normal, ext_centroid = _face_geometry(
        v, fverts_s[first_idx[ext_ids]], dim)

    # interior normals from cell_a to cell_b, exterior normals outward
    d12 = cell_centroid[cell_b] - cell_centroid[cell_a]
    area_normal = torch.where((_dot(d12, area_normal) < 0)[:, None],
                              -area_normal, area_normal)
    d_out = ext_centroid - cell_centroid[ext_cell]
    ext_area_normal = torch.where(
        (_dot(d_out, ext_area_normal) < 0)[:, None], -ext_area_normal,
        ext_area_normal)

    return tuple(t.cpu().numpy() for t in (
        cell_volume, cell_centroid, cell_a, cell_b, area_normal, fcentroid,
        ext_cell, ext_area_normal, ext_centroid))
