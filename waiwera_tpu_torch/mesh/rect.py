"""Structured rectilinear mesh generators: hexahedral 3-D, quadrilateral
2-D and 1-D columns (counterpart of waiwera_tpu/mesh/rect.py).

Cells are numbered x-fastest, then y, then z (natural order).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from waiwera_tpu_torch.mesh.core import Mesh, build_mesh


def _edges(widths) -> np.ndarray:
    """Edge coordinates from a list of cell widths."""
    return np.concatenate([[0.0], np.cumsum(np.asarray(widths, np.float64))])


def rectangular_mesh(
    dx: Sequence[float],
    dy: Optional[Sequence[float]] = None,
    dz: Optional[Sequence[float]] = None,
    origin=None,
    gravity=None,
    radial: bool = False,
    thickness: float = 1.0,
) -> Mesh:
    """Rectilinear mesh from per-axis cell widths.

    - dx only: 1-D horizontal row modelled as 2-D quads of unit height.
    - dx + dy: 2-D quad mesh in (x, y), optionally radial (x is r) or
      with a thickness.
    - dx + dy + dz: 3-D hexahedral mesh.
    """
    if dy is None and dz is None:
        dy = [1.0]
    x, y = _edges(dx), _edges(dy)
    if origin is not None:
        origin = np.asarray(origin, dtype=np.float64)
        x, y = x + origin[0], y + origin[1]
    nx, ny = len(x) - 1, len(y) - 1
    if dz is None:
        X, Y = np.meshgrid(x, y, indexing="xy")
        verts = np.stack([X.ravel(), Y.ravel()], axis=1)

        def vid2(i, j):
            return j * (nx + 1) + i

        j, i = (a.ravel() for a in np.meshgrid(
            np.arange(ny), np.arange(nx), indexing="ij"))
        conn = np.stack(
            [vid2(i, j), vid2(i + 1, j), vid2(i + 1, j + 1), vid2(i, j + 1)],
            axis=1,
        ).astype(np.int64)
        return build_mesh(verts, [("quad", conn)], gravity=gravity,
                          radial=radial, thickness=thickness)

    z = _edges(dz)
    if origin is not None:
        z = z + origin[2]
    nz = len(z) - 1
    nvx, nvy, nvz = nx + 1, ny + 1, nz + 1
    verts = np.empty((nvx * nvy * nvz, 3))

    def vid(i, j, k):
        return (k * nvy + j) * nvx + i

    for k in range(nvz):
        for j in range(nvy):
            verts[vid(np.arange(nvx), j, k)] = np.stack(
                [x, np.full(nvx, y[j]), np.full(nvx, z[k])], axis=1
            )

    # cells x-fastest, then y, then z
    k, j, i = (
        a.ravel()
        for a in np.meshgrid(
            np.arange(nz), np.arange(ny), np.arange(nx), indexing="ij"
        )
    )
    conn = np.stack(
        [
            vid(i, j, k),
            vid(i + 1, j, k),
            vid(i + 1, j + 1, k),
            vid(i, j + 1, k),
            vid(i, j, k + 1),
            vid(i + 1, j, k + 1),
            vid(i + 1, j + 1, k + 1),
            vid(i, j + 1, k + 1),
        ],
        axis=1,
    ).astype(np.int64)
    return build_mesh(verts, [("hexahedron", conn)], gravity=gravity)


def column_mesh(
    dz: Sequence[float],
    area: float = 1.0,
    gravity=None,
    top: float = 0.0,
) -> Mesh:
    """1-D vertical column of quad cells (a 2-D mesh of width sqrt(area)
    and thickness sqrt(area)): cell 0 at the top, depth increasing with
    the cell index.

    Gravity defaults to (0, -9.8) in the 2-D plane, so the column's y
    axis is depth.
    """
    dz = np.asarray(dz, dtype=np.float64)
    w = float(np.sqrt(area))
    n = len(dz)
    zedges = top - np.concatenate([[0.0], np.cumsum(dz)])
    verts = np.empty((2 * (n + 1), 2))
    verts[0::2, 0] = 0.0
    verts[1::2, 0] = w
    verts[0::2, 1] = zedges
    verts[1::2, 1] = zedges
    v0 = 2 * np.arange(n)
    conn = np.stack([v0, v0 + 1, v0 + 3, v0 + 2], axis=1).astype(np.int64)
    if gravity is None:
        gravity = [0.0, -9.8]
    return build_mesh(verts, [("quad", conn)], gravity=gravity, thickness=w)
