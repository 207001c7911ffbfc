"""MINC (Multiple INteracting Continua) dual/multiple porosity
(counterpart of waiwera_tpu/mesh/minc.py, numpy host code).

Counterpart of minc.F90 and the reference's MINC DMPlex surgery
(mesh.F90:2127+, 3026-3182), redesigned as a host-side mesh
transformation: matrix cells are appended as extra rows of the dense
cell arrays, with one nested 1-D connection chain per fracture cell
(fracture -> m1 -> m2 -> ...). MINC faces have zero gravity normal and
the 'nested cube' connection areas/distances from the proximity
function (Pruess 1983 GMINC):

    p(d) = 1 - prod_j (1 - 2 d / spacing_j)

Connection distances come from root finds of p(x) = cumulative matrix
volume fraction (minc_setup_geometry, minc.F90:462-545), done here with
numpy bisection at setup time.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

import numpy as np


@dataclass
class MincZone:
    """Host data for one MINC zone (minc_type, minc.F90:33-53)."""

    volume: np.ndarray  # [1 + num_levels] normalised fractions
    num_levels: int
    fracture_planes: int
    fracture_spacing: np.ndarray  # [planes]
    fracture_connection_distance: float
    connection_distance: np.ndarray = None  # [num_levels + 1]
    connection_area: np.ndarray = None  # [num_levels] (scaled by volume)
    fracture_rock: str = ""
    matrix_rock: List[str] = field(default_factory=list)
    cells: np.ndarray = None  # fracture cell indices

    def proximity(self, d):
        fout = 1.0 - 2.0 * d / self.fracture_spacing
        if np.any(fout < 0.0):
            return 1.0
        return 1.0 - np.prod(fout)

    def proximity_derivative(self, d):
        fout = 1.0 - 2.0 * d / self.fracture_spacing
        if np.any(fout < 0.0):
            return 0.0
        total = 0.0
        for j in range(len(fout)):
            excl = np.prod(np.delete(fout, j))
            total += excl / self.fracture_spacing[j]
        return 2.0 * total

    def inner_connection_distance(self, x):
        """Innermost connection distance (Pruess 1983;
        minc.F90:437-458)."""
        u = self.fracture_spacing - 2.0 * x
        if self.fracture_planes == 1:
            return u[0] / 6.0
        if self.fracture_planes == 2:
            return 0.25 * np.prod(u) / np.sum(u)
        pair_sum = u[0] * u[1] + u[1] * u[2] + u[0] * u[2]
        return 0.3 * np.prod(u) / pair_sum

    def setup_geometry(self):
        """Connection areas/distances (minc_setup_geometry)."""
        nl = self.num_levels
        self.connection_distance = np.zeros(nl + 1)
        self.connection_area = np.zeros(nl)
        vmatrix = 1.0 - self.volume[0]
        volsum = np.cumsum(self.volume[1:]) / vmatrix
        x = 0.0
        self.connection_distance[0] = self.fracture_connection_distance
        self.connection_area[0] = vmatrix * self.proximity_derivative(0.0)
        xr = self.volume[1] / max(self.connection_area[0], 1e-30)
        for i in range(nl - 1):
            xl = x
            target = volsum[i]
            while self.proximity(xr) - target < 0.0:
                xr *= 2.0
            a, b = xl, xr
            for _ in range(80):  # bisection
                m = 0.5 * (a + b)
                if (self.proximity(a) - target) * (
                    self.proximity(m) - target
                ) <= 0.0:
                    b = m
                else:
                    a = m
            x = 0.5 * (a + b)
            self.connection_distance[i + 1] = 0.5 * (x - xl)
            self.connection_area[i + 1] = vmatrix * \
                self.proximity_derivative(x)
        self.connection_distance[nl] = self.inner_connection_distance(x)


def parse_minc(minc_cfg, zones) -> List[MincZone]:
    """Parse the mesh.minc JSON section (minc_init, minc.F90:58-180)."""
    if isinstance(minc_cfg, dict):
        minc_cfg = [minc_cfg]
    out = []
    for spec in minc_cfg:
        geom = spec.get("geometry", {}) or {}
        frac = geom.get("fracture", {}) or {}
        matrix = geom.get("matrix", {}) or {}
        mvol = matrix.get("volume", None)
        if "volume" in frac:
            fvol = float(frac["volume"])
            if mvol is None:
                mvol = [1.0 - fvol]
            mvol = np.atleast_1d(np.asarray(mvol, np.float64))
        else:
            mvol = np.atleast_1d(
                np.asarray(mvol if mvol is not None else [0.9], np.float64)
            )
            fvol = 1.0 - mvol.sum()
        volume = np.concatenate([[fvol], mvol])
        volume = volume / volume.sum()
        planes = int(frac.get("planes", 1))
        spacing = np.atleast_1d(
            np.asarray(frac.get("spacing", 50.0), np.float64)
        )
        if len(spacing) < planes:
            spacing = np.concatenate(
                [spacing, np.full(planes - len(spacing), spacing[-1])]
            )
        rock = spec.get("rock", {}) or {}
        frock = (rock.get("fracture", {}) or {}).get("type", "")
        mrock_spec = rock.get("matrix", {}) or {}
        if isinstance(mrock_spec, list):
            mrock = [m.get("type", "") for m in mrock_spec]
        else:
            mrock = [mrock_spec.get("type", "")] * len(mvol)
        if len(mrock) < len(mvol):
            mrock = mrock + [mrock[-1]] * (len(mvol) - len(mrock))

        zone_names = rock.get("zones", spec.get("zones"))
        if zone_names is None:
            raise ValueError("MINC spec has no zones")
        sel = np.zeros(0, np.int64)
        names = np.atleast_1d(zone_names)
        cells = []
        for nm in names:
            if nm not in zones:
                raise ValueError(f"unknown MINC zone {nm!r}")
            cells.append(zones[nm])
        cells = np.unique(np.concatenate(cells))

        mz = MincZone(
            volume=volume,
            num_levels=len(mvol),
            fracture_planes=planes,
            fracture_spacing=spacing[:planes],
            fracture_connection_distance=float(
                frac.get("connection", 0.0)
            ),
            fracture_rock=frock,
            matrix_rock=mrock,
            cells=cells,
        )
        mz.setup_geometry()
        out.append(mz)
    return out


def apply_minc(mesh, minc_zones: List[MincZone]):
    """Append matrix cells and fracture-matrix connection faces to the
    mesh (the dense-array equivalent of setup_minc_dm +
    setup_minc_geometry). Must run before boundaries are added.

    Adds to the mesh:
    - minc_level [N]: 0 for fracture/regular cells, m for matrix level m
    - minc_parent [N]: index of the originating fracture cell (itself
      for non-MINC cells)
    - minc_rock: list of (cell_indices, rock_type_name)
    """
    n0 = mesh.num_interior_cells
    assert mesh.num_cells == n0, "apply MINC before boundaries"

    new_centroid = [mesh.cell_centroid]
    new_volume = [mesh.cell_volume.copy()]
    level = np.zeros(n0, np.int32)
    parent = np.arange(n0, dtype=np.int64)

    add_cells_centroid = []
    add_cells_volume = []
    add_level = []
    add_parent = []
    add_face_cells = []
    add_face_area = []
    add_face_distance = []
    add_face_normal = []
    add_face_gravity = []
    add_face_centroid = []
    add_face_perm = []
    minc_rock = []

    next_cell = n0
    for mz in minc_zones:
        frac_rock_cells = list(mz.cells)
        level_rock_cells = [[] for _ in range(mz.num_levels)]
        for c in mz.cells:
            vol0 = mesh.cell_volume[c]
            new_volume[0][c] = vol0 * mz.volume[0]
            prev = c
            for m in range(mz.num_levels):
                ic = next_cell
                next_cell += 1
                add_cells_centroid.append(mesh.cell_centroid[c])
                add_cells_volume.append(vol0 * mz.volume[m + 1])
                add_level.append(m + 1)
                add_parent.append(c)
                level_rock_cells[m].append(ic)
                # face prev -> ic (mesh.F90:3131-3145)
                add_face_cells.append([prev, ic])
                add_face_area.append(vol0 * mz.connection_area[m])
                add_face_distance.append(
                    [mz.connection_distance[m],
                     mz.connection_distance[m + 1]]
                )
                add_face_normal.append([0.0, 0.0, 0.0])
                add_face_gravity.append(0.0)
                add_face_centroid.append(mesh.cell_centroid[c])
                add_face_perm.append(0)
                prev = ic
        if mz.fracture_rock:
            minc_rock.append((np.asarray(frac_rock_cells, np.int64),
                              mz.fracture_rock))
        for m in range(mz.num_levels):
            if mz.matrix_rock[m]:
                minc_rock.append(
                    (np.asarray(level_rock_cells[m], np.int64),
                     mz.matrix_rock[m])
                )

    n_new = next_cell - n0
    if n_new == 0:
        mesh.minc_level = level
        mesh.minc_parent = parent
        mesh.minc_rock = []
        return

    mesh.cell_centroid = np.concatenate(
        [new_centroid[0], np.asarray(add_cells_centroid)]
    )
    mesh.cell_volume = np.concatenate(
        [new_volume[0], np.asarray(add_cells_volume)]
    )
    mesh.minc_level = np.concatenate(
        [level, np.asarray(add_level, np.int32)]
    )
    mesh.minc_parent = np.concatenate(
        [parent, np.asarray(add_parent, np.int64)]
    )
    mesh.minc_rock = minc_rock
    mesh.num_interior_cells = next_cell
    mesh.num_cells = next_cell
    mesh.is_ghost = np.zeros(next_cell, bool)

    mesh.face_cells = np.concatenate(
        [mesh.face_cells, np.asarray(add_face_cells, np.int64)]
    )
    mesh.face_area = np.concatenate(
        [mesh.face_area, np.asarray(add_face_area)]
    )
    dist = np.asarray(add_face_distance)
    mesh.face_distance = np.concatenate([mesh.face_distance, dist])
    mesh.face_distance12 = np.concatenate(
        [mesh.face_distance12, dist.sum(axis=1)]
    )
    mesh.face_normal = np.concatenate(
        [mesh.face_normal, np.asarray(add_face_normal)]
    )
    mesh.face_gravity_normal = np.concatenate(
        [mesh.face_gravity_normal, np.asarray(add_face_gravity)]
    )
    mesh.face_centroid = np.concatenate(
        [mesh.face_centroid, np.asarray(add_face_centroid)]
    )
    mesh.face_permeability_direction = np.concatenate(
        [
            mesh.face_permeability_direction,
            np.asarray(add_face_perm, mesh.face_permeability_direction.dtype),
        ]
    )
