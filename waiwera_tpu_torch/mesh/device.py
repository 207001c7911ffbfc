"""Device-side mesh arrays (counterpart of waiwera_tpu/mesh/device.py).

Faces are stored in the JAX package's *canonical* order, so that the
fluxes of the two packages compare face by face: every face is oriented
so that cell_l < cell_r (swapping the per-side distances and negating
the signed gravity normal leaves the flux kernel invariant), then the
faces are sorted by (column offset, row). `face_perm` and `face_sign`
map canonical faces back to the host mesh's order and orientation for
the flux output (fluxes_to_host_order).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from waiwera_tpu_torch.mesh.core import Mesh
from waiwera_tpu_torch.ops.segment import RowGather, SegmentSum


class MeshArrays(NamedTuple):
    face_cells: torch.Tensor  # [F, 2] int64
    face_area: torch.Tensor  # [F]
    face_distance: torch.Tensor  # [F, 2]
    face_distance12: torch.Tensor  # [F]
    face_gravity_normal: torch.Tensor  # [F]
    face_permeability_direction: torch.Tensor  # [F] int64
    cell_volume: torch.Tensor  # [N]
    is_ghost: torch.Tensor  # [N] bool
    num_cells: int
    num_interior_cells: int
    # canonical -> host face mapping (host numpy):
    # host_flux[face_perm[f]] = face_sign[f] * device_flux[f]
    face_perm: Optional[np.ndarray] = None
    face_sign: Optional[np.ndarray] = None
    # per-face values into cells: the left cells' entries [F] then the
    # right cells' [F], in a fixed order (ops/segment.py)
    face_sum: Optional[SegmentSum] = None
    # x[face_cells[:, 0]] and x[face_cells[:, 1]] (ops/segment.py)
    face_rows: Optional[Tuple[RowGather, RowGather]] = None

    def to(self, dtype: torch.dtype) -> "MeshArrays":
        """The same mesh with its floating geometry cast to dtype."""
        return self._replace(**{
            k: v.to(dtype)
            for k, v in self._asdict().items()
            if isinstance(v, torch.Tensor) and v.is_floating_point()
        })


def mesh_arrays(mesh: Mesh, device="cpu") -> MeshArrays:
    fc = np.asarray(mesh.face_cells, np.int64).copy()
    dist = np.asarray(mesh.face_distance, float).copy()
    gn = np.asarray(mesh.face_gravity_normal, float).copy()
    # orient: cell_l < cell_r (flux kernel invariant under the swap)
    flip = fc[:, 0] > fc[:, 1]
    fc[flip] = fc[flip][:, ::-1]
    dist[flip] = dist[flip][:, ::-1]
    gn[flip] = -gn[flip]
    # sort by (offset, row): each band's faces become one run
    off = fc[:, 1] - fc[:, 0]
    perm = np.lexsort((fc[:, 0], off))

    def f64(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float64,
                               device=device)

    face_cells = torch.as_tensor(fc[perm], device=device)
    return MeshArrays(
        face_cells=face_cells,
        face_area=f64(np.asarray(mesh.face_area)[perm]),
        face_distance=f64(dist[perm]),
        face_distance12=f64(np.asarray(mesh.face_distance12)[perm]),
        face_gravity_normal=f64(gn[perm]),
        face_permeability_direction=torch.as_tensor(
            np.asarray(mesh.face_permeability_direction, np.int64)[perm],
            device=device,
        ),
        cell_volume=f64(mesh.cell_volume),
        is_ghost=torch.as_tensor(np.asarray(mesh.is_ghost, bool),
                                 device=device),
        num_cells=mesh.num_cells,
        num_interior_cells=mesh.num_interior_cells,
        face_perm=perm,
        face_sign=np.where(flip, -1.0, 1.0)[perm],
        face_sum=SegmentSum(np.concatenate([fc[perm, 0], fc[perm, 1]]),
                            mesh.num_cells, device),
        face_rows=face_rows(face_cells),
    )


def face_rows(face_cells: torch.Tensor) -> Tuple[RowGather, RowGather]:
    """The gathers of the faces' left and right cells."""
    return RowGather(face_cells[:, 0]), RowGather(face_cells[:, 1])


def fluxes_to_host_order(mesh: MeshArrays, fluxes) -> np.ndarray:
    """Canonical-order face values [F, k] (tensor or array) in the host
    mesh's face order and orientation (for /face_fields output). A
    tensor crosses to the host once."""
    if isinstance(fluxes, torch.Tensor):
        fluxes = fluxes.detach().cpu().numpy()
    a = np.asarray(fluxes)
    if mesh.face_perm is None:
        return a
    out = np.empty_like(a)
    out[mesh.face_perm] = a * mesh.face_sign[(...,) + (None,) * (a.ndim - 1)]
    return out
