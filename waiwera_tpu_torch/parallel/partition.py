"""Host-side mesh partitioning for multi-device runs (counterpart of
waiwera_tpu/parallel/partition.py; mesh.F90:40,143-171).

Interior cells are split into near-equal blocks by recursive coordinate
bisection of their centroids or by the greedy graph partitioner
(parallel/graph.py), whichever cuts fewer faces; every face is
replicated onto each rank owning one of its cells, and the halo routes
are precomputed: an all_gather table and the edge-coloured
point-to-point rounds.

Plan arrays are stacked with a leading rank axis [D, ...] and padded to
per-rank maxima, so that every rank holds the same local shapes
(n_local cells, f_local faces) as the JAX package's shard_map blocks,
and the plan equals the JAX package's array by array.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from waiwera_tpu_torch.ops import dia
from waiwera_tpu_torch.parallel import graph


class PartitionPlan(NamedTuple):
    """Static routing tables (host numpy, rank axis leading)."""

    num_devices: int
    n_local: int  # padded per-rank local cell count (owned + halo)
    n_owned: np.ndarray  # [D] owned-cell counts
    num_send: int  # padded send-buffer length S
    # local slot -> global cell (pad slots point at cell 0, masked out)
    local_cells: np.ndarray  # [D, n_local] int32
    owned_mask: np.ndarray  # [D, n_local] bool
    # faces replicated per rank in local canonical orientation (local
    # cell_l < cell_r); face_flip marks faces whose host orientation was
    # swapped (geometry and flux output sign)
    face_ids: np.ndarray  # [D, f_local] int32 global face ids
    face_cells_local: np.ndarray  # [D, f_local, 2] int32
    face_mask: np.ndarray  # [D, f_local] bool
    face_flip: np.ndarray  # [D, f_local] bool
    # all_gather exchange: pack owned slots send_idx, gather over ranks,
    # pull recv_src of the flat [D * S] buffer into the halo slots
    send_idx: np.ndarray  # [D, S] int32
    recv_src: np.ndarray  # [D, n_halo] int32
    n_owned_pad: int  # halo slots start here on every rank
    n_halo: int  # padded halo count
    # point-to-point rounds: each rank sends at most one buffer and
    # receives at most one per round (pad receive slot: n_local)
    p2p_perms: tuple  # per round: tuple of (src, dst) rank pairs
    p2p_send: np.ndarray  # [D, R, S_e] int32 local slots to pack
    p2p_recv: np.ndarray  # [D, R, S_e] int32 halo slots to fill
    # owner rank and owner-local slot of every global cell
    cell_device: np.ndarray  # [N] int32
    cell_slot: np.ndarray  # [N] int32


def _edge_cut(part: np.ndarray, face_cells: np.ndarray) -> int:
    return int(np.sum(part[face_cells[:, 0]] != part[face_cells[:, 1]]))


def _local_rcm(own: np.ndarray, face_cells: np.ndarray, n: int):
    """A rank's owned cells in reverse Cuthill-McKee order where that
    lowers the local bandwidth, else as given (ties keep natural
    order)."""
    if len(own) <= 2:
        return own
    indptr, indices = graph.csr_adjacency(face_cells, own, n)
    perm = graph.rcm(indptr, indices, len(own))

    def bandwidth(order):
        inv = np.empty(len(own), np.int64)
        inv[order] = np.arange(len(own))
        a = inv[indices]
        b = inv[np.repeat(np.arange(len(own)), np.diff(indptr))]
        return int(np.abs(a - b).max()) if len(a) else 0

    if bandwidth(perm) < bandwidth(np.arange(len(own))):
        return own[perm]
    return own


def _rcb(centroids: np.ndarray, ids: np.ndarray, num_parts: int,
         weights: np.ndarray = None):
    """Recursive coordinate bisection: ids split into num_parts groups
    by medians along the longest bounding-box axis; with per-cell
    weights the splits balance total weight (MINC chains)."""
    if num_parts == 1:
        return [ids]
    n_left_parts = num_parts // 2
    frac = n_left_parts / num_parts
    span = centroids[ids].max(axis=0) - centroids[ids].min(axis=0)
    axis = int(np.argmax(span))
    order = ids[np.argsort(centroids[ids, axis], kind="stable")]
    if weights is None:
        k = int(round(len(ids) * frac))
    else:
        cw = np.cumsum(weights[order])
        k = int(np.searchsorted(cw, frac * cw[-1]))
    k = min(max(k, 1), len(ids) - 1)
    return _rcb(centroids, order[:k], n_left_parts, weights) + _rcb(
        centroids, order[k:], num_parts - n_left_parts, weights
    )


def _canonical_face_order(a_l, b_l, gh, owned_both):
    """Per-rank face order: owned-owned non-ghost faces with positive
    local offset first, grouped by (offset, row); cross-rank, ghost and
    pad faces form the indexed tail."""
    banded = owned_both & ~gh & (b_l > a_l)
    off = np.where(banded, b_l - a_l, 0)
    return np.lexsort((a_l, off, ~banded))


def _has_common_plan(locals_, halos, faces, face_cells, is_ghost, part,
                     n_owned_pad, n_local, num_devices):
    """Does the natural local order give every rank one and the same
    face plan (halo slots counted as ghost)?"""
    n = len(part)
    f_local = max((len(f) for f in faces), default=0) or 1
    common = None
    for d in range(num_devices):
        own, halo, fsel = locals_[d], halos[d], faces[d]
        g2l = np.full(n, -1, np.int64)
        g2l[own] = np.arange(len(own))
        g2l[halo] = n_owned_pad + np.arange(len(halo))
        fc_d = face_cells[fsel]
        a_l = g2l[fc_d[:, 0]]
        b_l = g2l[fc_d[:, 1]]
        a_l, b_l = np.minimum(a_l, b_l), np.maximum(a_l, b_l)
        gh = is_ghost[fc_d[:, 0]] | is_ghost[fc_d[:, 1]]
        owned_both = (part[fc_d[:, 0]] == d) & (part[fc_d[:, 1]] == d)
        order = _canonical_face_order(a_l, b_l, gh, owned_both)
        fcl = np.zeros((f_local, 2), np.int64)
        fcl[: len(fsel), 0] = a_l[order]
        fcl[: len(fsel), 1] = b_l[order]
        ghost_like = np.zeros(n_local, bool)
        ghost_like[: len(own)] = is_ghost[own]
        ghost_like[n_owned_pad:] = True
        fp = dia.face_plan_direct(fcl, ghost_like, n_local)
        if fp is None or (common is not None and fp != common):
            return False
        common = fp
    return common is not None


def _graph_candidate(face_cells, is_ghost, interior, part, n, num_devices,
                     mat=None, parent=None):
    """The graph partitioner's assignment where it is balanced (every
    part non-empty, none above 1.2x the ideal share) and cuts fewer
    interior faces than `part`; else `part`."""
    indptr, indices = graph.csr_adjacency(face_cells, interior, n)
    part_g = graph.partition_graph(indptr, indices, len(interior),
                                   num_devices)
    cand = np.zeros(n, np.int64)
    cand[interior] = part_g
    if mat is not None:
        cand[mat] = cand[parent[mat]]
    sizes = np.bincount(cand[interior], minlength=num_devices)
    ideal = len(interior) / num_devices
    if sizes.min() > 0 and sizes.max() <= 1.2 * ideal:
        inner = ~(is_ghost[face_cells[:, 0]] | is_ghost[face_cells[:, 1]])
        if _edge_cut(cand, face_cells[inner]) < _edge_cut(
                part, face_cells[inner]):
            return cand
    return part


def build_partition(mesh, num_devices: int) -> PartitionPlan:
    n = mesh.num_cells
    face_cells = np.asarray(mesh.face_cells, np.int64)
    centroids = np.asarray(mesh.cell_centroid, float)[:, : max(mesh.dim, 1)]

    # interior cells: RCB or the graph partitioner, whichever cuts fewer
    # faces; Dirichlet ghosts follow their interior neighbour. MINC
    # meshes split the fracture cells weighted by their chains and put
    # each matrix cell with its fracture cell.
    is_ghost = np.asarray(mesh.is_ghost, bool)
    interior = np.nonzero(~is_ghost)[0]
    part = np.zeros(n, np.int64)
    minc_level = getattr(mesh, "minc_level", None)
    minc_parent = getattr(mesh, "minc_parent", None)
    has_minc = (minc_level is not None and minc_parent is not None
                and np.any(np.asarray(minc_level) > 0))
    mat = parent = None
    if has_minc:
        level = np.asarray(minc_level, np.int64)
        parent = np.asarray(minc_parent, np.int64)
        chain = np.bincount(parent[interior], minlength=n)
        prim = interior[level[interior] == 0]
        groups = _rcb(centroids, prim, num_devices, weights=chain)
    else:
        groups = _rcb(centroids, interior, num_devices)
    for d, ids in enumerate(groups):
        part[ids] = d
    if has_minc:
        mat = interior[level[interior] > 0]
        part[mat] = part[parent[mat]]
    if num_devices > 1:
        part = _graph_candidate(face_cells, is_ghost, interior, part, n,
                                num_devices, mat, parent)
    ghosts = np.nonzero(is_ghost)[0]
    if len(ghosts):
        owner = np.full(n, -1, np.int64)
        for side in (0, 1):
            g = face_cells[:, side]
            o = face_cells[:, 1 - side]
            sel = is_ghost[g] & ~is_ghost[o]
            owner[g[sel]] = o[sel]
        has = owner[ghosts] >= 0
        part[ghosts[has]] = part[owner[ghosts[has]]]

    # faces per rank: replicated onto every rank owning an endpoint
    part_l = part[face_cells[:, 0]]
    part_r = part[face_cells[:, 1]]
    locals_, halos, faces = [], [], []
    for d in range(num_devices):
        own = np.nonzero(part == d)[0]
        fsel = np.nonzero((part_l == d) | (part_r == d))[0]
        ends = np.unique(face_cells[fsel].ravel())
        locals_.append(own)
        halos.append(ends[part[ends] != d])
        faces.append(fsel)

    n_owned = np.array([len(o) for o in locals_], np.int64)
    n_owned_pad = int(n_owned.max()) if num_devices else 0
    n_halo = max(max((len(h) for h in halos), default=0), 1)
    f_local = max(max((len(f) for f in faces), default=0), 1)
    n_local = n_owned_pad + n_halo

    # natural order where it gives every rank one face plan (the banded
    # route), else local RCM (helps the DILU sweeps on unstructured
    # partitions)
    if not _has_common_plan(locals_, halos, faces, face_cells, is_ghost,
                            part, n_owned_pad, n_local, num_devices):
        locals_ = [_local_rcm(own, face_cells, n) for own in locals_]

    local_cells = np.zeros((num_devices, n_local), np.int64)
    owned_mask = np.zeros((num_devices, n_local), bool)
    face_ids = np.zeros((num_devices, f_local), np.int64)
    face_cells_local = np.zeros((num_devices, f_local, 2), np.int64)
    face_mask = np.zeros((num_devices, f_local), bool)
    face_flip = np.zeros((num_devices, f_local), bool)
    cell_device = np.zeros(n, np.int64)
    cell_slot = np.zeros(n, np.int64)
    g2l = np.full((num_devices, n), -1, np.int64)
    for d in range(num_devices):
        own, halo, fsel = locals_[d], halos[d], faces[d]
        local_cells[d, : len(own)] = own
        local_cells[d, n_owned_pad: n_owned_pad + len(halo)] = halo
        owned_mask[d, : len(own)] = True
        g2l[d, own] = np.arange(len(own))
        g2l[d, halo] = n_owned_pad + np.arange(len(halo))
        cell_device[own] = d
        cell_slot[own] = np.arange(len(own))
        fc_d = face_cells[fsel]
        a_l = g2l[d][fc_d[:, 0]]
        b_l = g2l[d][fc_d[:, 1]]
        flip = a_l > b_l
        a_l, b_l = np.minimum(a_l, b_l), np.maximum(a_l, b_l)
        gh = is_ghost[fc_d[:, 0]] | is_ghost[fc_d[:, 1]]
        owned_both = (part[fc_d[:, 0]] == d) & (part[fc_d[:, 1]] == d)
        order = _canonical_face_order(a_l, b_l, gh, owned_both)
        fsel = fsel[order]
        face_ids[d, : len(fsel)] = fsel
        face_cells_local[d, : len(fsel), 0] = a_l[order]
        face_cells_local[d, : len(fsel), 1] = b_l[order]
        face_mask[d, : len(fsel)] = True
        face_flip[d, : len(fsel)] = flip[order]

    # all_gather routes: each owner sends each of its halo-needed cells
    # once; receivers index the flat gathered buffer
    send_lists = [[] for _ in range(num_devices)]
    send_pos = {}
    for d in range(num_devices):
        for g in halos[d]:
            o = part[g]
            if (o, g) not in send_pos:
                send_pos[(o, g)] = len(send_lists[o])
                send_lists[o].append(g2l[o, g])
    num_send = max(max((len(s) for s in send_lists), default=0), 1)
    send_idx = np.zeros((num_devices, num_send), np.int64)
    for d, s in enumerate(send_lists):
        send_idx[d, : len(s)] = s
    recv_src = np.zeros((num_devices, n_halo), np.int64)
    for d in range(num_devices):
        for i, g in enumerate(halos[d]):
            o = part[g]
            recv_src[d, i] = o * num_send + send_pos[(o, g)]

    # point-to-point rounds: the neighbour digraph edge-coloured so that
    # each rank sends and receives at most one buffer per round, larger
    # edges first
    edges = {}  # (o, d) -> (send slots on o, receive halo slots on d)
    for d in range(num_devices):
        for i, g in enumerate(halos[d]):
            o = part[g]
            s, r = edges.setdefault((o, d), ([], []))
            s.append(g2l[o, g])
            r.append(n_owned_pad + i)
    out_used = [set() for _ in range(num_devices)]
    in_used = [set() for _ in range(num_devices)]
    edge_round = {}
    for (o, d), (s, _r) in sorted(edges.items(),
                                  key=lambda kv: -len(kv[1][0])):
        r = 0
        while r in out_used[o] or r in in_used[d]:
            r += 1
        out_used[o].add(r)
        in_used[d].add(r)
        edge_round[(o, d)] = r
    n_rounds = max(max(edge_round.values(), default=-1) + 1, 1)
    s_edge = max((len(s) for s, _ in edges.values()), default=0) or 1
    p2p_send = np.zeros((num_devices, n_rounds, s_edge), np.int64)
    p2p_recv = np.full((num_devices, n_rounds, s_edge), n_local, np.int64)
    perms = [[] for _ in range(n_rounds)]
    for (o, d), (s, rl) in edges.items():
        r = edge_round[(o, d)]
        p2p_send[o, r, : len(s)] = s
        p2p_recv[d, r, : len(rl)] = rl
        perms[r].append((o, d))

    return PartitionPlan(
        num_devices=num_devices,
        n_local=n_local,
        n_owned=n_owned,
        num_send=num_send,
        local_cells=local_cells.astype(np.int32),
        owned_mask=owned_mask,
        face_ids=face_ids.astype(np.int32),
        face_cells_local=face_cells_local.astype(np.int32),
        face_mask=face_mask,
        face_flip=face_flip,
        send_idx=send_idx.astype(np.int32),
        recv_src=recv_src.astype(np.int32),
        n_owned_pad=n_owned_pad,
        n_halo=n_halo,
        p2p_perms=tuple(tuple(sorted(p)) for p in perms),
        p2p_send=p2p_send.astype(np.int32),
        p2p_recv=p2p_recv.astype(np.int32),
        cell_device=cell_device.astype(np.int32),
        cell_slot=cell_slot.astype(np.int32),
    )
