"""Graph routines of the partitioner: reverse Cuthill-McKee ordering
and the greedy graph-growing partitioner (counterpart of rcm and
partition_graph in waiwera_tpu/native).

The algorithms are csrc/graph.cpp, compiled with g++ at first use into
a shared library under waiwera_tpu_torch/_build/ (named by a hash of
the source and the flags) and called through ctypes. A failed build or
load raises: there is no second implementation to fall back to.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess

import numpy as np

from waiwera_tpu_torch.ops.cuda_build import BUILD_DIR, CSRC

GXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")

_lib = None
_i64p = ctypes.POINTER(ctypes.c_int64)


def library_path():
    src = (CSRC / "graph.cpp").read_bytes()
    key = hashlib.sha256(src + " ".join(GXX_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"libgraph-{key[:16]}.so"


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        out = library_path()
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = ["g++", *GXX_FLAGS, "-o", str(tmp), str(CSRC / "graph.cpp")]
            r = subprocess.run(cmd, capture_output=True, text=True)
            if r.returncode != 0:
                raise RuntimeError(f"g++ failed: {' '.join(cmd)}\n{r.stderr}")
            os.replace(tmp, out)
        lib = ctypes.CDLL(str(out))
        lib.ww_rcm.argtypes = [ctypes.c_int64, _i64p, _i64p, _i64p]
        lib.ww_rcm.restype = None
        lib.ww_partition_graph.argtypes = [
            ctypes.c_int64, _i64p, _i64p, ctypes.c_int64, _i64p,
        ]
        lib.ww_partition_graph.restype = None
        _lib = lib
    return _lib


def _i64(a) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.int64)


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(_i64p)


def csr_adjacency(face_cells: np.ndarray, ids: np.ndarray, n: int):
    """(indptr, indices): the CSR adjacency of the cell graph induced on
    the cells `ids` (renumbered 0..len(ids)-1) of an n-cell mesh."""
    g2s = np.full(n, -1, np.int64)
    g2s[ids] = np.arange(len(ids))
    a = g2s[face_cells[:, 0]]
    b = g2s[face_cells[:, 1]]
    keep = (a >= 0) & (b >= 0)
    a, b = a[keep], b[keep]
    rows = np.concatenate([a, b])
    cols = np.concatenate([b, a])
    order = np.argsort(rows, kind="stable")
    rows, cols = rows[order], cols[order]
    indptr = np.zeros(len(ids) + 1, np.int64)
    np.add.at(indptr, rows + 1, 1)
    return np.cumsum(indptr), cols


def rcm(indptr, indices, n: int) -> np.ndarray:
    """Reverse Cuthill-McKee permutation of a CSR graph: perm[i] is the
    old index of new position i."""
    indptr, indices = _i64(indptr), _i64(indices)
    perm = np.empty(n, np.int64)
    _load().ww_rcm(n, _ptr(indptr), _ptr(indices), _ptr(perm))
    return perm


def partition_graph(indptr, indices, n: int, nparts: int) -> np.ndarray:
    """[n] part ids in [0, nparts) of the greedy graph-growing
    partitioner with one refinement sweep."""
    indptr, indices = _i64(indptr), _i64(indices)
    part = np.empty(n, np.int64)
    _load().ww_partition_graph(n, _ptr(indptr), _ptr(indices), nparts,
                               _ptr(part))
    return part
