"""Build and load the port's hand-written CUDA kernels.

Each kernel is one file csrc/<name>.cu with a plain C interface. It is
compiled at first use with nvcc for Hopper (sm_90a) into a shared
library under waiwera_tpu_torch/_build/, named by a hash of the source
and the flags, and loaded with ctypes. Nothing here runs at import: the
CPU tests import every module, and CPU tensors never reach a kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PACKAGE = Path(__file__).resolve().parent.parent
CSRC = _PACKAGE / "csrc"
BUILD_DIR = _PACKAGE / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_loaded: dict = {}


def nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, then PATH, then /usr/local/cuda."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        candidates.append(found)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise FileNotFoundError("nvcc not found (set CUDA_HOME or PATH)")


def library_path(name: str) -> Path:
    """Where the library of csrc/<name>.cu lives once built."""
    src = (CSRC / f"{name}.cu").read_bytes()
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{key[:16]}.so"


def build(name: str) -> Path:
    """Compile csrc/<name>.cu unless its library is already built;
    returns the library path. Raises if nvcc fails."""
    return build_all([name])[0]


def build_all(names, extra_flags=()) -> list:
    """Compile every csrc/<name>.cu not yet built, one nvcc process per
    source, all started together; returns the library paths. Raises if
    any nvcc fails. extra_flags (e.g. "-Xptxas=-v") go to every nvcc."""
    outs = [library_path(name) for name in names]
    procs = []
    for name, out in zip(names, outs):
        if out.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, *extra_flags, "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs.append((subprocess.Popen(cmd), cmd, tmp, out))
    failed = []
    for proc, cmd, tmp, out in procs:
        if proc.wait() == 0:
            os.replace(tmp, out)
        else:
            failed.append(" ".join(cmd))
    if failed:
        raise RuntimeError(f"nvcc failed: {failed}")
    return outs


def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of csrc/<name>.cu, built at first use."""
    lib = _loaded.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build(name)))
        _loaded[name] = lib
    return lib
