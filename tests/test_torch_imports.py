"""waiwera_tpu_torch imports without JAX and without h5py: with jax, the
JAX package and h5py blocked in sys.modules, the package, every
submodule and chip_smoke.py import, and none of them pulls in jax, the
JAX package or h5py; no import statement of the package or of
chip_smoke.py names one of them (HDF5 files go through
utils/hdf5.py)."""

import os
import subprocess
import sys
import textwrap

import waiwera_tpu_torch

_SCRIPT = textwrap.dedent(
    """
    import importlib, pkgutil, sys
    preloaded = set(sys.modules)
    sys.modules["jax"] = None
    sys.modules["waiwera_tpu"] = None
    sys.modules["h5py"] = None
    import torch
    import waiwera_tpu_torch as pkg
    names = [m.name for m in pkgutil.walk_packages(pkg.__path__,
                                                   pkg.__name__ + ".")]
    for name in names:
        importlib.import_module(name)
    import chip_smoke
    assert torch.get_default_dtype() == torch.float32
    bad = [m for m in set(sys.modules) - preloaded
           if m.startswith("waiwera_tpu.")
           or (m.startswith("jax") and sys.modules[m] is not None)
           or m.startswith("h5py.")]
    assert not bad, bad
    print(" ".join(names))
    """
)


# the modules of the model run (the timestepper, output, log and CLI),
# the other equations of state with their thermodynamics and tables, the
# source network, tracers and the Krylov solvers, and the BSR
# preconditioners, the Jacobian check, the mesh file readers and the
# listing reader, the multi-device run and the device mesh geometry
NEW_MODULES = ("utils.config", "utils.logging", "sim.output",
               "sim.timestepper", "cli", "runner", "mesh.rect",
               "mesh.device", "utils.interpolation", "thermo.ifc67",
               "thermo.salt", "eos.w", "eos.we", "eos.wse", "eos.wsge",
               "sim.network", "sim.tracer", "solver.krylov",
               "solver.precond", "solver.fdcheck", "mesh.gmsh",
               "mesh.exodus", "utils.autough2", "parallel",
               "parallel.graph", "parallel.partition", "parallel.comm",
               "parallel.launch", "parallel.spmd", "parallel.runs",
               "mesh.geometry")


def _imported():
    root = os.path.dirname(os.path.dirname(waiwera_tpu_torch.__file__))
    env = dict(os.environ, PYTHONPATH=root)
    out = subprocess.run(
        [sys.executable, "-c", _SCRIPT], cwd=root, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    return out.stdout.split()


def test_imports_without_jax():
    names = _imported()
    assert len(names) >= 20  # every submodule was imported
    for mod in NEW_MODULES:
        assert f"waiwera_tpu_torch.{mod}" in names, mod


def test_no_module_or_smoke_line_imports_h5py_jax_or_the_jax_package():
    """No import statement, at the top of a module or inside a function,
    of any module of the package or of chip_smoke.py names h5py, jax or
    waiwera_tpu (the subprocess above checks the same at run time)."""
    import ast

    pkg = os.path.dirname(waiwera_tpu_torch.__file__)
    files = [os.path.join(d, f) for d, _, fs in os.walk(pkg) for f in fs
             if f.endswith(".py")]
    files.append(os.path.join(os.path.dirname(pkg), "chip_smoke.py"))
    assert len(files) > 40
    for path in files:
        tree = ast.parse(open(path).read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                roots = [a.name.split(".")[0] for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                roots = [node.module.split(".")[0]]
            else:
                continue
            bad = {"h5py", "jax", "waiwera_tpu"} & set(roots)
            assert not bad, f"{path}:{node.lineno} imports {bad}"
