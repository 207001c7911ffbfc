"""waiwera_tpu_torch imports without JAX: with jax, the JAX package and
h5py blocked in sys.modules, the package and every submodule import, and
none of them pulls in jax or the JAX package; h5py is imported only
where a file is opened (the HDF5 output, a restart, an HDF5 exodus
mesh)."""

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


def test_h5py_is_imported_only_where_a_file_is_opened():
    """No module imports h5py at import time (checked in the subprocess
    above for the whole package); sim/output.py, sim/simulation.py and
    mesh/exodus.py import it inside the functions that open a file."""
    import ast

    pkg = os.path.dirname(waiwera_tpu_torch.__file__)
    for rel in ("sim/output.py", "sim/simulation.py", "mesh/exodus.py"):
        tree = ast.parse(open(os.path.join(pkg, rel)).read())
        top = [n for n in tree.body
               if isinstance(n, (ast.Import, ast.ImportFrom))]
        names = {a.name for n in top if isinstance(n, ast.Import)
                 for a in n.names} | {n.module for n in top
                                      if isinstance(n, ast.ImportFrom)}
        assert "h5py" not in names, rel
        inner = [n for f in ast.walk(tree)
                 if isinstance(f, ast.FunctionDef) for n in ast.walk(f)
                 if isinstance(n, ast.Import)
                 and any(a.name == "h5py" for a in n.names)]
        assert inner, rel
