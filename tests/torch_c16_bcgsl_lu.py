"""ROADMAP C16: BiCGStab(l) with an exact (lu) preconditioner on the
wedge models of chip_smoke.py, through both packages' CLIs on the CPU.

For each case (plan size, plan order, linear solver) the model of
tests/test_torch_mesh_run.py runs 3 steps in the JAX package and in the
port; the script prints one JSON line per case with each package's
tries, written as T (converged) or F (not) followed by the try's linear
iterations, read from the YAML log. bcgs + lu on the same models is the
control. Plan order "rcm" is chip_smoke.wedge_mesh's; "shuffle<k>" puts
the plan triangles of every layer in a numpy RandomState(k) order.

Run from the repository root (about 40 minutes on 4 cores, 4 cases at a
time: the failing BiCGStab(l) solves reach denormal numbers, which are
slow on the CPU):
    JAX_PLATFORMS=cpu python tests/torch_c16_bcgsl_lu.py
or one case:
    JAX_PLATFORMS=cpu python tests/torch_c16_bcgsl_lu.py 6 4 4 rcm bcgsl
"""

import json
import os
import re
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

SIZES = [(6, 4, 4), (8, 6, 4), (10, 6, 3)]
ORDERS = ["rcm", "shuffle1", "shuffle2"]
SOLVERS = ["bcgsl", "bcgs"]


def plan_order(wedges, pos, ncol, order):
    """The wedges and in-layer positions with every layer's plan
    triangles renumbered by `order`."""
    if order == "rcm":
        return wedges, pos
    perm = np.random.RandomState(int(order[len("shuffle"):])).permutation(
        ncol)
    nz = len(wedges) // ncol
    layers = wedges.reshape(nz, ncol, 6)[:, perm].reshape(-1, 6)
    return layers, np.argsort(perm)[pos]


def run_case(nx, ny, nz, order, solver):
    from chip_smoke import wedge_mesh, wedge_model_config, write_gmsh
    from waiwera_tpu import cli as jcli
    from waiwera_tpu_torch import cli as tcli

    verts, wedges, pos = wedge_mesh(nx, ny, nz)
    wedges, pos = plan_order(wedges, pos, 2 * nx * ny, order)
    cfg = wedge_model_config("field.msh", nx, ny, nz, pos, steps=3, solver={
        "linear": {"type": solver, "preconditioner": {"type": "lu"}}})
    cfg["output"]["filename"] = "field.h5"
    out = {"size": [nx, ny, nz], "order": order, "solver": solver}
    for which, run in (("jax", lambda f: jcli.run_json(f, platform="cpu")),
                       ("torch", lambda f: tcli.run_json(f, device="cpu"))):
        with tempfile.TemporaryDirectory() as d:
            write_gmsh(os.path.join(d, "field.msh"), verts,
                       [("wedge", wedges)], version="4.1", binary=True)
            fn = os.path.join(d, "field.json")
            with open(fn, "w") as f:
                json.dump(cfg, f)
            cwd = os.getcwd()
            os.chdir(d)
            try:
                ts = run(fn)
            finally:
                os.chdir(cwd)
            with open(os.path.join(d, "field.yaml")) as f:
                tries = [("T" if "converged: true" in ln else "F")
                         + re.search(r"linear_iterations: (\d+)",
                                     ln).group(1)
                         for ln in f if "nonlinear_solver, end" in ln]
        out[which] = {"taken": ts.taken, "aborted": bool(ts.aborted),
                      "tries": " ".join(tries)}
    print("C16 " + json.dumps(out), flush=True)


def main(argv):
    if argv:
        nx, ny, nz = (int(a) for a in argv[:3])
        run_case(nx, ny, nz, argv[3], argv[4])
        return 0
    cases = [(s, o, v) for s in SIZES for o in ORDERS for v in SOLVERS]
    cases.append((SIZES[0], ORDERS[0], "bcgsl"))  # a second run

    def one(case):
        (nx, ny, nz), order, solver = case
        res = subprocess.run(
            [sys.executable, __file__, str(nx), str(ny), str(nz), order,
             solver], capture_output=True, text=True)
        lines = [ln for ln in res.stdout.splitlines()
                 if ln.startswith("C16 ")]
        return lines[0] if lines else f"C16 failed {case}: {res.stderr[-500:]}"

    with ThreadPoolExecutor(4) as pool:
        for line in pool.map(one, cases):
            print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
