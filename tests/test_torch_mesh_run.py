"""A wedge-mesh field model read from a gmsh file, through both
packages' run_json on the CPU (the mesh file named relative to the JSON
file): the default-EOS model of chip_smoke.py phase 10 (eos_model_config
"we" on a layered triangulation) with lgmres + asm, bcgsl + asm and
lgmres + lu, the nonlinear monitor on. The same tries, final state within
rtol 2e-5, the same monitor lines and YAML logs equal line by line except
elapsed_seconds, but for the scaled residual and update norms: below the
Newton tolerance they are round-off, held at rtol 1e-3."""

import json
import os
import re

import numpy as np
import pytest

from chip_smoke import wedge_mesh, wedge_model_config, write_gmsh
from torch_parity import np_

SIZE = (6, 4, 4)  # 192 wedges, 384 unknowns: the smallest box here whose
# reverse Cuthill-McKee plan order takes the ELL route
# the solvers of phase 10 (a), (b) and (d). bcgsl with lu is left out:
# with an exact preconditioner BiCGStab(l)'s second BiCG step divides
# round-off by round-off in both packages (ROADMAP C16), so their tries
# follow the noise (tests/torch_c16_bcgsl_lu.py records them;
# tests/test_torch_krylov_more.py holds both packages' bicgstab_l with
# exact and near-exact preconditioners)
SOLVERS = {
    "lgmres_asm": {"linear": {"type": "lgmres",
                              "preconditioner": {"type": "asm"}}},
    "bcgsl_asm": {"linear": {"type": "bcgsl",
                             "preconditioner": {"type": "asm"}}},
    "lgmres_lu": {"linear": {"type": "lgmres",
                             "preconditioner": {"type": "lu"}}},
}


def _log_lines(path):
    text = open(path).read()
    return re.sub(r"elapsed_seconds: [^,}]+", "elapsed_seconds: *",
                  text).splitlines()


_NUMBER = re.compile(r"[-+]?\d+(?:\.\d+)?(?:e[-+]?\d+)?")
# values that are round-off once Newton has converged: the scaled
# residual and update norms (the JAX tests' loose bound for
# max_residual, tests/torch_parity.py RUN_LOOSE)
_ROUND_OFF = ("maxres ", "maxupd ", "max_residual: ")


def _same_lines(got, want):
    """Lines of both packages with the same text around the numbers,
    integers equal, floats within rtol 1e-12, and the round-off values
    of _ROUND_OFF within rtol 1e-3 (atol 1e-9)."""
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert _NUMBER.sub("#", a) == _NUMBER.sub("#", b), (a, b)
        for ma, mb in zip(_NUMBER.finditer(a), _NUMBER.finditer(b)):
            x, y = ma.group(0), mb.group(0)
            if "." not in x and "e" not in x:
                assert x == y, (a, b)
            elif a[:ma.start()].endswith(_ROUND_OFF):
                np.testing.assert_allclose(float(x), float(y), rtol=1e-3,
                                           atol=1e-9, err_msg=f"{a} / {b}")
            else:
                np.testing.assert_allclose(float(x), float(y), rtol=1e-12,
                                           err_msg=f"{a} / {b}")


@pytest.mark.parametrize("solver", list(SOLVERS))
def test_wedge_model_from_gmsh_matches_jax(solver, tmp_path, capfd):
    from waiwera_tpu import cli as jcli
    from waiwera_tpu_torch import cli as tcli

    verts, wedges, pos = wedge_mesh(*SIZE)
    write_gmsh(str(tmp_path / "field.msh"), verts, [("wedge", wedges)],
               version="4.1", binary=True)
    cfg = wedge_model_config("field.msh", *SIZE, pos, steps=3,
                             solver=SOLVERS[solver], monitor=True)
    cfg["output"]["filename"] = "field.h5"
    runs, lines = {}, {}
    cwd = os.getcwd()
    for which, run in (
            ("jax", lambda f: jcli.run_json(f, platform="cpu")),
            ("torch", lambda f: tcli.run_json(f, device="cpu"))):
        d = tmp_path / which
        d.mkdir()
        os.link(tmp_path / "field.msh", d / "field.msh")
        (d / "field.json").write_text(json.dumps(cfg))
        os.chdir(d)
        capfd.readouterr()
        try:
            runs[which] = run(str(d / "field.json"))
        finally:
            os.chdir(cwd)
        lines[which] = [ln for ln in capfd.readouterr().out.splitlines()
                        if ln.startswith("newton it ")]
    tj, tt = runs["jax"], runs["torch"]
    assert tt.sim.mesh.num_cells == tj.sim.mesh.num_cells
    assert tt.sim.system.bands is None  # the RCM plan order: ELL
    assert not tt.aborted and tt.taken == tj.taken == 3
    # every try logs its nonlinear solve: equal logs hold equal tries
    jlog = _log_lines(tmp_path / "jax" / "field.yaml")
    assert len(tt.tried) == sum("nonlinear_solver, end" in ln for ln in jlog)
    np.testing.assert_allclose(np_(tt.final_y), np.asarray(tj.final_y),
                               rtol=2e-5, atol=2e-5)
    assert len(lines["torch"]) >= 6
    _same_lines(lines["torch"], lines["jax"])
    _same_lines(_log_lines(tmp_path / "torch" / "field.yaml"), jlog)
