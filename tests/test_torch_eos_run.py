"""A model file with no eos and no thermodynamics section runs as "we"
on IAPWS-97 in waiwera_tpu_torch as in waiwera_tpu: chip_smoke.py's
default-EOS model at 5 x 4 x 3 (a two-phase top zone over liquid, Corey
relative permeability, van Genuchten capillarity, a deliverability
producer in the two-phase zone, an injector below, the schema's default
f64 solver), 3 adaptive steps through both packages' Timestepper: the
same tries, sizes and statuses (sizes and times to rtol 1e-12), the same
final regions, which differ from the initial ones (transitions ran),
and final scaled primaries within rtol 1e-8 (tests/torch_parity.py
check_run). The same JSON file through both CLIs on the CPU: YAML logs
equal line by line except elapsed_seconds (input defaults included),
HDF5 outputs within rtol 1e-8."""

import json
import os
import re

import h5py
import numpy as np
import pytest

from torch_parity import check_run, eos_model_config, np_, run_pair

# from 3e3 s the run's converged residual norms stay above 1e-9: the
# YAML log prints them to 6 digits, and a norm at round-off level (1e-10
# and below) would print round-off
CFG = eos_model_config("we", 5, 4, 3, steps=3, size=3.0e3)


def test_default_eos_run_matches_jax():
    assert "eos" not in CFG and "thermodynamics" not in CFG
    tj, tt = run_pair(CFG)
    assert tt.sim.eos.name == "we" and tt.sim.thermo.name == "IAPWS-97"
    assert tt.sim.system.npv == 2
    check_run(tj, tt, 3)
    changed = np_(tt.sim.region0) != np_(tt.final_region)
    assert changed.any()


def _log_lines(path):
    text = open(path).read()
    return re.sub(r"elapsed_seconds: [^,}]+", "elapsed_seconds: *",
                  text).splitlines()


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """The model file through both packages' run_json, each in its own
    directory: directory by package."""
    from waiwera_tpu import cli as jcli
    from waiwera_tpu_torch import cli

    out = {}
    cwd = os.getcwd()
    for which, run in (
            ("jax", lambda f: jcli.run_json(f, platform="cpu")),
            ("torch", lambda f: cli.run_json(f, device="cpu"))):
        d = tmp_path_factory.mktemp(which)
        fn = d / "we.json"
        fn.write_text(json.dumps(CFG))
        os.chdir(d)
        try:
            ts = run(str(fn))
        finally:
            os.chdir(cwd)
        assert not ts.aborted and ts.taken == 3
        out[which] = d
    return out


def test_default_eos_log_equals_the_jax_log(cli_runs):
    lj = _log_lines(cli_runs["jax"] / "we.yaml")
    lt = _log_lines(cli_runs["torch"] / "we.yaml")
    assert lt[-1].startswith("- [info, timestepper, end, ")
    assert "- [info, input, default, {path: eos, value: {}}]" in lt
    assert len(lt) == len(lj)
    for a, b in zip(lt, lj):
        assert a == b


def test_default_eos_output_equals_the_jax_output(cli_runs):
    with h5py.File(cli_runs["jax"] / "we.h5") as fj, \
            h5py.File(cli_runs["torch"] / "we.h5") as ft:
        names = []
        fj.visititems(lambda n, o: names.append(n)
                      if isinstance(o, h5py.Dataset) else None)
        found = []
        ft.visititems(lambda n, o: found.append(n)
                      if isinstance(o, h5py.Dataset) else None)
        assert sorted(found) == sorted(names)
        assert "cell_fields/fluid_vapour_saturation" in names
        for n in names:
            a, b = np.asarray(fj[n]), np.asarray(ft[n])
            assert a.shape == b.shape and a.dtype == b.dtype, n
            np.testing.assert_allclose(
                b, a, rtol=1e-8, atol=1e-8 * float(np.abs(a).max()),
                err_msg=n)
