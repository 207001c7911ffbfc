"""A 3-step production-field model (chip_smoke.network_model_config at
5 x 4 x 3: deliverability producers in groups with separators and
limiters under a progressive field group, two reinjectors, recharge, a
make-up injector with a rate table, two tracers, permeability and
porosity tables) through both packages' run_json on the CPU: the same
tries, the final state within rtol 2e-5, the HDF5 files (cell, tracer,
source, group and reinjector datasets) within rtol 1e-8, and the YAML
logs equal line by line except elapsed_seconds. A restart from a file
with tracer fields continues from its tracers."""

import json
import os
import re

import h5py
import numpy as np
import pytest

from torch_parity import network_model_config, np_


def _log_lines(path):
    text = open(path).read()
    return re.sub(r"elapsed_seconds: [^,}]+", "elapsed_seconds: *",
                  text).splitlines()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The model through both packages' run_json: (dir, Timestepper) by
    package."""
    from waiwera_tpu import cli as jcli
    from waiwera_tpu_torch import cli

    config = network_model_config(5, 4, 3, steps=3)
    config["output"]["initial"] = True
    out = {}
    cwd = os.getcwd()
    for which, run in (
            ("jax", lambda f: jcli.run_json(f, platform="cpu")),
            ("torch", lambda f: cli.run_json(f, device="cpu"))):
        d = tmp_path_factory.mktemp(which)
        fn = d / "field.json"
        fn.write_text(json.dumps(config))
        os.chdir(d)
        try:
            out[which] = (d, run(str(fn)))
        finally:
            os.chdir(cwd)
    return out


def test_same_tries_and_state(runs):
    tj, tt = runs["jax"][1], runs["torch"][1]
    assert not tt.aborted and not tj.aborted
    assert tt.taken == tj.taken == 3
    np.testing.assert_allclose(tt.final_time, tj.final_time, rtol=1e-12)
    np.testing.assert_array_equal(np_(tt.final_region),
                                  np.asarray(tj.final_region))
    np.testing.assert_allclose(np_(tt.final_y), np.asarray(tj.final_y),
                               rtol=2e-5, atol=2e-5)
    st = tt.stats
    assert len(st["tracer_converged"]) == st["tries"] and all(
        st["tracer_converged"])
    assert tt.sim.rock_controls and tt.sim.sources.groups


def test_output_equals_the_jax_output(runs):
    with h5py.File(runs["jax"][0] / "field.h5") as fj, \
            h5py.File(runs["torch"][0] / "field.h5") as ft:
        names, found = [], []
        fj.visititems(lambda n, o: names.append(n)
                      if isinstance(o, h5py.Dataset) else None)
        ft.visititems(lambda n, o: found.append(n)
                      if isinstance(o, h5py.Dataset) else None)
        assert sorted(found) == sorted(names)
        for n in ("cell_fields/tracer_inj", "cell_fields/tracer_arr",
                  "source_fields/source_tracer_flow",
                  "source_fields/network_group_steam_rate",
                  "source_fields/network_reinject_output_water_rate"):
            assert n in names, n
        for n in names:
            a, b = np.asarray(fj[n]), np.asarray(ft[n])
            assert a.shape == b.shape and a.dtype == b.dtype, n
            np.testing.assert_allclose(
                b, a, rtol=1e-8, atol=1e-8 * float(np.abs(a).max()),
                err_msg=n)
        x = np.asarray(ft["cell_fields/tracer_inj"])
        assert x.shape[0] == 4 and x[-1].max() > 0.0


def test_log_equals_the_jax_log(runs):
    lj = _log_lines(runs["jax"][0] / "field.yaml")
    lt = _log_lines(runs["torch"][0] / "field.yaml")
    assert len(lt) == len(lj)
    for a, b in zip(lt, lj):
        assert a == b
    assert any("network.group, {count: 7}" in ln for ln in lt)


def test_restart_with_tracer_fields(runs, tmp_path):
    """A model restarting from the JAX package's output file starts from
    its last tracer fields, in natural cell order."""
    from waiwera_tpu_torch.sim.simulation import Simulation

    config = network_model_config(5, 4, 3)
    config["initial"] = {"filename": str(runs["jax"][0] / "field.h5")}
    sim = Simulation(config, device="cpu")
    with h5py.File(runs["jax"][0] / "field.h5") as f:
        order = np.asarray(f["cell_index"][:, 0])
        inv = np.argsort(order)
        for k, nm in enumerate(sim.tracers.names):
            want = np.asarray(f[f"cell_fields/tracer_{nm}"][-1])[inv]
            np.testing.assert_array_equal(np_(sim.tracer0)[:60, k], want)
