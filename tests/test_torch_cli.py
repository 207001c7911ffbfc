"""The command line of waiwera_tpu_torch: run_json, main, the runner and
`python -m waiwera_tpu_torch.cli` on JSON files in a temporary directory,
on the CPU (--device cpu), against the JAX package's CLI on the same
file: the YAML logs are equal line by line except elapsed_seconds (the
input defaults included: both packages read the config in the same
order), and the HDF5 files agree within rtol 1e-8 and atol 1e-8 of each
dataset's largest magnitude."""

import json
import os
import re
import subprocess
import sys

import h5py
import numpy as np
import pytest
import torch

import waiwera_tpu_torch
from waiwera_tpu_torch import cli, runner

COLUMN = {
    "title": "column",
    "mesh": {"type": "column", "dz": [10.0] * 6, "area": 4.0},
    "gravity": 9.8,
    "eos": {"name": "wae"},
    "initial": {"primary": [2.0e5, 30.0, 5.0e4], "region": 1},
    "rock": {"types": [{"name": "r", "permeability": 1e-13,
                        "porosity": 0.2}]},
    "boundaries": [{"primary": [1.0e5, 20.0, 5.0e4], "region": 1,
                    "faces": {"cells": [0], "normal": [0, 1]}}],
    "source": [{"cell": 5, "rate": 0.02, "enthalpy": 4.0e5}],
    "time": {"stop": 6.0e3,
             "step": {"size": 1.0e3, "adapt": {"on": True},
                      "maximum": {"number": 5}}},
    "output": {"frequency": 2, "fields": {"flux": ["water"]}},
}


def _write(path, config):
    path.write_text(json.dumps(config))
    return str(path)


def _log_lines(path):
    text = open(path).read()
    return re.sub(r"elapsed_seconds: [^,}]+", "elapsed_seconds: *",
                  text).splitlines()


@pytest.fixture(scope="module")
def column_runs(tmp_path_factory):
    """The column model through both packages' run_json, each in its own
    directory: (dir, Timestepper) by package."""
    from waiwera_tpu import cli as jcli

    out = {}
    cwd = os.getcwd()
    for which, run in (
            ("jax", lambda f: jcli.run_json(f, platform="cpu")),
            ("torch", lambda f: cli.run_json(f, device="cpu"))):
        d = tmp_path_factory.mktemp(which)
        fn = _write(d / "model.json", COLUMN)
        os.chdir(d)
        try:
            out[which] = (d, run(fn))
        finally:
            os.chdir(cwd)
    return out


def test_run_json_writes_output_and_log(column_runs):
    d, ts = column_runs["torch"]
    assert not ts.aborted and ts.taken > 0
    assert ts.sim.device.type == "cpu" and ts.sim.mesh.dim == 2
    assert ts.sim.title == "column"
    # names default to the JSON file's, in the working directory
    assert (d / "model.h5").exists() and (d / "model.yaml").exists()
    with h5py.File(d / "model.h5") as f:
        p = np.asarray(f["cell_fields/fluid_pressure"])
        t = np.asarray(f["time"])[:, 0]
        assert p.shape == (len(t), 6) and np.all(np.isfinite(p))
        assert t[0] == 0.0 and t[-1] == ts.final_time
        assert "face_fields/flux_water" in f
    lines = _log_lines(d / "model.yaml")
    assert lines[-1].startswith("- [info, timestepper, end, {time: ")
    assert any(ln.startswith("- [info, timestep, end, ") for ln in lines)


def test_defaults_are_logged(column_runs):
    """TrackedConfig: every read that fell back to its default is in the
    log, once, before the run starts."""
    d, _ = column_runs["torch"]
    lines = _log_lines(d / "model.yaml")
    defaults = [ln for ln in lines if ln.startswith("- [info, input, default")]
    start = lines.index("- [info, timestepper, start, {time: 0}]")
    assert defaults and lines.index(defaults[-1]) < start
    assert len(set(defaults)) == len(defaults)
    for path, value in (("thermodynamics", "iapws"),
                        ("time.step.method", "beuler"),
                        ("time.step.maximum.tries", "10"),
                        ("time.step.solver", "{}"),
                        ("output.initial", "true"),
                        ("source[0].component", "0")):
        assert (f"- [info, input, default, {{path: {path}, value: {value}}}]"
                in defaults), path
    assert not any("path: gravity" in ln or "path: title" in ln
                   for ln in defaults)


def test_log_equals_the_jax_log(column_runs):
    lj = _log_lines(column_runs["jax"][0] / "model.yaml")
    lt = _log_lines(column_runs["torch"][0] / "model.yaml")
    assert len(lt) == len(lj)
    for a, b in zip(lt, lj):
        assert a == b


def test_output_equals_the_jax_output(column_runs):
    with h5py.File(column_runs["jax"][0] / "model.h5") as fj, \
            h5py.File(column_runs["torch"][0] / "model.h5") as ft:
        names = []
        fj.visititems(lambda n, o: names.append(n)
                      if isinstance(o, h5py.Dataset) else None)
        found = []
        ft.visititems(lambda n, o: found.append(n)
                      if isinstance(o, h5py.Dataset) else None)
        assert sorted(found) == sorted(names)
        for n in names:
            a, b = np.asarray(fj[n]), np.asarray(ft[n])
            assert a.shape == b.shape and a.dtype == b.dtype, n
            np.testing.assert_allclose(
                b, a, rtol=1e-8, atol=1e-8 * float(np.abs(a).max()),
                err_msg=n)


def test_main_set_overrides_and_relative_restart(column_runs, tmp_path,
                                                 monkeypatch):
    """--set layers values over the JSON; initial.filename resolves
    against the JSON file, output names against the working directory."""
    d, first = column_runs["torch"]
    model = dict(COLUMN, initial={"filename": "first/model.h5"})
    model["time"] = {"start": first.final_time,
                     "step": {"size": 500.0, "maximum": {"number": 2}}}
    os.symlink(d, tmp_path / "first")
    fn = _write(tmp_path / "again.json", model)
    work = tmp_path / "work"
    work.mkdir()
    monkeypatch.chdir(work)
    rc = cli.main([fn, "--device", "cpu",
                   "--set", "time.step.maximum.number=3",
                   "--set", "output.filename=renamed.h5",
                   "--set", "title=again"])
    assert rc == 0
    assert (work / "renamed.h5").exists() and (work / "renamed.yaml").exists()
    with h5py.File(work / "renamed.h5") as f, h5py.File(d / "model.h5") as g:
        t = np.asarray(f["time"])[:, 0]
        # the initial record, step 2 (output.frequency) and the last
        np.testing.assert_allclose(
            t, first.final_time + np.array([0.0, 1000.0, 1500.0]))
        # the restart's initial record is the first run's last
        np.testing.assert_allclose(
            np.asarray(f["cell_fields/fluid_pressure"])[0],
            np.asarray(g["cell_fields/fluid_pressure"])[-1], rtol=1e-12)


def test_apply_overrides():
    cfg = {"a": {"b": 1}, "c": 2}
    cli._apply_overrides(cfg, ["a.b=2.5", "a.d.e=[1, 2]", "c=text",
                               "f=true"])
    assert cfg == {"a": {"b": 2.5, "d": {"e": [1, 2]}}, "c": "text",
                   "f": True}
    with pytest.raises(ValueError, match="path=value"):
        cli._apply_overrides(cfg, ["novalue"])


def test_aborted_run_exits_with_1(tmp_path, monkeypatch):
    model = dict(COLUMN)
    # two Newton iterations from far away cannot converge: every try
    # fails and the run aborts after two tries
    model["initial"] = {"primary": [5.0e6, 250.0, 5.0e4], "region": 1}
    model["time"] = {"step": {
        "size": 1.0e9, "maximum": {"number": 3, "tries": 2},
        "solver": {"nonlinear": {"maximum": {"iterations": 1}}}}}
    fn = _write(tmp_path / "abort.json", model)
    monkeypatch.chdir(tmp_path)
    assert runner.run_waiwera(fn, device="cpu") == 1
    lines = _log_lines(tmp_path / "abort.yaml")
    assert "- [warn, timestep, aborted, {num_tries: 2}]" in lines
    assert lines[-1].startswith("- [info, timestepper, end, {time: 0, "
                                "steps: 0")


def test_more_than_one_device_raises(tmp_path, monkeypatch):
    """A run over more ranks than CUDA devices raises, as the JAX
    package's DistributedSystem does (here: one card for two ranks)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    fn = _write(tmp_path / "m.json", COLUMN)
    with pytest.raises(ValueError, match="needs 2 CUDA devices"):
        cli.main([fn, "--devices", "2"])
    with pytest.raises(ValueError, match="needs 2 CUDA devices"):
        runner.run_waiwera(fn, num_processes=2)
    with pytest.raises(ValueError, match="needs 4 CUDA devices"):
        cli.run_json(_write(tmp_path / "p.json",
                            dict(COLUMN, parallel={"devices": 4})))


@pytest.fixture(scope="module")
def column_rank_runs(tmp_path_factory):
    """The column model over 2 ranks: the JAX CLI's num_devices=2 and the
    port's --device cpu --devices 2, each in its own directory. This
    process already has 8 CPU devices (tests/conftest.py), so the JAX
    CLI's request for 2 (an error once the backend is up) is dropped."""
    import jax

    from waiwera_tpu import cli as jcli

    update = jax.config.update
    out = {}
    cwd = os.getcwd()
    for which, run in (
            ("jax", lambda f: jcli.run_json(f, platform="cpu",
                                            num_devices=2)),
            ("torch", lambda f: cli.main([f, "--device", "cpu",
                                          "--devices", "2"]))):
        d = tmp_path_factory.mktemp(which + "2")
        fn = _write(d / "model.json", COLUMN)
        os.chdir(d)
        try:
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(jax.config, "update", lambda k, v: None
                           if k == "jax_num_cpu_devices" else update(k, v))
                out[which] = (d, run(fn))
        finally:
            os.chdir(cwd)
    return out


def test_two_cpu_ranks_log_equals_the_jax_log(column_rank_runs):
    d, rc = column_rank_runs["torch"]
    assert rc == 0
    lt = _log_lines(d / "model.yaml")
    lj = _log_lines(column_rank_runs["jax"][0] / "model.yaml")
    assert lt[-1].startswith("- [info, timestepper, end, {time: ")
    assert len(lt) == len(lj)
    for a, b in zip(lt, lj):
        assert a == b


def test_two_cpu_ranks_output_equals_one_rank(column_runs, column_rank_runs):
    with h5py.File(column_runs["torch"][0] / "model.h5") as f1, \
            h5py.File(column_rank_runs["torch"][0] / "model.h5") as f2:
        names = []
        f1.visititems(lambda n, o: names.append(n)
                      if isinstance(o, h5py.Dataset) else None)
        found = []
        f2.visititems(lambda n, o: found.append(n)
                      if isinstance(o, h5py.Dataset) else None)
        assert sorted(found) == sorted(names)
        for n in names:
            a, b = np.asarray(f1[n]), np.asarray(f2[n])
            assert a.shape == b.shape and a.dtype == b.dtype, n
            np.testing.assert_allclose(
                b, a, rtol=1e-8, atol=1e-8 * float(np.abs(a).max()),
                err_msg=n)


def test_no_device_named_raises_without_cuda(tmp_path, monkeypatch):
    """The entry points take the CUDA device unless told otherwise;
    where there is none they raise and write no output."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    fn = _write(tmp_path / "m.json", COLUMN)
    monkeypatch.chdir(tmp_path)
    for call in (lambda: cli.run_json(fn), lambda: cli.main([fn]),
                 lambda: runner.run_waiwera(fn)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert not (tmp_path / "m.h5").exists()


def test_runner_version_and_usage(capsys):
    assert runner.get_pkg_version() == waiwera_tpu_torch.__version__
    assert runner.main(["--version"]) == 0
    assert capsys.readouterr().out.strip() == runner.get_pkg_version()
    assert runner.main([]) == 1
    assert "FILENAME" in capsys.readouterr().out


def test_module_entry_point_and_profile(tmp_path):
    """`python -m waiwera_tpu_torch.cli model.json --device cpu` writes
    model.h5 and model.yaml; --profile DIR writes a Chrome trace; the
    echoed log goes to stdout."""
    model = dict(COLUMN)
    model["time"] = {"step": {"size": 1.0e3, "maximum": {"number": 1}}}
    fn = _write(tmp_path / "model.json", model)
    root = os.path.dirname(os.path.dirname(waiwera_tpu_torch.__file__))
    out = subprocess.run(
        [sys.executable, "-m", "waiwera_tpu_torch.cli", fn, "--device",
         "cpu", "--echo-log", "--profile", "prof"],
        cwd=tmp_path, env=dict(os.environ, PYTHONPATH=root),
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    assert (tmp_path / "model.h5").exists()
    assert (tmp_path / "model.yaml").exists()
    assert "[info, timestepper, end," in out.stdout
    trace = json.load(open(tmp_path / "prof" / "trace.json"))
    assert trace["traceEvents"]


@pytest.mark.parametrize("hooked", [False, True], ids=["run_json", "memory"])
def test_smoke_script_model_run_on_the_cpu(tmp_path, hooked):
    """The model-run phase of chip_smoke.py, rehearsed on the CPU at
    5 x 4 x 3 through both of its entry points (cli.run_json with HDF5
    output through utils/hdf5.py; Simulation + Timestepper with its
    in-memory output, the path of a run given a sim_hook): its own
    checks pass, the ladder refuses tries, and both paths take the same
    steps."""
    import chip_smoke

    hooked_sims = []
    ts, times, _, entry = chip_smoke.model_run(
        str(tmp_path), (5, 4, 3), steps=3, device="cpu",
        log=lambda msg: None, checkpoint=chip_smoke.CHECKPOINT_SMALL,
        sim_hook=hooked_sims.append if hooked else None)
    assert ("run_json" in entry) != hooked
    assert len(hooked_sims) == hooked
    assert ts.taken == 3 and chip_smoke.CHECKPOINT_SMALL in times
    assert [d for d, ok in ts.tried if ok] == [1.0e4, 4.0e3, 320.0]
    assert sum(not ok for _, ok in ts.tried) == 4
    assert ts.stats["matvecs"] > 0 and len(ts.stats["step_seconds"]) == 3
    assert (tmp_path / "model_beuler_5x4x3.yaml").exists()
    assert (tmp_path / "model_beuler_5x4x3.h5").exists() != hooked


def test_smoke_script_restart_on_the_cpu(tmp_path):
    """Phase 7's file checks and restart in chip_smoke.py, rehearsed on
    the CPU at 5 x 4 x 3: the run's file reads back with the port's
    reader, its last pressure equal to the final state's bit for bit;
    the restart through cli.run_json reads the final primaries bit for
    bit, starts from the final state and writes a file that checks
    out; h5py reads both files to the port reader's values."""
    import chip_smoke
    from waiwera_tpu_torch.utils import hdf5

    d = str(tmp_path)
    ts, times, _, _ = chip_smoke.model_run(
        d, (5, 4, 3), steps=3, device="cpu", log=lambda msg: None,
        checkpoint=chip_smoke.CHECKPOINT_SMALL)
    path = str(tmp_path / "model_beuler_5x4x3.h5")
    nrec, mb, record_mb = chip_smoke.check_output_file(path, ts, times)
    assert nrec == len(times) == 4 and mb > record_mb > 0
    ts2, read_s, (nrec2, _, _) = chip_smoke.restart_run(
        d, ts, path, size=(5, 4, 3), steps=2, device="cpu",
        log=lambda msg: None)
    assert ts2.taken == 2 and read_s > 0 and nrec2 >= 2
    assert ts2.tried[0][0] == ts.accepted[-1][0]
    for fn in (path, str(tmp_path / "model_restart.h5")):
        with h5py.File(fn) as f, hdf5.File(fn) as g:
            names = chip_smoke.dataset_names(g)
            found = []
            f.visititems(lambda n, o: found.append(n)
                         if isinstance(o, h5py.Dataset) else None)
            assert sorted(found) == names
            for n in names:
                a, b = f[n][...], g[n][...]
                assert a.dtype == b.dtype and np.array_equal(a, b), n
