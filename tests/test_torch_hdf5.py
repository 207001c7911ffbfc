"""The port's HDF5 layer (waiwera_tpu_torch/utils/hdf5.py, numpy only)
against h5py, the independent check of every file it writes and reads:

- writer -> h5py: every dtype and shape that HDF5Output writes; a
  growing dataset at 1, 2, 64, 65 and 200 records (the chunk B-tree's
  nodes hold 64) and at 4,160 (three levels), read by h5py after every
  flush while the writer goes on;
- h5py -> reader: the JAX package's output of a 3-step column run, equal
  bit for bit to h5py's read of every dataset, partial edge chunks
  included; an exodus-style file with variable-length string
  attributes; compressed and shuffled chunks; what the reader leaves
  out raises NotImplementedError naming it;
- the CLI: `python -m waiwera_tpu_torch.cli` in a process where h5py,
  jax and the JAX package cannot be imported, on the column model and on
  a restart from its own file, against the JAX CLI's files of the same
  two runs (dataset names, shapes and dtypes equal; cell_index and
  geometry bit for bit; fields within rtol 1e-8 and atol 1e-8 of each
  dataset's largest magnitude, as tests/test_torch_cli.py);
- restarts across the packages: each package's Simulation from each
  package's file starts from the same state bit for bit, and the port's
  restart from the JAX file agrees with the JAX restart from the port's
  file at those tolerances."""

import json
import os
import subprocess
import sys
import textwrap

import h5py
import numpy as np
import pytest
import torch

import waiwera_tpu_torch
from test_torch_cli import COLUMN
from waiwera_tpu_torch.utils import hdf5

ROOT = os.path.dirname(os.path.dirname(waiwera_tpu_torch.__file__))
RTOL = 1e-8  # tests/test_torch_cli.py's file tolerance


def _h5py_datasets(f):
    names = []
    f.visititems(lambda n, o: names.append(n)
                 if isinstance(o, h5py.Dataset) else None)
    return sorted(names)


def _port_datasets(group, prefix=""):
    out = []
    for key in group.keys():
        obj = group[key]
        if isinstance(obj, hdf5.Group):
            out += _port_datasets(obj, prefix + key + "/")
        else:
            out.append(prefix + key)
    return sorted(out)


def _same_as_h5py(path):
    """Every dataset of the file read by the port's reader equals h5py's
    read bit for bit, whole and by rows; the names agree."""
    with h5py.File(path, "r") as f, hdf5.File(path) as g:
        names = _h5py_datasets(f)
        assert _port_datasets(g) == names
        for n in names:
            a, b = f[n][...], g[n][...]
            assert a.dtype == b.dtype and a.shape == b.shape, n
            np.testing.assert_array_equal(b, a, err_msg=n)
            if a.ndim == 2 and len(a):
                np.testing.assert_array_equal(g[n][-1], a[-1])
                np.testing.assert_array_equal(g[n][:, 0], a[:, 0])
                np.testing.assert_array_equal(g[n][len(a) // 2], a[len(a) // 2])
        return names


# ------------------------------------------------------------ the writer


def test_constant_datasets_of_every_output_dtype_and_shape(tmp_path):
    """The shapes and dtypes of HDF5Output's constant datasets (cell
    index, geometry, face cells, source and MINC columns) and groups,
    and a group of 300 links, read by h5py and by the port."""
    rng = np.random.default_rng(0)
    data = {"cell_index": np.arange(11, dtype=np.int64)[:, None],
            "cell_geometry_centroid": rng.standard_normal((11, 3)),
            "cell_geometry_volume": rng.uniform(1, 2, (11, 1)),
            "face_cell_1": -rng.integers(0, 9, (7, 1)),
            "face_geometry_distance": rng.standard_normal((7, 2)),
            "source_fields/source_component": np.zeros((3, 1), np.int64),
            "minc/level": np.ones((11, 1), np.int64),
            "scalar": np.float64(2.5), "vector": np.arange(5.0),
            "int32": np.arange(6, dtype=np.int32).reshape(2, 3),
            "float32": rng.standard_normal(4).astype(np.float32),
            "empty": np.zeros((0, 4))}
    path = str(tmp_path / "c.h5")
    with hdf5.File(path, "w") as f:
        f.create_group("source_fields")
        f.create_group("minc")
        f.create_group("cell_fields")
        for name, value in data.items():
            ds = f.create_dataset(name, data=value)
            assert ds.shape == np.shape(value)
        many = f.create_group("many")  # 38 symbol nodes: a 2-level B-tree
        for k in range(300):
            many.create_dataset(f"d{k:03d}", data=np.full((1, 2), k))
    with h5py.File(path, "r") as f:
        assert sorted(f.keys()) == sorted(
            ["cell_fields", "source_fields", "minc", "many"]
            + [n for n in data if "/" not in n])
        assert list(f["many"]) == [f"d{k:03d}" for k in range(300)]
        assert f["many/d299"][0, 1] == 299
        assert len(f["cell_fields"]) == 0
        for name, value in data.items():
            got = f[name][()]
            assert f[name].dtype == np.asarray(value).dtype, name
            np.testing.assert_array_equal(got, value, err_msg=name)
    _same_as_h5py(path)


@pytest.mark.parametrize("records", [1, 2, 64, 65, 200])
def test_growing_dataset_read_by_h5py_after_every_flush(tmp_path, records):
    """HDF5Output's write pattern (resize, ds[nt, 0] = t, ds[nt] = row,
    ds[-1] = row, flush): after every flush h5py and the port read the
    whole file while the writer keeps it open."""
    rng = np.random.default_rng(records)
    path = str(tmp_path / "g.h5")
    rows, fluxes = [], []
    f = hdf5.File(path, "w")
    cf = f.create_group("cell_fields")
    ff = f.create_group("face_fields")
    time_ds = f.create_dataset("time", shape=(0, 1), maxshape=(None, 1),
                               dtype="f8")
    f.create_dataset("cell_index", data=np.arange(6, dtype=np.int64)[:, None])
    for k in range(records):
        time_ds.resize((k + 1, 1))
        time_ds[k, 0] = 10.0 * k
        if k == 0:
            p = cf.create_dataset("fluid_pressure", shape=(0, 6),
                                  maxshape=(None, 6), dtype="f8")
            q = ff.create_dataset("flux_water", shape=(0, 9),
                                  maxshape=(None, 9), dtype="f8")
        rows.append(rng.standard_normal(6))
        fluxes.append(rng.standard_normal(9))
        p.resize((k + 1, 6))
        p[k] = rows[-1]
        q.resize((q.shape[0] + 1, q.shape[1]))
        q[-1] = fluxes[-1]
        f.flush()
        with h5py.File(path, "r") as h:
            np.testing.assert_array_equal(h["time"][:, 0], 10.0 * np.arange(k + 1))
            np.testing.assert_array_equal(h["cell_fields/fluid_pressure"][...],
                                          rows)
            np.testing.assert_array_equal(h["face_fields/flux_water"][...],
                                          fluxes)
            assert h["cell_fields/fluid_pressure"].chunks == (1, 6)
            assert h["cell_fields/fluid_pressure"].maxshape == (None, 6)
        with hdf5.File(path) as g:
            np.testing.assert_array_equal(g["cell_fields/fluid_pressure"][-1],
                                          rows[-1])
    f.close()
    assert _same_as_h5py(path) == ["cell_fields/fluid_pressure", "cell_index",
                                   "face_fields/flux_water", "time"]


def test_three_level_chunk_index_and_row_rewrites(tmp_path):
    """4,160 rows need three levels of 64-entry nodes; a row written
    twice and a single element of a written row read back as last
    written; rows never written read as the fill value (0)."""
    path = str(tmp_path / "deep.h5")
    n = 64 * 65
    with hdf5.File(path, "w") as f:
        ds = f.create_dataset("t", shape=(0, 2), maxshape=(None, 2),
                              dtype="f8")
        ds.resize((n + 1, 2))
        for k in range(n):
            ds[k] = [k, -k]
        ds[5] = [0.5, 0.25]
        ds[7, 1] = 3.0
    want = np.stack([np.arange(n + 1.0), -np.arange(n + 1.0)], axis=1)
    want[5] = [0.5, 0.25]
    want[7, 1] = 3.0
    want[n] = 0.0
    with h5py.File(path, "r") as h:
        np.testing.assert_array_equal(h["t"][...], want)
        np.testing.assert_array_equal(h["t"][n - 3:n - 1], want[n - 3:n - 1])
    _same_as_h5py(path)


def test_random_writes_and_flushes_against_a_numpy_model(tmp_path):
    """Rows appended, skipped and written later (out of order),
    rewritten, and the dataset shrunk and grown again, with a flush and
    a read by h5py after every step: the file always equals a numpy
    model whose unwritten rows are the fill value (0). The chunk index
    grows to five 64-entry leaves under a root, rewritten node by node."""
    rng = np.random.default_rng(5)
    path = str(tmp_path / "m.h5")
    model = np.zeros((0, 3))
    f = hdf5.File(path, "w")
    ds = f.create_dataset("x", shape=(0, 3), maxshape=(None, 3), dtype="f8")
    for step in range(160):
        op = rng.choice(["append", "skip", "fill", "rewrite", "shrink"],
                        p=[0.5, 0.15, 0.15, 0.1, 0.1])
        n = len(model)
        if op == "append" or op == "skip" or n == 0:
            grow = int(rng.integers(1, 12)) + (3 if op == "skip" else 0)
            model = np.concatenate([model, np.zeros((grow, 3))])
            ds.resize((len(model), 3))
            for r in range(n, len(model) - (3 if op == "skip" else 0)):
                model[r] = rng.standard_normal(3)
                ds[r] = model[r]
        elif op in ("fill", "rewrite"):
            r = int(rng.integers(0, n))
            model[r] = rng.standard_normal(3)
            ds[r] = model[r]
        else:
            model = model[:int(rng.integers(3 * n // 4, n + 1))]
            ds.resize((len(model), 3))
        f.flush()
        with h5py.File(path, "r") as h:
            np.testing.assert_array_equal(h["x"][...], model,
                                          err_msg=f"step {step} ({op})")
    f.close()
    assert len(model) > 4 * 64
    _same_as_h5py(path)


def test_writer_refusals(tmp_path):
    with hdf5.File(str(tmp_path / "r.h5"), "w") as f:
        ds = f.create_dataset("x", shape=(0, 3), maxshape=(None, 3),
                              dtype="f8")
        c = f.create_dataset("c", data=np.zeros(3))
        with pytest.raises(ValueError, match="taken"):
            f.create_dataset("x", data=np.zeros(3))
        with pytest.raises(IndexError):
            ds[0] = np.zeros(3)
        with pytest.raises(ValueError, match="resize"):
            ds.resize((2, 4))
        with pytest.raises(TypeError, match="maxshape"):
            c.resize((4,))
        with pytest.raises(TypeError, match="dtype"):
            f.create_dataset("s", data=np.array(["a"]))
        with pytest.raises(ValueError, match="data="):
            f.create_dataset("y", shape=(2, 3), dtype="f8")


# ------------------------------------------------------------ the reader


def test_reader_on_chunked_filtered_and_dense_files(tmp_path):
    """h5py's chunked layouts with edge chunks, deflate + shuffle,
    big-endian and unsigned types, new-style compact and dense groups
    (track_order; 300 links: a fractal heap with an indirect block under
    a v2 B-tree of two levels), a symbol-table group of 300 links (a v1
    B-tree of two levels), dense attributes, fixed-length and
    variable-length string attributes."""
    rng = np.random.default_rng(1)
    path = str(tmp_path / "r.h5")
    with h5py.File(path, "w", libver=("earliest", "v108"),
                   track_order=True) as f:
        f.create_dataset("edge", data=rng.standard_normal((7, 5)),
                         chunks=(3, 2))
        f.create_dataset("gzip", data=rng.standard_normal((50, 3)),
                         chunks=(16, 3), compression="gzip", shuffle=True)
        f.create_dataset("big", data=np.arange(6, dtype=">i4"))
        f.create_dataset("unsigned", data=np.arange(6, dtype=np.uint16))
        for name, order in (("many", True), ("old", False)):
            g = f.create_group(name, track_order=order)
            for k in range(300):
                g.create_dataset(f"d{k}", data=np.full(2, k, np.float32))
        a = f["edge"].attrs
        for k in range(12):
            a[f"attr{k}"] = k
        f["big"].attrs["vlen"] = "TRI3"
        f["big"].attrs["fixed"] = np.bytes_("QUAD4")
    names = _same_as_h5py(path)
    assert len(names) == 604
    with hdf5.File(path) as f:
        assert f["edge"].attrs.get("attr11") == 11
        assert f["big"].attrs.get("vlen") == "TRI3"
        assert f["big"].attrs.get("fixed") == b"QUAD4"
        assert f["big"].attrs.get("missing", b"") == b""
        assert "many/d299" in f and "many/d300" not in f
        assert "old/d299" in f and "old/d300" not in f
        assert f["unsigned"].dtype == np.uint16


def test_reader_raises_on_what_it_leaves_out(tmp_path):
    path = str(tmp_path / "latest.h5")
    with h5py.File(path, "w", libver="latest") as f:
        f.create_dataset("chunked", data=np.arange(10.0), chunks=(4,),
                         maxshape=(None,))
        f.create_dataset("lzf", data=np.arange(10.0), chunks=(4,),
                         compression="lzf")
        f.create_dataset("compound", data=np.zeros(3, [("a", "f8"),
                                                       ("b", "i4")]))
        f["soft"] = h5py.SoftLink("/chunked")
    with hdf5.File(path) as f:
        with pytest.raises(NotImplementedError, match="chunk index"):
            f["chunked"][...]
        with pytest.raises(NotImplementedError, match="compound"):
            f["compound"]
        with pytest.raises(NotImplementedError, match="soft link"):
            f["soft"]
    path = str(tmp_path / "v108.h5")
    with h5py.File(path, "w") as f:
        f.create_dataset("lzf", data=np.arange(10.0), chunks=(4,),
                         compression="lzf")
        f.create_dataset("fletcher", data=np.arange(10.0), chunks=(4,),
                         fletcher32=True)
    with hdf5.File(path) as f:
        with pytest.raises(NotImplementedError, match="filter 32000"):
            f["lzf"][...]
        with pytest.raises(NotImplementedError, match="fletcher32"):
            f["fletcher"][...]
    with pytest.raises(FileNotFoundError):
        hdf5.File(str(tmp_path / "missing.h5"))
    (tmp_path / "text.h5").write_bytes(b"not an HDF5 file" * 64)
    with pytest.raises(ValueError, match="not an HDF5 file"):
        hdf5.File(str(tmp_path / "text.h5"))


def test_lookup3_reference_values():
    """lookup3.c's own test values (driver5)."""
    assert hdf5.lookup3(b"") == 0xDEADBEEF
    assert hdf5.lookup3(b"", 0xDEADBEEF) == 0xBD5B7DDE
    text = b"Four score and seven years ago"
    assert hdf5.lookup3(text) == 0x17770551
    assert hdf5.lookup3(text, 1) == 0xCD628161


# ---------------------------------------------- the CLI, across packages


def _block_and_run(args, cwd):
    """`python -m waiwera_tpu_torch.cli args` in a process where h5py,
    jax and the JAX package cannot be imported."""
    script = textwrap.dedent(f"""
        import runpy, sys
        for name in ("h5py", "jax", "waiwera_tpu"):
            sys.modules[name] = None
        sys.argv = ["waiwera_tpu_torch.cli"] + {list(args)!r}
        runpy.run_module("waiwera_tpu_torch.cli", run_name="__main__")
        """)
    out = subprocess.run([sys.executable, "-c", script], cwd=cwd,
                         env=dict(os.environ, PYTHONPATH=ROOT),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]


def _restart_config(filename, start):
    cfg = dict(COLUMN, initial={"filename": filename})
    cfg["time"] = {"start": start,
                   "step": {"size": 500.0, "maximum": {"number": 2}}}
    return cfg


def _same_files(port_file, jax_file):
    """The port's file against the JAX package's: names, shapes, dtypes;
    cell_index and geometry bit for bit; the rest within RTOL."""
    with h5py.File(port_file, "r") as ft, h5py.File(jax_file, "r") as fj:
        names = _h5py_datasets(fj)
        assert _h5py_datasets(ft) == names
        for n in names:
            a, b = fj[n][...], ft[n][...]
            assert a.shape == b.shape and a.dtype == b.dtype, n
            if n == "cell_index" or "geometry" in n or n.startswith("face_cell"):
                np.testing.assert_array_equal(b, a, err_msg=n)
            else:
                np.testing.assert_allclose(
                    b, a, rtol=RTOL, atol=RTOL * float(np.abs(a).max()),
                    err_msg=n)


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """The 3-step column model through the JAX CLI in this process, and
    through the port's CLI with h5py blocked, followed there by a 2-step
    restart from its own file: {"jax": first file, "torch": (first file,
    restart file), "final": the first run's final time}."""
    from waiwera_tpu import cli as jcli

    model = dict(COLUMN)
    model["time"] = dict(COLUMN["time"], step=dict(
        COLUMN["time"]["step"], maximum={"number": 3}))
    cwd = os.getcwd()
    d = tmp_path_factory.mktemp("jax_cli")
    (d / "model.json").write_text(json.dumps(model))
    os.chdir(d)
    try:
        final = jcli.run_json(str(d / "model.json"), platform="cpu").final_time
    finally:
        os.chdir(cwd)
    out = {"jax": d / "model.h5", "final": final}
    d = tmp_path_factory.mktemp("port_cli")
    (d / "model.json").write_text(json.dumps(model))
    _block_and_run(["model.json", "--device", "cpu"], d)
    with h5py.File(d / "model.h5", "r") as f:
        assert float(f["time"][-1, 0]) == final
    (d / "restart.json").write_text(json.dumps(
        _restart_config("model.h5", final)))
    _block_and_run(["restart.json", "--device", "cpu"], d)
    out["torch"] = (d / "model.h5", d / "restart.h5")
    return out


@pytest.fixture(scope="module")
def cross_restarts(cli_runs, tmp_path_factory):
    """The 2-step restart of the JAX package from the port's file and of
    the port from the JAX package's file, each through its CLI:
    (JAX's file, the port's file)."""
    from waiwera_tpu import cli as jcli
    from waiwera_tpu_torch import cli

    d = tmp_path_factory.mktemp("cross")
    final = cli_runs["final"]
    (d / "from_jax.json").write_text(json.dumps(
        _restart_config(str(cli_runs["jax"]), final)))
    (d / "from_port.json").write_text(json.dumps(
        _restart_config(str(cli_runs["torch"][0]), final)))
    cwd = os.getcwd()
    os.chdir(d)
    try:
        ts = cli.run_json(str(d / "from_jax.json"), device="cpu")
        tj = jcli.run_json(str(d / "from_port.json"), platform="cpu")
    finally:
        os.chdir(cwd)
    assert not ts.aborted and ts.taken == tj.taken == 2
    return d / "from_port.h5", d / "from_jax.h5"


def test_reader_on_the_jax_packages_output(cli_runs, cross_restarts):
    """Every dataset of the JAX CLI's files (h5py's guessed chunks,
    partial edge chunks) reads bit for bit as h5py reads it."""
    with h5py.File(cli_runs["jax"], "r") as f:
        chunks = f["cell_fields/fluid_pressure"].chunks
        assert chunks is not None and chunks[0] > len(f["time"])
    for path in (cli_runs["jax"], cross_restarts[0]):
        assert "cell_fields/fluid_pressure" in _same_as_h5py(str(path))


def test_cli_without_h5py_matches_the_jax_cli(cli_runs, cross_restarts):
    """The port's CLI, h5py and jax blocked: its files read by h5py with
    the JAX CLI files' names, shapes, dtypes and values: the first run
    against the JAX package's, the restart against the JAX package's
    restart from the same file; the restart's first record is the first
    run's last, bit for bit."""
    first, restart = cli_runs["torch"]
    _same_files(first, cli_runs["jax"])
    _same_files(restart, cross_restarts[0])
    with h5py.File(first, "r") as f, h5py.File(restart, "r") as g:
        for n in f["cell_fields"]:
            np.testing.assert_array_equal(g["cell_fields"][n][0],
                                          f["cell_fields"][n][-1], err_msg=n)
    for path in (first, restart):
        _same_as_h5py(str(path))


def test_restarts_across_packages(cli_runs, cross_restarts):
    """Each package's Simulation restarted from each package's file
    starts from the same state, bit for bit; the port's run restarted
    from the JAX file agrees with the JAX run restarted from the port's
    file."""
    from waiwera_tpu.sim.simulation import Simulation as JSim
    from waiwera_tpu_torch.sim.simulation import Simulation as TSim

    for path in (cli_runs["jax"], cli_runs["torch"][0]):
        cfg = _restart_config(str(path), cli_runs["final"])
        st = TSim(json.loads(json.dumps(cfg)), device="cpu")
        sj = JSim(json.loads(json.dumps(cfg)))
        assert torch.equal(st.y0, torch.as_tensor(np.array(sj.y0))), path
        np.testing.assert_array_equal(st.region0.numpy(),
                                      np.asarray(sj.region0))
    from_port, from_jax = cross_restarts
    _same_files(from_jax, from_port)
