"""HDF5 output, the Jacobian dump and restart of waiwera_tpu_torch against
waiwera_tpu: the same short run of the flagship model on a 5 x 4 x 3 box
(backward Euler, f64 Jacobian and BiCGStab) written by both packages.

The files hold the same groups and datasets with the same shapes and
dtypes; values agree within rtol 1e-8 plus an atol per dataset of 1e-8
of its largest magnitude (constant geometry and index datasets: rtol
1e-12 or equal); /face_fields is in the host mesh's face order. The
Jacobian dump agrees in data (rtol 1e-8, atol 1e-8 of the largest entry)
and is equal in indices and indptr. A restart from either package's
file continues to the same state in both packages (rtol 1e-8, atol
1e-8 on the scaled primaries).
"""

import copy

import h5py
import numpy as np
import pytest
import torch

from test_torch_run import F64, LOOSE, _Runner, _time
from torch_parity import assert_same_records, jax_sim, np_, torch_sim

OUTPUT = {
    "frequency": 2,
    "checkpoint": {"time": [1.5e3]},
    "jacobian": True,
    "fields": {
        "fluid": ["liquid_density", "vapour_air_mass_fraction",
                  "liquid_specific_enthalpy"],
        "flux": ["water", "energy", "vapour"],
        "source": ["source_index", "natural_cell_index", "component",
                   "rate", "enthalpy", "water_flow", "heat_flow",
                   "steam_rate"],
    },
}
TIME = _time("beuler", F64, size=1.0e3, number=4)


def _datasets(f):
    out = {}
    f.visititems(lambda name, obj: out.__setitem__(
        name, (obj.shape, obj.dtype)) if isinstance(obj, h5py.Dataset)
        else None)
    return out


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    """Both packages' run with output: (runner, {which: (h5 path, npz
    path, Timestepper)})."""
    from waiwera_tpu.sim.output import HDF5Output as JOut
    from waiwera_tpu_torch.sim.output import HDF5Output as TOut

    runner = _Runner()
    runner.cfg["output"] = OUTPUT  # HDF5Output reads sim.config
    runner.sim_j.config["output"] = OUTPUT
    runner.sim_t.config["output"] = OUTPUT
    tmp = tmp_path_factory.mktemp("out")
    files = {}
    for which, cls, sim in (("jax", JOut, runner.sim_j),
                            ("torch", TOut, runner.sim_t)):
        h5 = str(tmp / f"{which}.h5")
        out = cls(h5, sim)
        ts = runner.timestepper(which, ("beuler", "f64"), TIME, OUTPUT,
                                output=out)
        assert ts.run()
        out.close()
        files[which] = (h5, str(tmp / f"{which}_jacobian.npz"), ts)
    return runner, files


def test_same_layout(written):
    _, files = written
    with h5py.File(files["jax"][0]) as fj, h5py.File(files["torch"][0]) as ft:
        dj, dt = _datasets(fj), _datasets(ft)
    assert sorted(dt) == sorted(dj)
    assert dt == dj
    for name in ("cell_fields/fluid_pressure", "cell_fields/fluid_region",
                 "cell_fields/fluid_liquid_density", "time", "cell_index",
                 "face_fields/flux_water", "face_fields/flux_vapour",
                 "face_cell_1", "face_geometry_distance",
                 "cell_geometry_centroid", "source_fields/source_rate",
                 "source_fields/source_source_index",
                 "source_fields/source_heat_flow",
                 "source_fields/source_steam_rate"):
        assert name in dt, name
    nt = dt["time"][0][0]
    # initial; step 2, which is the checkpoint and the second step; step 4
    assert nt == 3
    assert dt["cell_fields/fluid_pressure"][0] == (nt, 60)
    assert dt["face_fields/flux_water"][0] == (nt, 153)


def test_same_values(written):
    _, files = written
    with h5py.File(files["jax"][0]) as fj, h5py.File(files["torch"][0]) as ft:
        for name, (_, dtype) in _datasets(fj).items():
            a, b = np.asarray(fj[name]), np.asarray(ft[name])
            if dtype.kind == "i":
                np.testing.assert_array_equal(b, a, err_msg=name)
            elif "geometry" in name:
                np.testing.assert_allclose(b, a, rtol=1e-12, atol=1e-9,
                                           err_msg=name)
            else:
                scale = float(np.max(np.abs(a))) if a.size else 0.0
                np.testing.assert_allclose(b, a, rtol=1e-8,
                                           atol=1e-8 * scale, err_msg=name)
        times = np.asarray(ft["time"])[:, 0]
    assert np.all(np.diff(times) > 0) and 1.5e3 in times


def test_fluxes_are_in_host_face_order(written):
    """The canonical order sorts and flips faces; the file is in the host
    mesh's order and orientation: face_cell_1/2 are the host mesh's face
    cells and flux_water agrees with the JAX package's file face by
    face."""
    runner, files = written
    mesh, dev = runner.sim_t.mesh, runner.sim_t.mesh_dev
    assert not np.array_equal(dev.face_perm, np.arange(len(dev.face_perm)))
    with h5py.File(files["jax"][0]) as fj, h5py.File(files["torch"][0]) as ft:
        c1 = np.asarray(ft["face_cell_1"])[:, 0]
        c2 = np.asarray(ft["face_cell_2"])[:, 0]
        fw_t = np.asarray(ft["face_fields/flux_water"])
        fw_j = np.asarray(fj["face_fields/flux_water"])
    ghost = mesh.is_ghost[mesh.face_cells[:, 1]]
    np.testing.assert_array_equal(c1, mesh.face_cells[:, 0])
    np.testing.assert_array_equal(c2[~ghost], mesh.face_cells[~ghost, 1])
    assert np.all(c2[ghost] == -1)
    assert np.abs(fw_t[-1]).max() > 0
    np.testing.assert_allclose(fw_t, fw_j, rtol=1e-8,
                               atol=1e-8 * np.abs(fw_j).max())
    # the last record is the final state's fluxes, mapped from canonical
    # order by the permutation and sign
    ts = files["torch"][2]
    canon = np_(runner.sim_t.initial_fluxes(ts.final_y, ts.final_region))
    host = np.empty_like(canon)
    host[dev.face_perm] = canon * dev.face_sign[:, None]
    np.testing.assert_allclose(fw_t[-1], host[:, 0], rtol=1e-12,
                               atol=1e-12 * np.abs(host[:, 0]).max())


def test_jacobian_dump_matches(written):
    _, files = written
    dj, dt = np.load(files["jax"][1]), np.load(files["torch"][1])
    assert sorted(dt.files) == sorted(dj.files)
    np.testing.assert_array_equal(dt["indices"], dj["indices"])
    np.testing.assert_array_equal(dt["indptr"], dj["indptr"])
    assert int(dt["num_rows"]) == int(dj["num_rows"]) == 80
    assert int(dt["block_size"]) == int(dj["block_size"]) == 3
    assert float(dt["time"]) == float(dj["time"])
    assert dt["data"].shape == dj["data"].shape
    np.testing.assert_allclose(dt["data"], dj["data"], rtol=1e-8,
                               atol=1e-8 * np.abs(dj["data"]).max())


@pytest.mark.parametrize("source", ["jax", "torch"],
                         ids=["jax_file", "torch_file"])
def test_restart_continues_in_both_packages(written, source):
    """A restart file of either package, read through
    initial.filename: both packages start from the same state (natural
    cell order through cell_index, boundary ghost rows set after it) and
    continue to the same state."""
    from waiwera_tpu.sim.simulation import Simulation as JSim
    from waiwera_tpu_torch.sim.simulation import Simulation as TSim

    runner, files = written
    h5, _, ts_src = files[source]
    cfg = copy.deepcopy(runner.cfg)
    cfg.pop("output")
    cfg["initial"] = {"filename": h5}
    rj = JSim(copy.deepcopy(cfg))
    rt = TSim(copy.deepcopy(cfg), device="cpu")
    # the file's last record is the run's final state
    np.testing.assert_allclose(np_(rt.y0), np_(ts_src.final_y), rtol=1e-12,
                               atol=1e-14)
    np.testing.assert_array_equal(np_(rt.region0), np_(ts_src.final_region))
    np.testing.assert_allclose(np_(rt.y0), np.asarray(rj.y0), rtol=1e-14,
                               atol=1e-16)
    time_cfg = _time("beuler", F64, size=5.0e2, number=3)
    time_cfg["start"] = float(ts_src.final_time)
    runner.sim_j.y0, runner.sim_j.region0 = rj.y0, rj.region0
    runner.sim_t.y0, runner.sim_t.region0 = rt.y0, rt.region0
    out = []
    for which in ("jax", "torch"):
        ts = runner.timestepper(which, ("beuler", "f64"), time_cfg, {})
        assert ts.run()
        out.append(ts)
    runner.reset()
    cj, ct = out
    assert_same_records(ct.log, cj.log, loose=LOOSE)
    assert ct.taken == cj.taken == 3
    np.testing.assert_allclose(np_(ct.final_y), np.asarray(cj.final_y),
                               rtol=1e-8, atol=1e-8)


def test_restart_reads_an_earlier_record_by_cell_index(written, tmp_path):
    """initial.index picks the record; a file whose cells are stored in
    another order is read back into natural order."""
    from waiwera_tpu_torch.sim.simulation import Simulation

    runner, files = written
    rng = np.random.default_rng(3)
    order = rng.permutation(60)
    shuffled = str(tmp_path / "shuffled.h5")
    with h5py.File(files["torch"][0]) as src, h5py.File(shuffled, "w") as dst:
        dst.create_dataset("cell_index", data=order[:, None])
        g = dst.create_group("cell_fields")
        for name, ds in src["cell_fields"].items():
            g.create_dataset(name, data=np.asarray(ds)[:, order])
    cfg = copy.deepcopy(runner.cfg)
    cfg.pop("output")
    a = Simulation(dict(cfg, initial={"filename": files["torch"][0],
                                      "index": 1}), device="cpu")
    b = Simulation(dict(cfg, initial={"filename": shuffled, "index": 1}),
                   device="cpu")
    np.testing.assert_array_equal(np_(a.y0), np_(b.y0))
    np.testing.assert_array_equal(np_(a.region0), np_(b.region0))
    last = Simulation(dict(cfg, initial={"filename": files["torch"][0]}),
                      device="cpu")
    assert not np.array_equal(np_(a.y0), np_(last.y0))
    # boundary ghost rows hold the boundary values, not the file's
    ghost = a.mesh.is_ghost
    np.testing.assert_array_equal(np_(a.y0)[ghost],
                                  np_(runner.sim_t.y0)[ghost])


def test_minc_group_matches(tmp_path):
    """/minc (level and parent of every cell) for the flagship's MINC
    lower half, written at construction."""
    from waiwera_tpu.sim.output import HDF5Output as JOut
    from waiwera_tpu_torch.sim.output import HDF5Output as TOut

    paths = []
    for which, cls, sim in (("jax", JOut, jax_sim(minc=True)),
                            ("torch", TOut, torch_sim(minc=True))):
        paths.append(str(tmp_path / f"{which}.h5"))
        cls(paths[-1], sim).close()
    with h5py.File(paths[0]) as fj, h5py.File(paths[1]) as ft:
        dj, dt = _datasets(fj), _datasets(ft)
        assert dt == dj and "minc/level" in dt and "minc/parent" in dt
        for name in ("minc/level", "minc/parent", "cell_index"):
            np.testing.assert_array_equal(np.asarray(ft[name]),
                                          np.asarray(fj[name]), err_msg=name)
        assert np.asarray(ft["minc/level"]).max() == 2
        np.testing.assert_allclose(np.asarray(ft["cell_geometry_volume"]),
                                   np.asarray(fj["cell_geometry_volume"]),
                                   rtol=1e-12)


def test_tracer_output_raises(written, tmp_path):
    """Tracer fields are written as cell_fields/tracer_<name>, as the JAX
    package writes them (the refusal of the slices before is gone; the
    name is kept)."""
    from waiwera_tpu.sim.output import HDF5Output as JOut
    from waiwera_tpu.sim.tracer import TracerSet as JSet
    from waiwera_tpu_torch.sim.output import HDF5Output as TOut
    from waiwera_tpu_torch.sim.tracer import TracerSet as TSet

    runner, files = written
    x = np.random.default_rng(0).uniform(
        0.0, 1e-3, (runner.sim_t.mesh.num_cells, 2))
    cfg = [{"name": "a"}, {"name": "b"}]
    paths = {}
    for which, cls, sim, tset, tracer in (
            ("jax", JOut, runner.sim_j, JSet, x),
            ("torch", TOut, runner.sim_t, TSet, torch.as_tensor(x))):
        sim.tracers = tset(cfg, sim.eos)
        try:
            paths[which] = str(tmp_path / f"{which}_tracer.h5")
            out = cls(paths[which], sim)
            out.write(0, 0.0, files[which][2].final_fluid, tracer=tracer)
            out.close()
        finally:
            sim.tracers = None
    n = runner.sim_t.mesh.num_interior_cells
    with h5py.File(paths["jax"]) as fj, h5py.File(paths["torch"]) as ft:
        assert _datasets(ft) == _datasets(fj)
        for k, nm in enumerate("ab"):
            got = np.asarray(ft[f"cell_fields/tracer_{nm}"])
            np.testing.assert_array_equal(
                got, np.asarray(fj[f"cell_fields/tracer_{nm}"]))
            np.testing.assert_array_equal(got, x[None, :n, k])
