"""The Timestepper of waiwera_tpu_torch.parallel over gloo ranks on the
CPU against waiwera_tpu's DistributedSimulation at the same rank count
and against the port on one device: tests/test_parallel.py's model
with a decaying tracer, sources and HDF5 output over D = 2 ranks, cut
to its first 8 steps (both references run the same cut). The tries are
equal to the one-device run's; times equal, cell and source fields in
natural cell order to rtol 2e-5 (test_parallel.py:387-403).
"""

import copy

import numpy as np

N_RUN = 32
RUN_CONFIG = {
    "eos": {"name": "we"},
    "initial": {"primary": [8.0e6, 200.0], "region": 1, "tracer": 0.0},
    "tracer": {"name": "t1", "phase": "liquid", "decay": 1e-8},
    "source": [
        {"cell": N_RUN - 1, "rate": -0.02},
        {"cell": 3, "rate": 0.01, "enthalpy": 500.0e3,
         "tracer": {"t1": 1e-6}},
    ],
    "boundaries": [{"primary": [8.0e6, 200.0], "region": 1,
                    "faces": {"cells": [0], "normal": [0.0, 1.0]}}],
    "time": {
        "stop": 2.0e5,
        "step": {"size": 2.0e4,
                 "adapt": {"on": True, "minimum": 2, "maximum": 6},
                 "maximum": {"number": 8}},
    },
    "output": {"frequency": 1},
}


def _compare_h5(a_name, b_name):
    import h5py

    with h5py.File(a_name) as fa, h5py.File(b_name) as fb:
        np.testing.assert_allclose(np.asarray(fa["time"]),
                                   np.asarray(fb["time"]), rtol=1e-12)
        for name in ("fluid_pressure", "fluid_temperature",
                     "fluid_vapour_saturation", "tracer_t1"):
            np.testing.assert_allclose(
                np.asarray(fa["cell_fields"][name]),
                np.asarray(fb["cell_fields"][name]), rtol=2e-5, atol=1e-10,
                err_msg=name)
        for name in ("source_rate", "source_enthalpy", "source_tracer_flow"):
            np.testing.assert_allclose(
                np.asarray(fa["source_fields"][name]),
                np.asarray(fb["source_fields"][name]), rtol=2e-5,
                atol=1e-12, err_msg=name)


def test_timestepper_matches_jax_and_single(tmp_path):
    from waiwera_tpu.mesh.rect import column_mesh as jcol
    from waiwera_tpu.parallel import DistributedSimulation as JDist
    from waiwera_tpu.sim.output import HDF5Output as JOut
    from waiwera_tpu.sim.simulation import Simulation as JSim
    from waiwera_tpu.sim.timestepper import Timestepper as JTs
    from waiwera_tpu_torch.mesh.rect import column_mesh as tcol
    from waiwera_tpu_torch.parallel import launch, runs
    from waiwera_tpu_torch.sim.output import HDF5Output
    from waiwera_tpu_torch.sim.simulation import Simulation
    from waiwera_tpu_torch.sim.timestepper import Timestepper

    port_h5 = str(tmp_path / "port.h5")
    r = launch.run(runs.run_rank, ["cpu"] * 2, copy.deepcopy(RUN_CONFIG),
                   tcol([10.0] * N_RUN), port_h5, threads=1,
                   timeout=300)[0]
    assert r["ok"]

    jax_h5 = str(tmp_path / "jax.h5")
    jsim = JDist(JSim(copy.deepcopy(RUN_CONFIG), mesh=jcol([10.0] * N_RUN)),
                 2)
    out = JOut(jax_h5, jsim)
    assert JTs(copy.deepcopy(RUN_CONFIG), jsim, output=out).run()
    out.close()
    _compare_h5(port_h5, jax_h5)

    single_h5 = str(tmp_path / "single.h5")
    sim = Simulation(copy.deepcopy(RUN_CONFIG), mesh=tcol([10.0] * N_RUN),
                     device="cpu")
    out = HDF5Output(single_h5, sim)
    ts = Timestepper(copy.deepcopy(RUN_CONFIG), sim, output=out)
    assert ts.run()
    out.close()
    _compare_h5(port_h5, single_h5)
    assert [dt for dt, _ in r["tried"]] == [dt for dt, _ in ts.tried]
