"""Configuration handling of waiwera_tpu_torch: what lies outside the
ported slice raises NotImplementedError naming the ROADMAP item that
will port it, and the state containers match the JAX package's."""

import copy

import numpy as np
import pytest
import torch

from torch_parity import flagship_config, np_


def _sim(cfg, mesh=True):
    from waiwera_tpu_torch.mesh.rect import rectangular_mesh
    from waiwera_tpu_torch.sim.simulation import Simulation

    m = (rectangular_mesh([50.0] * 3, [50.0] * 2, [20.0] * 2,
                          origin=[0.0, 0.0, -40.0]) if mesh else None)
    return Simulation(cfg, mesh=m, device="cpu")


def _with(path, value):
    """The flagship config of a 3 x 2 x 2 box with one entry replaced."""
    cfg = copy.deepcopy(flagship_config(3, 2, 2))
    *keys, last = path
    node = cfg
    for k in keys:
        node = node.setdefault(k, {}) if isinstance(k, str) else node[k]
    node[last] = value
    return cfg


def test_flagship_config_builds():
    sim = _sim(flagship_config(3, 2, 2))
    assert sim.mesh.num_interior_cells == 12
    assert sim.y0.dtype == torch.float64 and sim.region0.dtype == torch.int32


@pytest.mark.parametrize("cfg, item", [
    (_with(["eos", "name"], "we"), "A12"),
    (_with(["thermodynamics"], "ifc67"), "A12"),
    (_with(["rock", "relative_permeability"], {"type": "linear"}), "A12"),
    (_with(["rock", "capillary_pressure"], {"type": "linear"}), "A12"),
    (_with(["source", 0, "limiter"], {"total": 5.0}), "A13"),
    (_with(["source", 1, "rate"], [[0.0, 1.0], [1e5, 2.0]]), "A13"),
    (_with(["tracer"], [{"name": "t"}]), "A13"),
    (_with(["rock", "types", 0, "porosity"], [0.1, 0.2]), "A13"),
    (_with(["initial", "filename"], "restart.h5"), "A11"),
], ids=["eos_we", "ifc67", "relperm", "capillarity", "limiter",
        "rate_table", "tracer", "rock_table", "restart"])
def test_config_outside_the_slice_raises(cfg, item):
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        _sim(cfg)


def test_mesh_from_config_raises():
    with pytest.raises(NotImplementedError, match="ROADMAP A11"):
        _sim(flagship_config(3, 2, 2), mesh=False)


def test_solver_options_outside_the_slice_raise():
    from waiwera_tpu_torch.solver import krylov
    from waiwera_tpu_torch.solver.system import method_coeffs

    sim = _sim(flagship_config(3, 2, 2))
    lhs, _, _ = sim.lhs_at(sim.y0, sim.region0)
    with pytest.raises(NotImplementedError, match="ROADMAP A11"):
        method_coeffs("bdf2", 1e4, lhs)
    with pytest.raises(NotImplementedError, match="ROADMAP A14"):
        krylov.solve("gmres", lambda v: v, torch.ones(4, 3))
    n = sim.mesh.num_cells
    parts = (torch.ones(9, n), torch.zeros(9, 1), torch.zeros(9, 1))
    with pytest.raises(NotImplementedError, match="ROADMAP A14"):
        sim.system.linear_operator_from_parts(parts, "lu")


def test_empty_fluid_matches_jax():
    from waiwera_tpu.physics.state import empty_fluid as jempty
    from waiwera_tpu_torch.physics.state import empty_fluid as tempty

    fj, ft = jempty(7, 2, 2), tempty(7, 2, 2)
    for name in fj._fields:
        a, b = np.asarray(getattr(fj, name)), np_(getattr(ft, name))
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(b, a, err_msg=name)
