"""Rock controls of waiwera_tpu_torch (permeability and porosity tables
against time on rock types, rock_setup.F90:304-324, applied at each
try's end time, flow_simulation.F90:2040-2094): the cases of
tests/test_rock_controls.py:33 and :84 on the port, held against the
JAX package."""

import copy

import numpy as np
import torch

from torch_parity import np_


def _column_config(nz, rock_types):
    return {
        "mesh": {"type": "column", "dz": [10.0] * nz},
        "gravity": 9.8,
        "eos": {"name": "w", "temperature": 20.0},
        "initial": {"primary": [1.0e5], "region": 1},
        "rock": {"types": rock_types},
        "boundaries": [{"primary": [1.0e5], "region": 1,
                        "faces": {"cells": [0], "normal": [0.0, 1.0]}}],
        "time": {"start": 0.0, "stop": 4.0e4,
                 "step": {"size": 1.0e4, "maximum": {"number": 10}}},
    }


def _sims(cfg):
    from waiwera_tpu.sim.simulation import Simulation as JSim
    from waiwera_tpu_torch.sim.simulation import Simulation as TSim

    return JSim(copy.deepcopy(cfg)), TSim(copy.deepcopy(cfg), device="cpu")


def test_rock_control_tables_parsed_and_interpolated():
    """A rank-2 permeability / porosity entry becomes a time table;
    rock_for(t) interpolates it, clamps past the table's end, and the
    ghost cells follow their interior cell; scalar types make no
    controls."""
    nz = 5
    sj, st = _sims(_column_config(nz, [{
        "name": "r1", "cells": list(range(nz)),
        "permeability": [[0.0, 1e-13], [1.0e4, 3e-13]],
        "porosity": [[0.0, 0.1], [1.0e4, 0.2]],
    }]))
    assert len(st.rock_controls) == len(sj.rock_controls) == 2
    for t, k, phi in ((0.0, 1e-13, 0.1), (5.0e3, 2e-13, 0.15),
                      (1.0e4, 3e-13, 0.2), (9.9e9, 3e-13, 0.2)):
        rt, rj = st.rock_for(t), sj.rock_for(t)
        assert rt.permeability.device == st.device
        np.testing.assert_allclose(np_(rt.permeability),
                                   np.asarray(rj.permeability), rtol=1e-14)
        np.testing.assert_allclose(np_(rt.porosity), np.asarray(rj.porosity),
                                   rtol=1e-14)
        np.testing.assert_allclose(np_(rt.permeability)[:nz], k, rtol=1e-12)
        np.testing.assert_allclose(np_(rt.porosity)[:nz], phi, rtol=1e-12)
    g = np.flatnonzero(np_(st.mesh_dev.is_ghost))
    assert len(g)
    np.testing.assert_allclose(np_(st.rock_for(5.0e3).permeability)[g, 0],
                               2e-13, rtol=1e-12)
    # the base rock is left as it was
    np.testing.assert_allclose(np_(st.rock.porosity)[:nz], 0.1)
    _, st2 = _sims(_column_config(nz, [{
        "name": "r1", "cells": list(range(nz)), "permeability": 1e-13,
        "porosity": 0.1}]))
    assert st2.rock_controls == []
    assert st2.rock_for(123.0) is st2.rock


def test_rock_control_affects_timestep():
    """The step function takes each try's rock: with the permeability
    shut off, gravity equilibration stalls where the constant-
    permeability column equilibrates; both runs as the JAX package's."""
    from waiwera_tpu.sim.timestepper import Timestepper as JTs
    from waiwera_tpu_torch.sim.timestepper import Timestepper as TTs

    nz = 8

    def run(rock_types):
        cfg = _column_config(nz, rock_types)
        sj, st = _sims(cfg)
        tj, tt = JTs(copy.deepcopy(cfg), sj), TTs(copy.deepcopy(cfg), st)
        assert tj.run() and tt.run()
        assert tt.taken == tj.taken
        p = np_(tt.final_fluid.pressure)[:nz]
        np.testing.assert_allclose(
            p, np.asarray(tj.final_fluid.pressure)[:nz], rtol=1e-8)
        return p

    p_const = run([{"name": "r", "cells": list(range(nz)),
                    "permeability": 1e-12, "porosity": 0.1}])
    p_tab = run([{"name": "r", "cells": list(range(nz)),
                  "permeability": [[0.0, 1e-22], [1.0e9, 1e-22]],
                  "porosity": 0.1}])
    assert p_const[-1] > 1.7e5
    assert abs(p_tab[-1] - 1.0e5) < 1e3


def test_rock_for_builds_tensors_in_the_rock_dtype():
    """rock_for's tables are evaluated on the simulation's device in
    f64, with a three-column (anisotropic) permeability table."""
    nz = 3
    _, st = _sims(_column_config(nz, [{
        "name": "r", "cells": [1, 2],
        "permeability": [[0.0, 1e-13, 2e-13, 3e-13],
                         [1.0e4, 2e-13, 4e-13, 6e-13]],
        "porosity": 0.2}]))
    rock = st.rock_for(2.5e3)
    assert rock.permeability.dtype == torch.float64
    np.testing.assert_allclose(np_(rock.permeability)[1:3],
                               [[1.25e-13, 2.5e-13, 3.75e-13]] * 2,
                               rtol=1e-12)
    np.testing.assert_allclose(np_(rock.permeability)[0],
                               np_(st.rock.permeability)[0])
