"""The salt EOS "wse" on IFC-67 in a whole model run of waiwera_tpu_torch
against waiwera_tpu: chip_smoke.py's wse model at 5 x 4 x 3 (brine with
part of the box in the halite region 5, the power-law permeability
modifier, Corey relative permeability, van Genuchten capillarity), 3
adaptive steps with the schema's default f64 solver through both
packages' Timestepper: the same tries, sizes and statuses, the same
final regions (one cell changes region), final scaled primaries within
rtol 1e-8 (tests/torch_parity.py check_run)."""

import numpy as np

from torch_parity import check_run, eos_model_config, np_, run_pair


def test_wse_run_matches_jax():
    cfg = eos_model_config("wse", 5, 4, 3, steps=3)
    tj, tt = run_pair(cfg)
    assert tt.sim.eos.name == "wse" and tt.sim.thermo.name == "IFC-67"
    assert 5 in np_(tt.sim.region0).tolist()
    check_run(tj, tt, 3)
    assert (np_(tt.sim.region0) != np_(tt.final_region)).any()
    # the solid phase is in the final state
    assert np.asarray(np_(tt.final_region) >= 5).any()
