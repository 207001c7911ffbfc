"""The EOS "wsce" (water, salt, CO2, energy; b = 4) in a whole model run
of waiwera_tpu_torch against waiwera_tpu: chip_smoke.py's wsce model at
5 x 4 x 3 (brine with dissolved CO2 at 150 C), 3 adaptive steps with the
schema's default f64 solver through both packages' Timestepper: the
same tries, sizes and statuses, the same final regions, final scaled
primaries within rtol 1e-8 (tests/torch_parity.py check_run)."""

from torch_parity import check_run, eos_model_config, run_pair


def test_wsce_run_matches_jax():
    tj, tt = run_pair(eos_model_config("wsce", 5, 4, 3, steps=3))
    assert tt.sim.eos.name == "wsce" and tt.sim.system.npv == 4
    check_run(tj, tt, 3)
