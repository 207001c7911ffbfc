"""Residual and AD block Jacobian of waiwera_tpu_torch against
waiwera_tpu for "wsce" (water, salt, CO2 and energy: b = 4, the CO2
correlations and viscosity table and the salting-out Henry's law on the
Jacobian), on chip_smoke.py's wsce model at 5 x 4 x 3 and a perturbed
state with two-phase cells. f64 residual within rtol 1e-10 and f64 parts
within 1e-8 of each block's largest entry; the port's f32 parts within
2e-4 of the JAX package's f64 parts (its own f32 chain runs the salt
EOS's finite-difference Newton loops below their step's resolution:
ROADMAP C13)."""

import numpy as np

from torch_parity import check_system, eos_model_config, sim_pair, \
    two_phase_state


def test_residual_and_jacobian_parts():
    sj, st = sim_pair(eos_model_config("wsce", 5, 4, 3))
    assert st.eos.gas.name == "CO2" and st.system.npv == 4
    check_system(sj, st, [(np.array(sj.y0), np.array(sj.region0)),
                          two_phase_state(sj)], f32_against="jax_f64")
