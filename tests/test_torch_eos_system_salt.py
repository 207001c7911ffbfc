"""Residual and AD block Jacobian of waiwera_tpu_torch against
waiwera_tpu for the salt EOS "wse" with the power-law permeability
modifier (b = 3, three phases of which two are mobile), on chip_smoke.py's
wse model at 5 x 4 x 3: brine with part of the box in the halite region
5, so the solid phase and the modifier are on the Jacobian, and a
perturbed state with cells in regions 4 and 8. f64 residual within rtol
1e-10 and f64 parts within 1e-8 of each block's largest entry; the
port's f32 parts within 2e-4 of the JAX package's f64 parts (its own f32
chain runs the finite-difference Newton loops below their step's
resolution: ROADMAP C13). On IAPWS-97: the f32 liquid energy of IFC-67
carries ~7e-4 of round-off in its derivatives in either package, and
tests/test_torch_eos_run_salt.py runs the model on IFC-67 in f64."""

import numpy as np

from torch_parity import check_system, eos_model_config, sim_pair, \
    two_phase_state


def test_residual_and_jacobian_parts():
    cfg = eos_model_config("wse", 5, 4, 3)
    cfg["thermodynamics"] = "iapws"
    sj, st = sim_pair(cfg)
    assert st.eos.name == "wse" and st.system.npv == 3
    region = np.asarray(sj.region0)
    assert {1, 5} <= set(region.tolist())
    y, r = two_phase_state(sj)
    assert {4, 8} <= set(r.tolist())
    check_system(sj, st, [(np.array(sj.y0), region), (y, r)],
                 f32_against="jax_f64")
