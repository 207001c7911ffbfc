"""Residual and AD block Jacobian of waiwera_tpu_torch against
waiwera_tpu for the default EOS "we" (a model file with no eos and no
thermodynamics section) and the isothermal "w" (b = 1: the isothermal
branch of the assembly and the Jacobian), on the EOS models of
chip_smoke.py at 5 x 4 x 3 (Corey relative permeability, van Genuchten
capillarity, a two-phase top zone for "we"), at the initial state and at
a perturbed state with two-phase cells: f64 residual within rtol 1e-10,
f64 Jacobian parts within 1e-8 and f32 parts within 2e-4 of each
block's largest entry (tests/torch_parity.py check_system)."""

import numpy as np
import pytest

from torch_parity import check_system, eos_model_config, sim_pair, \
    two_phase_state


@pytest.mark.parametrize("kind", ["we", "w"])
def test_residual_and_jacobian_parts(kind):
    sj, st = sim_pair(eos_model_config(kind, 5, 4, 3))
    assert st.eos.name == kind and st.system.npv == (2 if kind == "we"
                                                      else 1)
    assert st.system.isothermal == (kind == "w")
    states = [(np.array(sj.y0), np.array(sj.region0)), two_phase_state(sj)]
    check_system(sj, st, states)
