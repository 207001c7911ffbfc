"""Thermodynamic constants and the backend interface
(counterpart of waiwera_tpu/thermo/base.py).

Temperatures are in degrees Celsius and pressures in Pa, as in the
reference.
"""

from __future__ import annotations

import torch

# Physical constants (thermodynamics.F90:37-41)
RCONST = 0.461526e3  # specific gas constant of water (J/kg/K)
TC_K = 273.15  # Celsius -> Kelvin offset
WATER_MOLECULAR_WEIGHT = 18.01528  # g/mol
GAS_CONSTANT = 8.3144598  # J/mol/K
TTRIPLE = 0.01  # triple point of water (deg C)

# Critical point (IAPWS.F90:283-286)
TCRITICAL_K = 647.096
TCRITICAL = TCRITICAL_K - TC_K
PCRITICAL = 22.064e6
DCRITICAL = 322.0

# Phase-composition bitmask (IAPWS.F90:317-325): bit 0 = liquid,
# bit 1 = vapour, bit 2 = supercritical.
PHASE_LIQUID = 0b001
PHASE_VAPOUR = 0b010
PHASE_SUPERCRITICAL = 0b100


class Thermodynamics:
    """Interface of a pure-water thermodynamics backend: elementwise
    functions of tensors returning (values..., err) with err a bool
    tensor (True = out of operating range). Out-of-range results are
    finite, never NaN."""

    name: str = "abstract"
    tcritical: float = TCRITICAL
    pcritical: float = PCRITICAL

    # Region indices follow the reference: 1 = liquid water, 2 = dry steam,
    # 3 = supercritical, 4 = two-phase (not a property region).
    def region_properties(self, region, p, t):
        raise NotImplementedError

    def phase_composition(self, region: torch.Tensor, p: torch.Tensor,
                          t: torch.Tensor) -> torch.Tensor:
        """Phase-composition bitmask per cell (IAPWS.F90:317-364),
        int32."""
        ps, _ = self.saturation_pressure(t)
        subcritical = t <= self.tcritical
        liquid = torch.full_like(region, PHASE_LIQUID, dtype=torch.int32)
        vapour = torch.full_like(liquid, PHASE_VAPOUR)
        r3_phase = torch.where(p >= ps, liquid, vapour)
        sub = torch.where(
            region == 1, liquid, torch.where(region == 2, vapour, r3_phase)
        )
        sup = torch.where(
            p <= self.pcritical, vapour,
            torch.full_like(liquid, PHASE_SUPERCRITICAL),
        )
        return torch.where(
            region == 4,
            torch.full_like(liquid, PHASE_LIQUID | PHASE_VAPOUR),
            torch.where(subcritical, sub, sup),
        )
