"""Isothermal pure water EOS "w" (counterpart of waiwera_tpu/eos/w.py
and eos_w.F90): one primary variable (pressure), one phase, the
temperature fixed by JSON "eos.temperature" (default 20 C)."""

from __future__ import annotations

import numpy as np
import torch

from waiwera_tpu_torch.eos.base import EOS
from waiwera_tpu_torch.physics.state import FluidState


class EOSWater(EOS):
    name = "w"
    description = "Isothermal pure water"
    num_primary_variables = 1
    num_phases = 1
    num_mobile_phases = 1
    num_components = 1
    phase_names = ("liquid",)
    component_names = ("water",)
    primary_variable_names = ("pressure",)
    default_region = 1
    isothermal = True
    required_output_fluid_fields = ("pressure", "region")
    default_output_fluid_fields = required_output_fluid_fields

    def __init__(self, config, thermo, relperm, capillarity):
        super().__init__(thermo, relperm, capillarity)
        eos_cfg = config.get("eos", {}) if config else {}
        if not isinstance(eos_cfg, dict):
            eos_cfg = {}
        scale_cfg = eos_cfg.get("primary", {}).get("scale", {})
        p_scale = float(scale_cfg.get("pressure", 1.0e6))
        self.primary_scale = np.array([[p_scale], [p_scale]])
        self.default_primary = np.array([1.0e5])
        self.temperature = float(eos_cfg.get("temperature", 20.0))

    def properties(self, primary, region, rock):
        p = primary[:, 0]
        t = torch.full_like(p, self.temperature)
        phases = self.phase_composition(region, p, t)

        # properties of the region the cell is in (1 water, 2 steam)
        dl, ul, el = self.thermo.water_properties(p, t)
        dv, uv, ev = self.thermo.steam_properties(p, t)
        steam = region == 2
        density = torch.where(steam, dv, dl)
        energy = torch.where(steam, uv, ul)
        err = torch.where(steam, ev, el)
        visc = torch.where(
            steam,
            self.thermo.phase_viscosity(1, t, p, density),
            self.thermo.phase_viscosity(0, t, p, density),
        )
        enthalpy = energy + p / torch.where(density > 0, density, 1.0)

        ones = torch.ones_like(p)
        region32 = region.to(torch.int32)
        fluid = FluidState(
            pressure=p,
            temperature=t,
            region=region32,
            old_region=region32,
            phase_composition=phases,
            permeability_factor=ones,
            partial_pressure=p[:, None],
            density=density[:, None],
            viscosity=visc[:, None],
            saturation=ones[:, None],
            relative_permeability=ones[:, None],
            capillary_pressure=torch.zeros_like(p)[:, None],
            specific_enthalpy=enthalpy[:, None],
            internal_energy=energy[:, None],
            mass_fraction=ones[:, None, None],
        )
        return fluid, err

    def check_primary_variables(self, primary, region):
        p = primary[:, 0]
        return primary, (p < 0.0) | (p > 100.0e6)

    def primary_variables(self, fluid: FluidState) -> torch.Tensor:
        return fluid.pressure[:, None]

    def primary_from_output_fields(self, fields):
        p = np.asarray(fields["pressure"], dtype=np.float64)
        region = np.asarray(fields.get("region", np.ones_like(p)),
                            dtype=np.int32)
        return p[:, None], region
