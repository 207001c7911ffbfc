"""Non-isothermal pure water EOS "we" (counterpart of
waiwera_tpu/eos/we.py and eos_we.F90): two primary variables ([P, T]
single-phase, [P, S_v] two-phase) in regions 1 (liquid), 2 (steam) and 4
(two-phase), with saturation-line transitions that interpolate the
Newton path (eos_we.F90:149-323). The default EOS of a model file."""

from __future__ import annotations

import numpy as np
import torch

from waiwera_tpu_torch.eos.base import EOS, bisect, interpolation_fraction
from waiwera_tpu_torch.physics.state import FluidState

_SMALL = 1e-6  # transition nudge (eos_we.F90 parameter small)
_BISECTION_STEPS = 50


class EOSWaterEnergy(EOS):
    name = "we"
    description = "Pure water and energy"
    num_primary_variables = 2
    num_phases = 2
    num_mobile_phases = 2
    num_components = 1
    phase_names = ("liquid", "vapour")
    component_names = ("water",)
    primary_variable_names = ("pressure", "temperature/vapour_saturation")
    default_region = 1
    isothermal = False
    required_output_fluid_fields = (
        "pressure",
        "temperature",
        "region",
        "vapour_saturation",
    )
    default_output_fluid_fields = required_output_fluid_fields

    def __init__(self, config, thermo, relperm, capillarity):
        super().__init__(thermo, relperm, capillarity)
        eos_cfg = config.get("eos", {}) if config else {}
        primary_cfg = (
            eos_cfg.get("primary", {}) if isinstance(eos_cfg, dict) else {}
        )
        scale_cfg = primary_cfg.get("scale", {})
        p_scale = float(scale_cfg.get("pressure", 1.0e6))
        t_scale = float(scale_cfg.get("temperature", 1.0e2))
        # [region, var]; region 4 scales S_v by 1 (eos_we.F90:106-112)
        self.primary_scale = np.array(
            [
                [p_scale, t_scale],
                [p_scale, t_scale],
                [0.0, 0.0],  # region 3 unused
                [p_scale, 1.0],
            ]
        )
        self.default_primary = np.array([1.0e5, 20.0])

    # -- properties --------------------------------------------------

    def temperature_of(self, primary, region):
        """Per-cell temperature: primary T single-phase, Tsat(P)
        two-phase (eos_we.F90 bulk_properties). Returns (t, err)."""
        p = primary[:, 0]
        tsat, sat_err = self.thermo.saturation_temperature(p)
        two_phase = region == 4
        t = torch.where(two_phase, tsat, primary[:, 1])
        return t, two_phase & sat_err

    def phase_saturations(self, primary, region):
        """[N, 2] (liquid, vapour) saturations (eos_we.F90:376-399)."""
        x = primary[:, 1]
        sv = torch.where(
            region == 4,
            x,
            torch.where(region == 2, torch.ones_like(x), torch.zeros_like(x)),
        )
        return torch.stack([1.0 - sv, sv], dim=-1)

    def properties(self, primary, region, rock):
        p = primary[:, 0]
        t, err = self.temperature_of(primary, region)
        phases = self.phase_composition(region, p, t)
        sat = self.phase_saturations(primary, region)
        sl = sat[:, 0]

        relperm = self.relative_permeability(sl)  # [N, 2]
        cp_l = self.capillary_pressure(sl, t)
        cap = torch.stack([cp_l, torch.zeros_like(cp_l)], dim=-1)

        dl, ul, el = self.thermo.water_properties(p, t)
        dv, uv, ev = self.thermo.steam_properties(p, t)

        bits = torch.arange(2, device=phases.device)
        present = ((phases[:, None] >> bits) & 1) > 0
        density = torch.stack([dl, dv], dim=-1)
        energy = torch.stack([ul, uv], dim=-1)
        enthalpy = energy + p[:, None] / torch.where(density > 0, density,
                                                     1.0)
        visc = torch.stack(
            [
                self.thermo.phase_viscosity(0, t, p, dl),
                self.thermo.phase_viscosity(1, t, p, dv),
            ],
            dim=-1,
        )
        prop_err = torch.stack([el, ev], dim=-1)
        err = err | torch.any(present & prop_err, dim=-1)

        region32 = region.to(torch.int32)
        fluid = FluidState(
            pressure=p,
            temperature=t,
            region=region32,
            old_region=region32,
            phase_composition=phases,
            permeability_factor=torch.ones_like(p),
            partial_pressure=p[:, None],
            density=torch.where(present, density, 0.0),
            viscosity=torch.where(present, visc, 0.0),
            saturation=sat,
            relative_permeability=torch.where(present, relperm, 0.0),
            capillary_pressure=torch.where(present, cap, 0.0),
            specific_enthalpy=torch.where(present, enthalpy, 0.0),
            internal_energy=torch.where(present, energy, 0.0),
            mass_fraction=torch.where(
                present, torch.ones_like(density), 0.0)[:, :, None],
        )
        return fluid, err

    # -- transitions (eos_we.F90:149-323) ---------------------------

    def transition(self, old_primary, primary, region, old_temperature):
        p = primary[:, 0]
        second = primary[:, 1]
        old_region = region
        was_two_phase = old_region == 4

        # --- two-phase -> single-phase -----------------------------
        to_liquid = was_two_phase & (second < 0.0)
        to_vapour = was_two_phase & (second > 1.0)
        bound = torch.where(to_liquid, torch.zeros_like(p),
                            torch.ones_like(p))
        pressure_factor = torch.where(
            to_liquid,
            torch.full_like(p, 1.0 + _SMALL),
            torch.full_like(p, 1.0 - _SMALL),
        )
        xi = interpolation_fraction(bound, old_primary[:, 1], second)
        xi_ok = (xi >= 0.0) & (xi <= 1.0)
        p_interp = old_primary[:, 0] + xi * (p - old_primary[:, 0])
        t_interp, terr = self.thermo.saturation_temperature(p_interp)
        # fallback: the old fluid temperature's saturation pressure
        p_old_sat, perr = self.thermo.saturation_pressure(old_temperature)
        ok = xi_ok & ~terr
        sp_pressure = torch.where(
            ok, pressure_factor * p_interp, pressure_factor * p_old_sat
        )
        sp_temperature = torch.where(ok, t_interp, old_temperature)
        sp_err = ~ok & perr
        sp_region = torch.where(
            to_liquid, torch.full_like(old_region, 1),
            torch.full_like(old_region, 2),
        )

        # --- single-phase -> two-phase -----------------------------
        psat_new, psat_err = self.thermo.saturation_pressure(second)
        crossing = (~was_two_phase) & ~psat_err & (
            ((old_region == 1) & (p < psat_new))
            | ((old_region == 2) & (p > psat_new))
        )
        # root of f(x) = P(x) - Psat(T(x)) along the straight line from
        # the old to the new primaries, by fixed-iteration bisection
        # (replaces the reference's saturation_line_finder)
        p0 = old_primary[:, 0]
        t0 = old_primary[:, 1]
        dp = p - p0
        dt = second - t0

        def f_of(x):
            ps, _ = self.thermo.saturation_pressure(t0 + x * dt)
            return (p0 + x * dp) - ps

        f0 = f_of(torch.zeros_like(p))
        f1 = f_of(torch.ones_like(p))
        bracket = f0 * f1 < 0.0
        x_root = bisect(f_of, f0, p, _BISECTION_STEPS)
        tp_pressure = torch.where(bracket, p0 + x_root * dp, psat_new)
        tp_sv = torch.where(
            old_region == 1,
            torch.full_like(p, _SMALL),
            torch.full_like(p, 1.0 - _SMALL),
        )

        # --- combine -----------------------------------------------
        goes_single = to_liquid | to_vapour
        four = torch.full_like(old_region, 4)
        new_region = torch.where(
            goes_single, sp_region, torch.where(crossing, four, old_region)
        ).to(torch.int32)
        new_p = torch.where(
            goes_single, sp_pressure, torch.where(crossing, tp_pressure, p)
        )
        new_second = torch.where(
            goes_single, sp_temperature, torch.where(crossing, tp_sv, second)
        )
        transition = goes_single | crossing
        err = goes_single & sp_err
        new_primary = torch.stack([new_p, new_second], dim=-1)
        return new_primary, new_region, transition, err

    def check_primary_variables(self, primary, region):
        """Bounds (eos_we.F90:474-516): P in [0, 100e6]; T in [0, 800]
        single-phase; S_v in [-1, 2] two-phase."""
        p = primary[:, 0]
        x = primary[:, 1]
        p_bad = (p < 0.0) | (p > 100.0e6)
        two_phase = region == 4
        x_bad = torch.where(
            two_phase,
            (x < -1.0) | (x > 2.0),
            (x < 0.0) | (x > 800.0),
        )
        return primary, p_bad | x_bad

    def primary_from_output_fields(self, fields):
        p = np.asarray(fields["pressure"], dtype=np.float64)
        t = np.asarray(fields["temperature"], dtype=np.float64)
        sv = np.asarray(fields["vapour_saturation"], dtype=np.float64)
        region = np.asarray(fields["region"], dtype=np.int32)
        second = np.where(region == 4, sv, t)
        return np.stack([p, second], axis=-1), region

    def primary_variables(self, fluid: FluidState) -> torch.Tensor:
        second = torch.where(
            fluid.region == 4, fluid.saturation[:, 1], fluid.temperature
        )
        return torch.stack([fluid.pressure, second], dim=-1)
