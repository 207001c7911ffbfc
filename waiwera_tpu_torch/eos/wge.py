"""Water + non-condensible gas + energy EOS, "wge", with "wae" (air)
and "wce" (CO2) (counterpart of waiwera_tpu/eos/wge.py and eos_wge.F90,
eos_wae.F90, eos_wce.F90).

Three primary variables [P, T|S_v, Pg] in regions 1, 2 and 4; Henry's
law gas dissolution in the liquid, gas/steam mixtures in the vapour,
and saturation-line transitions in terms of the water partial pressure
P - Pg.
"""

from __future__ import annotations

import numpy as np
import torch

from waiwera_tpu_torch.eos.base import EOS, bisect, interpolation_fraction
from waiwera_tpu_torch.physics.state import FluidState
from waiwera_tpu_torch.thermo import ncg as ncg_mod

_SMALL = 1e-6
_BISECTION_STEPS = 50


class EOSWaterGasEnergy(EOS):
    num_primary_variables = 3
    num_phases = 2
    num_mobile_phases = 2
    num_components = 2
    phase_names = ("liquid", "vapour")
    primary_variable_names = (
        "pressure",
        "temperature/vapour_saturation",
        "gas partial pressure",
    )
    default_region = 1
    isothermal = False
    required_output_fluid_fields = (
        "pressure",
        "temperature",
        "region",
        "gas_partial_pressure",
        "vapour_saturation",
    )
    default_output_fluid_fields = required_output_fluid_fields

    def __init__(self, config, thermo, relperm, capillarity, name="wge"):
        super().__init__(thermo, relperm, capillarity)
        self.name = name
        eos_cfg = config.get("eos", {}) if config else {}
        if not isinstance(eos_cfg, dict):
            eos_cfg = {}
        gas_name = {"wge": None, "wae": "air", "wce": "co2"}[name]
        if gas_name is None:
            # the gas named by eos.gas (air by default)
            gas_name = eos_cfg.get("gas", "air")
        self.gas = ncg_mod.from_name(gas_name)
        self.description = f"Water, {self.gas.name} and energy"
        self.component_names = ("water", self.gas.name)

        scale_cfg = eos_cfg.get("primary", {}).get("scale", {})
        p_scale = float(scale_cfg.get("pressure", 1.0e6))
        t_scale = float(scale_cfg.get("temperature", 1.0e2))
        pp_spec = scale_cfg.get("partial_pressure", "adaptive")
        self.adaptive_pp_scale = not isinstance(pp_spec, (int, float))
        pp_scale = float(pp_spec) if not self.adaptive_pp_scale else 1.0e6
        self.primary_scale = np.array(
            [
                [p_scale, t_scale, pp_scale],
                [p_scale, t_scale, pp_scale],
                [0.0, 0.0, 0.0],
                [p_scale, 1.0, pp_scale],
            ]
        )
        self.default_primary = np.array([1.0e5, 20.0, 0.0])

    # -- adaptive partial-pressure scaling (eos_wge.F90:639-674) ------

    def scale(self, primary, region):
        scaled = super().scale(primary, region)
        if self.adaptive_pp_scale:
            p = primary[..., 0]
            pp = primary[..., 2] / torch.where(p > 0, p, 1.0)
            scaled = torch.cat([scaled[..., :2], pp[..., None]], dim=-1)
        return scaled

    def unscale(self, scaled, region):
        primary = super().unscale(scaled, region)
        if self.adaptive_pp_scale:
            p = primary[..., 0]
            pg = scaled[..., 2] * p
            primary = torch.cat([primary[..., :2], pg[..., None]], dim=-1)
        return primary

    # -- properties ----------------------------------------------------

    def phase_saturations(self, primary, region):
        x = primary[:, 1]
        sv = torch.where(
            region == 4,
            x,
            torch.where(region == 2, torch.ones_like(x), torch.zeros_like(x)),
        )
        return torch.stack([1.0 - sv, sv], dim=-1)

    def properties(self, primary, region, rock):
        p = primary[:, 0]
        pg = primary[:, 2]
        pw = p - pg
        tsat, sat_err = self.thermo.saturation_temperature(pw)
        two_phase = region == 4
        t = torch.where(two_phase, tsat, primary[:, 1])
        err = two_phase & sat_err

        phases = self.phase_composition(region, p, t)
        sat = self.phase_saturations(primary, region)
        sl = sat[:, 0]

        relperm = self.relative_permeability(sl)
        cp_l = self.capillary_pressure(sl, t)
        cap = torch.stack([cp_l, torch.zeros_like(cp_l)], dim=-1)

        # gas properties at (Pg, T) (eos_wge.F90:435-438)
        gd, gh, gerr = self.gas.properties(pg, t)
        henry = self.gas.henrys_constant(t)
        esol = self.gas.energy_solution(t)

        # liquid phase: water at total pressure
        dl, ul, el = self.thermo.water_properties(p, t)
        hl_w = ul + p / torch.where(dl > 0, dl, 1.0)
        xg_l = self.gas.mass_fraction(pg, t, 0, 0.0, dl, henry)
        rho_l = dl  # gas density effectively 0 in liquid
        h_l = hl_w * (1.0 - xg_l) + (gh + esol) * xg_l
        u_l = h_l - p / torch.where(rho_l > 0, rho_l, 1.0)
        visc_w_l = self.thermo.phase_viscosity(0, t, p, dl)
        visc_l, verr_l = self.gas.mixture_viscosity(visc_w_l, t, pg, xg_l, 0)

        # vapour phase: steam at water partial pressure + gas
        dv, uv, ev = self.thermo.steam_properties(pw, t)
        hv_w = uv + pw / torch.where(dv > 0, dv, 1.0)
        rho_v = dv + gd
        xg_v = self.gas.mass_fraction(pg, t, 1, gd, dv, henry)
        h_v = hv_w * (1.0 - xg_v) + gh * xg_v
        u_v = h_v - p / torch.where(rho_v > 0, rho_v, 1.0)
        visc_w_v = self.thermo.phase_viscosity(1, t, p, dv)
        visc_v, verr_v = self.gas.mixture_viscosity(visc_w_v, t, pg, xg_v, 1)

        bits = torch.arange(2, device=phases.device)
        present = ((phases[:, None] >> bits) & 1) > 0
        in_l = present[:, 0]
        in_v = present[:, 1]
        err = err | gerr
        err = err | (in_l & (el | verr_l)) | (in_v & (ev | verr_v))

        density = torch.stack([rho_l, rho_v], dim=-1)
        energy = torch.stack([u_l, u_v], dim=-1)
        enthalpy = torch.stack([h_l, h_v], dim=-1)
        visc = torch.stack([visc_l, visc_v], dim=-1)
        xg = torch.stack([xg_l, xg_v], dim=-1)
        mass_frac = torch.stack([1.0 - xg, xg], dim=-1)  # [N, np, nc]

        region32 = region.to(torch.int32)
        fluid = FluidState(
            pressure=p,
            temperature=t,
            region=region32,
            old_region=region32,
            phase_composition=phases,
            permeability_factor=torch.ones_like(p),
            partial_pressure=torch.stack([pw, pg], dim=-1),
            density=torch.where(present, density, 0.0),
            viscosity=torch.where(present, visc, 0.0),
            saturation=sat,
            relative_permeability=torch.where(present, relperm, 0.0),
            capillary_pressure=torch.where(present, cap, 0.0),
            specific_enthalpy=torch.where(present, enthalpy, 0.0),
            internal_energy=torch.where(present, energy, 0.0),
            mass_fraction=torch.where(present[:, :, None], mass_frac, 0.0),
        )
        return fluid, err

    # -- transitions (eos_wge.F90:130-345) ----------------------------

    def transition(self, old_primary, primary, region, old_temperature):
        p = primary[:, 0]
        second = primary[:, 1]
        pg = torch.minimum(torch.clamp_min(primary[:, 2], 0.0), p)
        old_region = region
        was_two_phase = old_region == 4

        # --- two-phase -> single-phase -------------------------------
        to_liquid = was_two_phase & (second < 0.0)
        to_vapour = was_two_phase & (second > 1.0)
        bound = torch.where(to_liquid, torch.zeros_like(p), torch.ones_like(p))
        pressure_factor = torch.where(
            to_liquid,
            torch.full_like(p, 1.0 + _SMALL),
            torch.full_like(p, 1.0 - _SMALL),
        )
        xi = interpolation_fraction(bound, old_primary[:, 1], second)
        xi_ok = (xi >= 0.0) & (xi <= 1.0)
        p_i = old_primary[:, 0] + xi * (p - old_primary[:, 0])
        pg_i = old_primary[:, 2] + xi * (pg - old_primary[:, 2])
        pw_i = p_i - pg_i
        t_i, terr = self.thermo.saturation_temperature(pw_i)
        p_old_sat, perr = self.thermo.saturation_pressure(old_temperature)
        ok = xi_ok & ~terr
        sp_pressure = torch.where(
            ok,
            pressure_factor * pw_i + pg_i,
            pressure_factor * p_old_sat + pg,
        )
        sp_pg = torch.where(ok, pg_i, pg)
        sp_temperature = torch.where(ok, t_i, old_temperature)
        sp_err = ~ok & perr
        sp_region = torch.where(
            to_liquid, torch.full_like(old_region, 1),
            torch.full_like(old_region, 2),
        )

        # --- single-phase -> two-phase -------------------------------
        psat_new, psat_err = self.thermo.saturation_pressure(second)
        pw_new = p - pg
        crossing = (~was_two_phase) & ~psat_err & (
            ((old_region == 1) & (pw_new < psat_new))
            | ((old_region == 2) & (pw_new > psat_new))
        )
        p0 = old_primary[:, 0]
        t0 = old_primary[:, 1]
        g0 = old_primary[:, 2]
        dp = p - p0
        dt = second - t0
        dg = pg - g0

        def f_of(x):
            ps, _ = self.thermo.saturation_pressure(t0 + x * dt)
            return (p0 + x * dp) - (g0 + x * dg) - ps

        f0 = f_of(torch.zeros_like(p))
        f1 = f_of(torch.ones_like(p))
        bracket = f0 * f1 < 0.0

        x_root = bisect(f_of, f0, p, _BISECTION_STEPS)
        tp_pressure = torch.where(bracket, p0 + x_root * dp, psat_new + pg)
        tp_pg = torch.where(bracket, g0 + x_root * dg, pg)
        tp_sv = torch.where(
            old_region == 1,
            torch.full_like(p, _SMALL),
            torch.full_like(p, 1.0 - _SMALL),
        )

        # --- combine --------------------------------------------------
        goes_single = to_liquid | to_vapour
        four = torch.full_like(old_region, 4)
        new_region = torch.where(
            goes_single, sp_region, torch.where(crossing, four, old_region)
        ).to(torch.int32)
        new_p = torch.where(
            goes_single, sp_pressure, torch.where(crossing, tp_pressure, p)
        )
        new_second = torch.where(
            goes_single, sp_temperature,
            torch.where(crossing, tp_sv, second),
        )
        new_pg = torch.where(
            goes_single, sp_pg, torch.where(crossing, tp_pg, pg)
        )
        transition = goes_single | crossing
        err = goes_single & sp_err
        new_primary = torch.stack([new_p, new_second, new_pg], dim=-1)
        return new_primary, new_region, transition, err

    def check_primary_variables(self, primary, region):
        """Bounds with partial-pressure clamping
        (eos_wge.F90:573-634)."""
        p = primary[:, 0]
        x = primary[:, 1]
        pg = primary[:, 2]
        p_bad = p <= 0.0
        pg_max = (1.0 - _SMALL) * torch.clamp_min(p, 0.0)
        pg_new = torch.minimum(torch.clamp_min(pg, 0.0), pg_max)
        pw = p - pg_new
        pw_bad = pw > 100.0e6
        two_phase = region == 4
        x_bad = torch.where(
            two_phase,
            (x < -1.0) | (x > 2.0),
            (x < 0.0) | (x > 800.0),
        )
        out = torch.stack([p, x, pg_new], dim=-1)
        return out, p_bad | pw_bad | x_bad

    def primary_from_output_fields(self, fields):
        p = np.asarray(fields["pressure"], dtype=np.float64)
        t = np.asarray(fields["temperature"], dtype=np.float64)
        sv = np.asarray(fields["vapour_saturation"], dtype=np.float64)
        pg = np.asarray(fields["gas_partial_pressure"], dtype=np.float64)
        region = np.asarray(fields["region"], dtype=np.int32)
        second = np.where(region == 4, sv, t)
        return np.stack([p, second, pg], axis=-1), region

    def primary_variables(self, fluid: FluidState) -> torch.Tensor:
        second = torch.where(
            fluid.region == 4, fluid.saturation[:, 1], fluid.temperature
        )
        return torch.stack(
            [fluid.pressure, second, fluid.partial_pressure[:, 1]], dim=-1
        )
