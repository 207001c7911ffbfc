"""Water + salt + non-condensible gas + energy EOS "wsge", with "wsae"
(air) and "wsce" (CO2) (counterpart of waiwera_tpu/eos/wsge.py and
eos_wsge.F90, eos_wsae.F90, eos_wsce.F90).

Four primary variables [P, T|S_v, X_salt|S_solid, Pg], three phases,
three components (water, salt, gas). The wse salt machinery with the
wge gas machinery: the water partial pressure Pw = P - Pg drives the
brine saturation line (eos_wsge.F90:625-671), gas dissolves in brine by
Henry's law with the salting-out correction, and the vapour is a
steam(Pw) + gas(Pg) mixture.
"""

from __future__ import annotations

import numpy as np
import torch

from waiwera_tpu_torch.eos.wse import (
    _SMALL,
    EOSWaterSaltEnergy,
    by_phase,
    halite,
    water_region,
)
from waiwera_tpu_torch.physics.state import FluidState
from waiwera_tpu_torch.tensors import clip, maximum
from waiwera_tpu_torch.thermo import ncg as ncg_mod
from waiwera_tpu_torch.thermo import salt as salt_mod


def _water_pressure(var):
    """P - clip(Pg, 0, P) of rows of primaries."""
    return var[:, 0] - clip(var[:, 3], 0.0, var[:, 0])


class EOSWaterSaltGasEnergy(EOSWaterSaltEnergy):
    name = "wsge"
    description = "Water, salt, non-condensible gas and energy"
    num_primary_variables = 4
    num_components = 3
    component_names = ("water", "salt", "gas")
    primary_variable_names = (
        "pressure",
        "temperature/vapour_saturation",
        "salt_mass_fraction/solid_saturation",
        "gas partial pressure",
    )
    required_output_fluid_fields = (
        "pressure",
        "temperature",
        "region",
        "vapour_saturation",
        "liquid_salt_mass_fraction",
        "solid_saturation",
        "gas_partial_pressure",
    )
    default_output_fluid_fields = required_output_fluid_fields

    def __init__(self, config, thermo, relperm, capillarity, name="wsge"):
        super().__init__(config, thermo, relperm, capillarity)
        self.name = name
        gas_name = {"wsge": None, "wsae": "air", "wsce": "co2"}[name]
        if gas_name is None:
            eos_cfg = (config or {}).get("eos", {}) or {}
            gas_name = (
                eos_cfg.get("gas", "air") if isinstance(eos_cfg, dict)
                else "air"
            )
        self.gas = ncg_mod.from_name(gas_name)
        self.description = f"Water, salt, {self.gas.name} and energy"
        self.component_names = ("water", "salt", self.gas.name)

        eos_cfg = (config or {}).get("eos", {}) or {}
        if not isinstance(eos_cfg, dict):
            eos_cfg = {}
        scale_cfg = (eos_cfg.get("primary", {}) or {}).get("scale", {}) or {}
        ps = float(scale_cfg.get("pressure", 1.0e6))
        ts = float(scale_cfg.get("temperature", 1.0e2))
        pp_spec = scale_cfg.get("partial_pressure", "adaptive")
        self.adaptive_pp_scale = not isinstance(pp_spec, (int, float))
        pps = float(pp_spec) if not self.adaptive_pp_scale else 1.0e6
        row_sp = [ps, ts, 1.0, pps]
        row_tp = [ps, 1.0, 1.0, pps]
        zero = [1.0, 1.0, 1.0, 1.0]
        self.primary_scale = np.array(
            [row_sp, row_sp, zero, row_tp, row_sp, row_sp, zero, row_tp]
        )
        self.default_primary = np.array([1.0e5, 20.0, 0.0, 0.0])

    # adaptive partial-pressure scaling (eos_wsge.F90:963-1010)
    def scale(self, primary, region):
        scaled = super().scale(primary, region)
        if self.adaptive_pp_scale:
            p = primary[..., 0]
            pp = primary[..., 3] / torch.where(p > 0, p, 1.0)
            scaled = torch.cat([scaled[..., :3], pp[..., None]], dim=-1)
        return scaled

    def unscale(self, scaled, region):
        primary = super().unscale(scaled, region)
        if self.adaptive_pp_scale:
            pg = scaled[..., 3] * primary[..., 0]
            primary = torch.cat([primary[..., :3], pg[..., None]], dim=-1)
        return primary

    def properties(self, primary, region, rock):
        thermo = self.thermo
        gas = self.gas
        p = primary[:, 0]
        pg = clip(primary[:, 3], 0.0, p)
        pw = p - pg
        # temperature: brine saturation line at the water partial
        # pressure (eos_wsge.F90:646-661)
        t, xs, err = self._temperature_and_salt(primary, region, pw)
        sl, sv, ss = self._saturations(primary, region)
        phases = self._phases(region, p, t, ss)

        denom = torch.where(ss < 1.0, 1.0 - ss, 1.0)
        sl_eff = sl / denom
        relperm2 = self.relative_permeability(sl_eff)
        cp_l = self.capillary_pressure(sl_eff, t)

        # gas properties at (Pg, T)
        gd, gh, gerr = gas.properties(pg, t)
        henry = gas.henrys_constant_salt(t, xs)
        esol = gas.energy_solution_salt(t, xs)

        # liquid: brine at total pressure + dissolved gas
        dl, ul, berr = salt_mod.brine_properties(thermo, p, t, xs)
        hl_b = ul + p / torch.where(dl > 0, dl, 1.0)
        xg_l = gas.mass_fraction(pg, t, 0, 0.0, dl, henry)
        h_l = hl_b * (1.0 - xg_l) + (gh + esol) * xg_l
        rho_l = dl
        u_l = h_l - p / torch.where(rho_l > 0, rho_l, 1.0)
        bvisc, bverr = salt_mod.brine_viscosity(thermo, t, p, xs)
        visc_l, verr_l = gas.mixture_viscosity(bvisc, t, pg, xg_l, 0)

        # vapour: steam at Pw + gas at Pg
        dv, uv, ev = thermo.steam_properties(pw, t)
        hv_w = uv + pw / torch.where(dv > 0, dv, 1.0)
        rho_v = dv + gd
        xg_v = gas.mass_fraction(pg, t, 1, gd, dv, henry)
        h_v = hv_w * (1.0 - xg_v) + gh * xg_v
        u_v = h_v - p / torch.where(rho_v > 0, rho_v, 1.0)
        visc_w_v = thermo.phase_viscosity(1, t, p, dv)
        visc_v, verr_v = gas.mixture_viscosity(visc_w_v, t, pg, xg_v, 1)

        # solid halite
        dsol, usol = salt_mod.halite_properties(p, t)
        hsol = usol + p / torch.where(dsol > 0, dsol, 1.0)

        in_l = (phases & 1) > 0
        in_v = (phases & 2) > 0
        in_s = (phases & 4) > 0
        err = err | gerr
        err = err | (in_l & (berr | bverr | verr_l)) | (in_v & (ev | verr_v))

        zero = torch.zeros_like(p)
        one = torch.ones_like(p)
        present = (in_l, in_v, in_s)

        mass_frac = torch.stack(
            [
                torch.stack([1.0 - xs - xg_l, xs, xg_l], dim=-1),
                torch.stack([1.0 - xg_v, zero, xg_v], dim=-1),
                torch.stack([zero, one, zero], dim=-1),
            ],
            dim=1,
        )  # [N, 3, 3]
        present3 = torch.stack(present, dim=-1)

        region32 = region.to(torch.int32)
        fluid = FluidState(
            pressure=p,
            temperature=t,
            region=region32,
            old_region=region32,
            phase_composition=phases,
            permeability_factor=self.permeability_modifier(sl, sv),
            partial_pressure=torch.stack([pw, zero, pg], dim=-1),
            density=by_phase(present, rho_l, rho_v, dsol),
            viscosity=by_phase(present, visc_l, visc_v, zero),
            saturation=torch.stack([sl, sv, ss], dim=-1),
            relative_permeability=by_phase(present, relperm2[:, 0],
                                           relperm2[:, 1], zero),
            capillary_pressure=by_phase(present, cp_l, zero, zero),
            specific_enthalpy=by_phase(present, h_l, h_v, hsol),
            internal_energy=by_phase(present, u_l, u_v, usol),
            mass_fraction=torch.where(present3[:, :, None], mass_frac, 0.0),
        )
        return fluid, err

    # -- transitions (eos_wsge.F90:187-621): the wse transitions with
    # the saturation test on the water partial pressure ---------------

    def transition(self, old_primary, primary, region, old_temperature):
        old_region = region
        wr_old = water_region(old_region)
        hal_old = halite(old_region)
        p = primary[:, 0]
        second = primary[:, 1]
        salt = primary[:, 2]
        pg = clip(primary[:, 3], 0.0, p)
        pw = p - pg

        (to_liquid, to_vapour, interp, ok, sp_temperature, ps_old, sp_err,
         sp_region, salt_i) = self._to_single_phase(
            old_primary, primary, old_region, old_temperature,
            _water_pressure)
        goes_single = to_liquid | to_vapour
        pressure_factor = torch.where(
            to_liquid, torch.full_like(p, 1.0 + _SMALL),
            torch.full_like(p, 1.0 - _SMALL),
        )
        pg_i = clip(interp[:, 3], 0.0, interp[:, 0])
        pw_i = interp[:, 0] - pg_i
        sp_pressure = torch.where(
            ok,
            pressure_factor * pw_i + pg_i,
            pressure_factor * ps_old + pg,
        )
        sp_pg = torch.where(ok, pg_i, pg)
        sp_salt = torch.where(ok, maximum(salt_i, 0.0), salt)

        crossing, psat, bracket, interp_r = self._to_two_phase(
            old_primary, primary, old_region, pw, _water_pressure)
        tp_pressure = torch.where(bracket, interp_r[:, 0], psat + pg)
        tp_salt = torch.where(bracket, interp_r[:, 2], salt)
        tp_pg = torch.where(
            bracket, clip(interp_r[:, 3], 0.0, interp_r[:, 0]), pg
        )
        ss_sp = torch.where(hal_old, clip(salt, 0.0, 1.0),
                            torch.zeros_like(salt))
        tp_sv = torch.where(wr_old == 1, torch.full_like(p, _SMALL),
                            1.0 - ss_sp - _SMALL)
        tp_region = torch.where(hal_old, 8, 4)

        new_region = torch.where(
            goes_single, sp_region,
            torch.where(crossing, tp_region, old_region),
        ).to(torch.int32)
        new_p = torch.where(
            goes_single, sp_pressure, torch.where(crossing, tp_pressure, p)
        )
        new_second = torch.where(
            goes_single, sp_temperature,
            torch.where(crossing, tp_sv, second),
        )
        new_salt = torch.where(
            goes_single, sp_salt, torch.where(crossing, tp_salt, salt)
        )
        new_pg = torch.where(
            goes_single, sp_pg, torch.where(crossing, tp_pg, pg)
        )
        transition = goes_single | crossing
        err = goes_single & sp_err

        # the halite checks at the total pressure, as the JAX package
        # (which inherits them from wse) makes them
        new_salt, new_region, htrans, herr = self._halite_transition(
            new_p, new_second, new_salt, new_region, old_region, new_p)
        new_primary = torch.stack([new_p, new_second, new_salt, new_pg],
                                  dim=-1)
        return new_primary, new_region, transition | htrans, err | herr

    def check_primary_variables(self, primary, region):
        p = primary[:, 0]
        x = primary[:, 1]
        salt = primary[:, 2]
        pg = primary[:, 3]
        hal = halite(region)
        salt_new = torch.where(~hal & (salt < 0.0), 0.0, salt)
        salt_bad = salt_new > 1.0
        pg_max = (1.0 - _SMALL) * torch.clamp_min(p, 0.0)
        pg_new = clip(pg, 0.0, pg_max)
        pw = p - pg_new
        p_bad = (p <= 0.0) | (pw > 100.0e6)
        x_bad = torch.where(
            water_region(region) == 4,
            (x < -1.0) | (x > 2.0),
            (x < 0.0) | (x > 800.0),
        )
        out = torch.stack([p, x, salt_new, pg_new], dim=-1)
        return out, p_bad | x_bad | salt_bad

    def primary_variables(self, fluid: FluidState) -> torch.Tensor:
        second, third = self._second_and_third(fluid)
        return torch.stack(
            [fluid.pressure, second, third, fluid.partial_pressure[:, 2]],
            dim=-1,
        )

    def primary_from_output_fields(self, fields):
        p = np.asarray(fields["pressure"], np.float64)
        pg = np.asarray(fields["gas_partial_pressure"], np.float64)
        second, third, region = self._fields_second_third(fields)
        return np.stack([p, second, third, pg], axis=-1), region
