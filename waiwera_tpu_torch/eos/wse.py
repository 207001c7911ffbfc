"""Water + salt (NaCl) + energy EOS "wse" (counterpart of
waiwera_tpu/eos/wse.py and eos_wse.F90).

Three primary variables [P, T|S_v, X_salt|S_solid], three phases
(liquid brine, vapour, solid halite) of which two are mobile, two
components (water, salt). Mixture regions 1..8 map to a water region
[1, 2, -, 4, 1, 2, -, 4], with halite present in regions 5, 6 and 8
(eos_wse.F90:133-136). Halite precipitation and dissolution switch the
third primary variable between the liquid salt mass fraction and the
solid saturation (eos_wse_halite_transition, :412-530), and an optional
permeability modifier (power law, Verma-Pruess; fluid.F90:121-150)
models the permeability lost to precipitation.

Transitions are where cascades over the region index, with
fixed-iteration root finds in place of the reference's interpolator and
root finder, as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from waiwera_tpu_torch.eos.base import EOS, bisect, interpolation_fraction
from waiwera_tpu_torch.physics.state import FluidState
from waiwera_tpu_torch.tensors import clip, index_on, maximum
from waiwera_tpu_torch.thermo import salt as salt_mod

_SMALL = 1e-6
_BISECTION_STEPS = 40

# region 1..8 -> water region / halite presence (eos_wse.F90:133-136)
WATER_REGION = np.array([0, 1, 2, 0, 4, 1, 2, 0, 4], np.int32)  # [region]
HALITE = np.array(
    [False, False, False, False, False, True, True, False, True]
)
_HALITE_INDEX = HALITE.astype(np.int64)


class PermeabilityModifier:
    """Null modifier (factor 1)."""

    def __call__(self, sl, sv):
        return torch.ones_like(sl)


class PowerLawModifier(PermeabilityModifier):
    """factor = (sl + sv)^exponent (fluid.F90 power modifier)."""

    def __init__(self, cfg):
        self.exponent = float((cfg or {}).get("exponent", 3.0))

    def __call__(self, sl, sv):
        return (sl + sv) ** self.exponent


class VermaPruessModifier(PermeabilityModifier):
    """Verma & Pruess (1988) fracture/tube permeability reduction."""

    def __init__(self, cfg):
        cfg = cfg or {}
        self.exponent = float(cfg.get("exponent", 2.0))
        self.phir = float(cfg.get("phir", 0.1))
        self.gamma = float(cfg.get("gamma", 0.7))
        self.omega = 1.0 + 1.0 / (self.gamma * (1.0 / self.phir - 1.0))

    def __call__(self, sl, sv):
        pf = sl + sv
        theta = maximum((pf - self.phir) / (1.0 - self.phir), 1e-10)
        e = self.exponent
        num = 1.0 - self.gamma + self.gamma / self.omega ** e
        den = 1.0 - self.gamma + self.gamma * (
            theta / (theta + self.omega - 1.0)
        ) ** e
        return theta ** e * num / den


def water_region(region: torch.Tensor) -> torch.Tensor:
    """Water region (1, 2 or 4) of each mixture region, int64."""
    return index_on(WATER_REGION, region.device)[region.long()]


def halite(region: torch.Tensor) -> torch.Tensor:
    """Whether halite is present in each mixture region."""
    return index_on(_HALITE_INDEX, region.device)[region.long()] > 0


def by_phase(present, liquid, vapour, solid):
    """[N, 3] per-phase values, 0 where a phase is absent; present is
    (in_liquid, in_vapour, in_solid)."""
    return torch.stack([torch.where(m, v, 0.0) for m, v in
                        zip(present, (liquid, vapour, solid))], dim=-1)


class EOSWaterSaltEnergy(EOS):
    name = "wse"
    description = "Water, salt and energy"
    num_primary_variables = 3
    num_phases = 3
    num_mobile_phases = 2
    num_components = 2
    phase_names = ("liquid", "vapour", "solid")
    component_names = ("water", "salt")
    primary_variable_names = (
        "pressure",
        "temperature/vapour_saturation",
        "salt_mass_fraction/solid_saturation",
    )
    default_region = 1
    default_tracer_phase = "liquid"
    isothermal = False
    required_output_fluid_fields = (
        "pressure",
        "temperature",
        "region",
        "vapour_saturation",
        "liquid_salt_mass_fraction",
        "solid_saturation",
    )
    default_output_fluid_fields = required_output_fluid_fields

    def __init__(self, config, thermo, relperm, capillarity):
        super().__init__(thermo, relperm, capillarity)
        eos_cfg = (config or {}).get("eos", {}) or {}
        if not isinstance(eos_cfg, dict):
            eos_cfg = {}
        scale_cfg = (eos_cfg.get("primary", {}) or {}).get("scale", {}) or {}
        ps = float(scale_cfg.get("pressure", 1.0e6))
        ts = float(scale_cfg.get("temperature", 1.0e2))
        row_sp = [ps, ts, 1.0]
        row_tp = [ps, 1.0, 1.0]
        zero = [1.0, 1.0, 1.0]
        self.primary_scale = np.array(
            [row_sp, row_sp, zero, row_tp, row_sp, row_sp, zero, row_tp]
        )
        self.default_primary = np.array([1.0e5, 20.0, 0.0])

        pm_cfg = eos_cfg.get("permeability_modifier", {}) or {}
        pm_type = str(pm_cfg.get("type", "none")).lower()
        if pm_type == "power":
            self.permeability_modifier = PowerLawModifier(pm_cfg)
        elif pm_type in ("verma-pruess", "verma_pruess"):
            self.permeability_modifier = VermaPruessModifier(pm_cfg)
        else:
            self.permeability_modifier = PermeabilityModifier()

    # -- helpers ------------------------------------------------------

    def _saturations(self, primary, region):
        """(sl, sv, ss) (eos_wse_phase_saturations)."""
        wr = water_region(region)
        hal = halite(region)
        zero = torch.zeros_like(primary[:, 0])
        ss = torch.where(hal | (region == 2), clip(primary[:, 2], 0.0, 1.0),
                         zero)
        fluid_sat = 1.0 - ss
        sv = torch.where(
            wr == 4, primary[:, 1], torch.where(wr == 2, fluid_sat, zero)
        )
        sl = torch.where(
            wr == 1, fluid_sat, torch.where(wr == 4, fluid_sat - sv, zero)
        )
        return sl, sv, ss

    def phase_saturations(self, primary, region):
        return torch.stack(self._saturations(primary, region), dim=-1)

    def _temperature_and_salt(self, primary, region, pw):
        """Temperature and liquid salt mass fraction, with their error
        flags (eos_wse_bulk/phase_properties). Two-phase cells lie on
        the brine saturation line at the water pressure pw; the liquid
        salt mass fraction is the primary in regions 1 and 4, the
        solubility in regions with halite (region 8 at its two-phase
        value) and 0 in region 2."""
        thermo = self.thermo
        hal = halite(region)
        two_phase = water_region(region) == 4
        salt = clip(primary[:, 2], 0.0, 1.0)
        zero = torch.zeros_like(salt)
        xs_tp, err_tp = salt_mod.halite_solubility_two_phase(thermo, pw)
        xs_guess = torch.where(two_phase, torch.where(hal, xs_tp, salt),
                               zero)
        t_brine, terr = salt_mod.brine_saturation_temperature(
            thermo, pw, xs_guess
        )
        t = torch.where(two_phase, t_brine, primary[:, 1])
        err = two_phase & (terr | (hal & err_tp))

        xs_sol, serr = salt_mod.halite_solubility(t)
        xs = torch.where(hal, xs_sol, torch.where(region == 2, zero, salt))
        return t, xs, err | (hal & serr)

    def _phases(self, region, p, t, ss):
        """Phase bitmask: the water region's phases, plus bit 2 where
        solid halite is present."""
        phases_w = self.thermo.phase_composition(water_region(region), p, t)
        solid = (halite(region) | (region == 2)) & (ss > 0.0)
        return phases_w | torch.where(solid, 4, 0).to(torch.int32)

    def properties(self, primary, region, rock):
        thermo = self.thermo
        p = primary[:, 0]
        t, xs, err = self._temperature_and_salt(primary, region, p)
        sl, sv, ss = self._saturations(primary, region)
        phases = self._phases(region, p, t, ss)

        denom = torch.where(ss < 1.0, 1.0 - ss, 1.0)
        sl_eff = sl / denom
        relperm2 = self.relative_permeability(sl_eff)
        cp_l = self.capillary_pressure(sl_eff, t)

        # liquid brine
        dl, ul, berr = salt_mod.brine_properties(thermo, p, t, xs)
        hl = ul + p / torch.where(dl > 0, dl, 1.0)
        visc_l, verr_l = salt_mod.brine_viscosity(thermo, t, p, xs)
        # vapour: pure steam
        dv, uv, ev = thermo.steam_properties(p, t)
        hv = uv + p / torch.where(dv > 0, dv, 1.0)
        visc_v = thermo.phase_viscosity(1, t, p, dv)
        # solid halite
        dsol, usol = salt_mod.halite_properties(p, t)
        hsol = usol + p / torch.where(dsol > 0, dsol, 1.0)

        in_l = (phases & 1) > 0
        in_v = (phases & 2) > 0
        in_s = (phases & 4) > 0
        err = err | (in_l & (berr | verr_l)) | (in_v & ev)

        zero = torch.zeros_like(p)
        one = torch.ones_like(p)
        present = (in_l, in_v, in_s)

        mass_frac = torch.stack(
            [
                torch.stack([1.0 - xs, xs], dim=-1),
                torch.stack([one, zero], dim=-1),
                torch.stack([zero, one], dim=-1),
            ],
            dim=1,
        )  # [N, 3, 2]
        present3 = torch.stack(present, dim=-1)

        region32 = region.to(torch.int32)
        fluid = FluidState(
            pressure=p,
            temperature=t,
            region=region32,
            old_region=region32,
            phase_composition=phases,
            permeability_factor=self.permeability_modifier(sl, sv),
            partial_pressure=torch.stack([p, zero], dim=-1),
            density=by_phase(present, dl, dv, dsol),
            viscosity=by_phase(present, visc_l, visc_v, zero),
            saturation=torch.stack([sl, sv, ss], dim=-1),
            relative_permeability=by_phase(present, relperm2[:, 0],
                                           relperm2[:, 1], zero),
            capillary_pressure=by_phase(present, cp_l, zero, zero),
            specific_enthalpy=by_phase(present, hl, hv, hsol),
            internal_energy=by_phase(present, ul, uv, usol),
            mass_fraction=torch.where(present3[:, :, None], mass_frac, 0.0),
        )
        return fluid, err

    # -- transitions (eos_wse_transition, :545-616) -------------------

    def _to_single_phase(self, old_primary, primary, region,
                         old_temperature, water_pressure):
        """Two-phase -> single-phase: (to_liquid, to_vapour, interp,
        ok, sp_temperature, ps_old, sp_err, sp_region) where interp is
        the Newton path at the saturation bound, water_pressure(var) the
        water pressure of a row of primaries and ps_old the old
        temperature's saturation pressure (the fallback)."""
        thermo = self.thermo
        wr_old = water_region(region)
        hal_old = halite(region)
        salt = primary[:, 2]
        second = primary[:, 1]
        ss_tp = torch.where(hal_old, clip(salt, 0.0, 1.0),
                            torch.zeros_like(salt))
        to_liquid = (wr_old == 4) & (second < 0.0)
        to_vapour = (wr_old == 4) & (second > 1.0 - ss_tp)
        bound = torch.where(to_liquid, torch.zeros_like(salt), 1.0 - ss_tp)
        xi = interpolation_fraction(bound, old_primary[:, 1], second)
        xi_ok = (xi >= 0.0) & (xi <= 1.0)
        interp = old_primary + clip(xi, 0.0, 1.0)[:, None] * (
            primary - old_primary
        )
        pw_i = water_pressure(interp)
        salt_i = clip(interp[:, 2], 0.0, 1.0)
        # liquid: brine saturation temperature at the interpolated
        # water pressure
        xs_tp2, e_tp = salt_mod.halite_solubility_two_phase(thermo, pw_i)
        xs_i = torch.where(hal_old, xs_tp2, salt_i)
        t_liq, e_liq = salt_mod.brine_saturation_temperature(
            thermo, pw_i, xs_i
        )
        t_vap, e_vap = thermo.saturation_temperature(pw_i)
        t_interp = torch.where(to_liquid, t_liq, t_vap)
        interp_err = torch.where(to_liquid, e_liq | (hal_old & e_tp), e_vap)
        ok = xi_ok & ~interp_err
        # fallback from the old state
        xs_sol_old, e_sol = salt_mod.halite_solubility(old_temperature)
        xs_old = clip(
            torch.where(hal_old, xs_sol_old, old_primary[:, 2]), 0.0, 1.0
        )
        ps_brine_old, e_pb = salt_mod.brine_saturation_pressure(
            thermo, old_temperature, xs_old
        )
        ps_w_old, e_pw = thermo.saturation_pressure(old_temperature)
        ps_old = torch.where(to_liquid, ps_brine_old, ps_w_old)
        fb_err = torch.where(to_liquid, e_pb | (hal_old & e_sol), e_pw)

        sp_temperature = torch.where(ok, t_interp, old_temperature)
        sp_err = ~ok & fb_err
        offset = torch.where(hal_old, 4, 0)
        sp_region = torch.where(to_liquid, offset + 1, offset + 2)
        return (to_liquid, to_vapour, interp, ok, sp_temperature, ps_old,
                sp_err, sp_region, salt_i)

    def _to_two_phase(self, old_primary, primary, region, pw,
                      water_pressure):
        """Single-phase -> two-phase: (crossing, psat, bracket, interp_r)
        with interp_r the Newton path at the saturation line found by
        bisection (saturation_line_finder; eos_wse.F90:920-960)."""
        thermo = self.thermo
        wr_old = water_region(region)
        hal_old = halite(region)
        salt = primary[:, 2]
        single = (wr_old == 1) | (wr_old == 2)
        t_sp = primary[:, 1]
        xs_sol_t, e_sol_t = salt_mod.halite_solubility(t_sp)
        xs_sp = clip(
            torch.where(hal_old, xs_sol_t, maximum(salt, 0.0)), 0.0, 1.0
        )
        ps_brine, e_psb = salt_mod.brine_saturation_pressure(
            thermo, t_sp, xs_sp
        )
        ps_w, e_psw = thermo.saturation_pressure(t_sp)
        psat = torch.where(wr_old == 1, ps_brine, ps_w)
        psat_err = torch.where(wr_old == 1, e_psb | (hal_old & e_sol_t),
                               e_psw)
        crossing = single & ~psat_err & (
            ((wr_old == 1) & (pw < psat)) | ((wr_old == 2) & (pw > psat))
        )

        dvec = primary - old_primary

        def f_of(x):
            var = old_primary + x[:, None] * dvec
            tt = var[:, 1]
            xs_x, _ = salt_mod.halite_solubility(tt)
            xs_line = clip(
                torch.where(hal_old, xs_x, maximum(var[:, 2], 0.0)),
                0.0, 1.0,
            )
            psb, _ = salt_mod.brine_saturation_pressure(thermo, tt, xs_line)
            psw, _ = thermo.saturation_pressure(tt)
            ps = torch.where(wr_old == 1, psb, psw)
            return water_pressure(var) - ps

        like = primary[:, 0]
        f0 = f_of(torch.zeros_like(like))
        f1 = f_of(torch.ones_like(like))
        bracket = f0 * f1 < 0.0
        x_root = bisect(f_of, f0, like, _BISECTION_STEPS)
        interp_r = old_primary + x_root[:, None] * dvec
        return crossing, psat, bracket, interp_r

    def transition(self, old_primary, primary, region, old_temperature):
        old_region = region
        wr_old = water_region(old_region)
        hal_old = halite(old_region)
        p = primary[:, 0]
        second = primary[:, 1]
        salt = primary[:, 2]

        (to_liquid, to_vapour, interp, ok, sp_temperature, ps_old, sp_err,
         sp_region, salt_i) = self._to_single_phase(
            old_primary, primary, old_region, old_temperature,
            lambda var: var[:, 0])
        goes_single = to_liquid | to_vapour
        pressure_factor = torch.where(
            to_liquid, torch.full_like(p, 1.0 + _SMALL),
            torch.full_like(p, 1.0 - _SMALL),
        )
        sp_pressure = torch.where(
            ok, pressure_factor * interp[:, 0], pressure_factor * ps_old
        )
        sp_salt = torch.where(ok, maximum(salt_i, 0.0), salt)

        crossing, psat, bracket, interp_r = self._to_two_phase(
            old_primary, primary, old_region, p, lambda var: var[:, 0])
        tp_pressure = torch.where(bracket, interp_r[:, 0], psat)
        tp_salt = torch.where(bracket, interp_r[:, 2], salt)
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
        transition = goes_single | crossing
        err = goes_single & sp_err

        new_salt, new_region, htrans, herr = self._halite_transition(
            new_p, new_second, new_salt, new_region, old_region, new_p)
        new_primary = torch.stack([new_p, new_second, new_salt], dim=-1)
        return new_primary, new_region, transition | htrans, err | herr

    def _halite_transition(self, p, second, salt, region, old_region, pw):
        """Halite precipitation and dissolution (:412-530) at the
        (possibly transitioned) state. Returns (salt, region,
        transition, err)."""
        thermo = self.thermo
        # temperature for the solubility checks
        xs_for_t = clip(salt, 0.0, 1.0)
        t_b, e_tb = salt_mod.brine_saturation_temperature(thermo, pw,
                                                          xs_for_t)
        t_check = torch.where(region == 4, t_b, second)

        sol, e_sol = salt_mod.halite_solubility(t_check)
        sol_tp, e_tp = salt_mod.halite_solubility_two_phase(thermo, pw)

        # regions 1 and 4: liquid without halite -> precipitation
        liq_noh = (region == 1) | (region == 4)
        precip_l = liq_noh & (salt > sol) & ~(
            (region == 4) & e_tb
        ) & ~e_sol
        # region 2: vapour only without halite -> any salt precipitates
        precip_v = (region == 2) & (salt > 0.0)
        # regions 5 and 8: halite with liquid -> dissolution when Ss < 0
        dis_l = ((region == 5) | (region == 8)) & (salt < 0.0)
        from_dry = old_region == 6
        xs_dis = torch.where(
            region == 5,
            sol - _SMALL,
            torch.where(from_dry, torch.full_like(sol, _SMALL),
                        sol_tp - _SMALL),
        )
        # region 6: vapour with halite -> halite gone when Ss < 0
        dis_v = (region == 6) & (salt < 0.0)

        new_salt = torch.where(precip_l | precip_v,
                               torch.full_like(salt, _SMALL), salt)
        new_region = torch.where(
            precip_l, region + 4, torch.where(precip_v, 6, region)
        )
        new_salt = torch.where(dis_l, xs_dis, new_salt)
        new_region = torch.where(dis_l, region - 4, new_region)
        new_salt = torch.where(dis_v, torch.zeros_like(salt), new_salt)
        new_region = torch.where(dis_v, 2, new_region)
        trans = precip_l | precip_v | dis_l | dis_v
        err = dis_l & (region == 8) & ~from_dry & e_tp
        return new_salt, new_region.to(torch.int32), trans, err

    def check_primary_variables(self, primary, region):
        """eos_wse_check_primary_variables: negative salt in regions
        without halite is clamped to 0 (the halite transition handles
        the others); bounds on P, T|S_v and the salt."""
        p = primary[:, 0]
        x = primary[:, 1]
        salt = primary[:, 2]
        hal = halite(region)
        salt_new = torch.where(~hal & (salt < 0.0), 0.0, salt)
        salt_bad = salt_new > 1.0
        p_bad = (p < 0.0) | (p > 100.0e6)
        x_bad = torch.where(
            water_region(region) == 4,
            (x < -1.0) | (x > 2.0),
            (x < 0.0) | (x > 800.0),
        )
        out = torch.stack([p, x, salt_new], dim=-1)
        return out, p_bad | x_bad | salt_bad

    def _second_and_third(self, fluid: FluidState):
        second = torch.where(
            water_region(fluid.region) == 4, fluid.saturation[:, 1],
            fluid.temperature,
        )
        third = torch.where(
            halite(fluid.region), fluid.saturation[:, 2],
            fluid.mass_fraction[:, 0, 1],
        )
        return second, third

    def primary_variables(self, fluid: FluidState) -> torch.Tensor:
        second, third = self._second_and_third(fluid)
        return torch.stack([fluid.pressure, second, third], dim=-1)

    @staticmethod
    def _fields_second_third(fields):
        t = np.asarray(fields["temperature"], np.float64)
        sv = np.asarray(fields["vapour_saturation"], np.float64)
        xs = np.asarray(fields["liquid_salt_mass_fraction"], np.float64)
        ss = np.asarray(fields["solid_saturation"], np.float64)
        region = np.asarray(fields["region"], np.int32)
        second = np.where(WATER_REGION[region] == 4, sv, t)
        third = np.where(HALITE[region], ss, xs)
        return second, third, region

    def primary_from_output_fields(self, fields):
        p = np.asarray(fields["pressure"], np.float64)
        second, third, region = self._fields_second_third(fields)
        return np.stack([p, second, third], axis=-1), region
