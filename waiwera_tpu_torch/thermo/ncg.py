"""Non-condensible gas (NCG) thermodynamics: air and CO2 (counterpart
of waiwera_tpu/thermo/ncg.py).

Air follows ncg_air_thermodynamics.F90: real-gas law density, Irvine &
Liley enthalpy, two-constituent (N2 + O2) Henry's law and the
kinetic-theory vapour mixture viscosity. CO2 follows
ncg_co2_thermodynamics.F90 (O'Sullivan et al. correlations, a viscosity
table in the partial pressure). Both have the salting-out variants of
Henry's law that the salt EOS use.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from waiwera_tpu_torch.thermo.base import (
    GAS_CONSTANT,
    TC_K,
    TTRIPLE,
    WATER_MOLECULAR_WEIGHT,
)
from waiwera_tpu_torch.thermo.salt import salt_mole_fraction
from waiwera_tpu_torch.utils.interpolation import InterpolationTable

_TSCALE = 100.0


def _poly(coefs, x: torch.Tensor) -> torch.Tensor:
    """Horner evaluation of sum_k coefs[k] x^k for 1-D coefs."""
    coefs = [float(c) for c in coefs]
    p = torch.zeros_like(x) + coefs[-1]
    for c in coefs[-2::-1]:
        p = p * x + c
    return p


def _poly_deriv(coefs) -> np.ndarray:
    c = np.asarray(coefs, dtype=np.float64)
    return c[1:] * np.arange(1, len(c))


class NCG:
    """Common NCG behaviour (ncg_thermodynamics.F90)."""

    name: str = "abstract"
    molecular_weight: float = 0.0
    deviation_factor: float = 1.0

    def mole_to_mass_fraction(self, xmole):
        w = xmole * self.molecular_weight
        return w / (w + (1.0 - xmole) * WATER_MOLECULAR_WEIGHT)

    def mass_to_mole_fraction(self, xg):
        w = xg / self.molecular_weight
        return w / (w + (1.0 - xg) / WATER_MOLECULAR_WEIGHT)

    def energy_solution(self, t):
        """Energy of solution from d(ln H)/dT
        (ncg_thermodynamics.F90:148-162)."""
        dlnh = self.henrys_derivative(t)
        tk = t + TC_K
        return -1.0e3 * GAS_CONSTANT * tk * tk * dlnh / self.molecular_weight

    def henrys_constant_salt(self, t, xs):
        """Henry's constant with salting-out correction
        (ncg_*_henrys_constant_salt): H_salt = H0 * 10^(m kb(T))."""
        raise NotImplementedError

    def henrys_derivative_salt(self, t, xs):
        raise NotImplementedError

    def partial_pressure_of(self, t, total_density, xg):
        """Partial pressure (Pa) of the gas of mass fraction xg in fluid
        of total density total_density at t (deg C), by the real-gas
        law."""
        tk = t + TC_K
        gas_density = total_density * xg
        return (gas_density / self.molecular_weight
                * (1.0e3 * GAS_CONSTANT * self.deviation_factor * tk))

    def energy_solution_salt(self, t, xs):
        """Energy of solution in brine (ncg_energy_solution_salt)."""
        dlnh = self.henrys_derivative_salt(t, xs)
        tk = t + TC_K
        return -1.0e3 * GAS_CONSTANT * tk * tk * dlnh / self.molecular_weight

    def mass_fraction(self, partial_pressure, t, phase, gas_density,
                      water_density, henrys_constant):
        """NCG mass fraction in the given phase
        (ncg_thermodynamics.F90:287-317)."""
        if phase == 0:  # liquid: Henry's law
            xmole = partial_pressure / torch.clamp_min(henrys_constant, 1e-30)
            return self.mole_to_mass_fraction(xmole)
        total = gas_density + water_density
        return torch.where(
            total > 1e-30,
            gas_density / torch.where(total > 0, total, 1.0),
            0.0,
        )


class AirNCG(NCG):
    """Air (ncg_air_thermodynamics.F90)."""

    name = "air"
    molecular_weight = 28.96

    _ENTHALPY = np.array([1.20740, 9.24502, 0.115984, -5.63568e-4])
    _WEIGHT = (0.79, 0.21)
    _HENRY_P0 = (1.01325e5, 1.0e5)
    _HENRY = np.array([
        [0.513726, 1.58603, -5.9378e-1, -6.98282e-1, 5.10330e-1,
         -1.21388e-1, 1.00041e-2],
        [0.26234, 0.610628, 7.00732e-1, -0.139299e1, 7.13850e-1,
         -1.54216e-1, 1.23190e-2],
    ])
    _FAIR = 97.0
    _FWAT = 363.0
    _CAIR = 3.617
    _CWAT = 2.655

    def __init__(self):
        self._fmix = float(np.sqrt(self._FAIR * self._FWAT))
        self._cmix = 0.5 * (self._CAIR + self._CWAT)
        tk0 = (TTRIPLE + TC_K) / _TSCALE
        self._enthalpy_shift = float(np.polyval(self._ENTHALPY[::-1], tk0))
        self._henry_deriv = [_poly_deriv(h) for h in self._HENRY]

    def properties(self, pg, t):
        """(density, enthalpy, err) of the gas at partial pressure pg
        and temperature t."""
        tk = t + TC_K
        density = pg * self.molecular_weight / (
            1.0e3 * GAS_CONSTANT * self.deviation_factor * tk
        )
        enthalpy = 1.0e4 * (
            _poly(self._ENTHALPY, tk / _TSCALE) - self._enthalpy_shift
        )
        err = torch.zeros(pg.shape, dtype=torch.bool, device=pg.device)
        return density, enthalpy, err

    def _constituent_henry(self, t):
        return [
            1.0e5 * p0 * _poly(h, t / _TSCALE)
            for p0, h in zip(self._HENRY_P0, self._HENRY)
        ]

    def henrys_constant(self, t):
        hs = self._constituent_henry(t)
        return sum(w * h for w, h in zip(self._WEIGHT, hs))

    def henrys_derivative(self, t):
        """d(ln H)/dT (ncg_air_thermodynamics.F90:174-199)."""
        hs = self._constituent_henry(t)
        out = 0.0
        for w, p0, dcoef, h in zip(
            self._WEIGHT, self._HENRY_P0, self._henry_deriv, hs
        ):
            dhinv = 1.0e5 * _poly(dcoef, t / _TSCALE)
            out = out + w * p0 * dhinv / (h * _TSCALE)
        return out

    _HENRY_SALT = np.array([
        [0.183369, -0.236905, 0.242438, -7.30134e-2, 8.58723e-3],
        [0.16218, -1.16909e-1, 5.55185e-2, -8.75443e-3, 9.91567e-4],
    ])  # per constituent (N2, O2), ncg_air_thermodynamics.F90:27-34

    def henrys_constant_salt(self, t, xs):
        hs = self._constituent_henry(t)
        m = salt_mole_fraction(xs)
        out = 0.0
        for w, h, kbc in zip(self._WEIGHT, hs, self._HENRY_SALT):
            kb = _poly(kbc, t / _TSCALE)
            out = out + w * h * torch.pow(10.0, m * kb)
        return out

    def henrys_derivative_salt(self, t, xs):
        hs = self._constituent_henry(t)
        m = salt_mole_fraction(xs)
        out = 0.0
        for w, dcoef, h, kbc in zip(self._WEIGHT, self._henry_deriv, hs,
                                    self._HENRY_SALT):
            d0 = 1.0e5 * _poly(dcoef, t / _TSCALE) / (h * _TSCALE)
            dkb = _poly(_poly_deriv(kbc), t / _TSCALE) / _TSCALE
            out = out + w * (d0 + math.log(10.0) * m * dkb)
        return out

    def mixture_viscosity(self, water_visc, t, pg, xg, phase):
        """Hirschfelder et al. kinetic-theory mixture viscosity
        (ncg_air_thermodynamics.F90:260-338). Returns (visc, err)."""
        no_err = torch.zeros(t.shape, dtype=torch.bool, device=t.device)
        if phase == 0:
            return water_visc, no_err
        rm1 = self.molecular_weight
        rm2 = WATER_MOLECULAR_WEIGHT
        x1 = self.mass_to_mole_fraction(xg)
        x2 = 1.0 - x1
        tk = t + TC_K
        trd1 = tk / self._FAIR
        trd3 = tk / self._fmix
        ome1 = (1.188 - 0.051 * trd1) / trd1
        ome3 = (1.48 - 0.412 * torch.log(trd3)) / trd3
        ard = 1.095 / trd3
        rm3 = 2.0 * rm1 * rm2 / (rm1 + rm2)

        def covis(trd, c, ome, rm, f):
            return 266.93e-7 * torch.sqrt(rm * trd * f) / (c * c * ome * trd)

        vis1 = covis(trd1, self._CAIR, ome1, rm1, self._FAIR)
        vis2 = 10.0 * water_visc
        vis3 = covis(trd3, self._cmix, ome3, rm3, self._fmix)
        z1 = x1 * x1 / vis1 + 2.0 * x2 * x1 / vis3 + x2 * x2 / vis2
        g = x1 * x1 * rm1 / rm2
        h = x2 * x2 * rm2 / rm1
        e = (2.0 * x1 * x2 * rm1 * rm2 / (rm3 * rm3)) * vis3 / (vis1 * vis2)
        z2 = 0.6 * ard * (g / vis1 + e + h / vis2)
        z3 = 0.6 * ard * (g + e * (vis1 + vis2) - 2.0 * x1 * x2 + h)
        visc = 0.1 * (1.0 + z3) / (z1 + z2)
        return visc, no_err


class CO2NCG(NCG):
    """CO2 (ncg_co2_thermodynamics.F90): O'Sullivan correlations."""

    name = "CO2"
    molecular_weight = 44.01

    _HENRY = np.array([
        0.783666, 1.96025, 8.20574, -7.40674, 2.18380, -0.220999,
    ])
    # viscosity coefficient table: rows at Pg = 0,10,15,20,30 MPa,
    # columns = polynomial coefficients in T
    _VISC_P = np.array([0.0, 10.0, 15.0, 20.0, 30.0])
    _VISC = np.array([
        [1.3578, 4.9227e-3, -2.9661e-6, 2.8529e-9, -2.1829e-12],
        [3.9189, -35.984e-3, 0.25825e-3, -7.1178e-7, 6.9578e-10],
        [9.6607, -135.479e-3, 0.90087e-3, -2.4727e-6, 2.4156e-9],
        [13.1566, -179.352e-3, 1.12474e-3, -2.98864e-6, 2.85911e-9],
        [14.7968, -160.731e-3, 0.850257e-3, -1.99076e-6, 1.73423e-9],
    ])
    _HENRY_SALT = np.array([
        1.19784e-1, -7.17823e-2, 4.93854e-2, -1.03826e-2, 1.08233e-3,
    ])  # ncg_co2_thermodynamics.F90:18-21

    def __init__(self):
        self._henry_deriv = _poly_deriv(self._HENRY)
        self._henry_salt_deriv = _poly_deriv(self._HENRY_SALT)
        self._visc_table = InterpolationTable(
            np.column_stack([self._VISC_P, self._VISC])
        )

    def properties(self, pg, t):
        """(density, enthalpy, err) from the density and enthalpy
        correlations (ncg_co2_thermodynamics.F90:100-127)."""
        tk = t + TC_K
        pp = pg * 1.0e-6
        tc = (0.01 * tk) ** (10.0 / 3.0)
        hci = (
            1.667
            + 0.001542 * tk
            - 0.7948 * torch.log10(tk)
            - 41.35 / tk
        )
        enthalpy = 1.0e6 * (
            hci - 0.3571 * pp * (1.0 + 0.07576 * pp) / tc
        )
        vc = 0.00018882 * tk - pp * (0.0824 + 0.01249 * pp) / tc
        err = vc <= 0.0
        density = pp / torch.where(err, 1.0, vc)
        density = torch.where(err, 0.0, density)
        return density, enthalpy, err

    def henrys_constant(self, t):
        return 1.0e8 * _poly(self._HENRY, t / _TSCALE)

    def henrys_derivative(self, t):
        h = self.henrys_constant(t)
        return (
            1.0e8 * _poly(self._henry_deriv, t / _TSCALE) / (h * _TSCALE)
        )

    def henrys_constant_salt(self, t, xs):
        m = salt_mole_fraction(xs)
        kb = _poly(self._HENRY_SALT, t / _TSCALE)
        return self.henrys_constant(t) * torch.pow(10.0, m * kb)

    def henrys_derivative_salt(self, t, xs):
        m = salt_mole_fraction(xs)
        dkb = _poly(self._henry_salt_deriv, t / _TSCALE) / _TSCALE
        return self.henrys_derivative(t) + math.log(10.0) * m * dkb

    def gas_viscosity(self, pg, t):
        """(viscosity, err): the coefficient table interpolated in the
        partial pressure (MPa), then a polynomial in t."""
        err = pg > 300.0e5
        coefs = self._visc_table(pg * 1e-6)  # [..., 5]
        v = coefs[..., 4]
        for k in (3, 2, 1, 0):
            v = v * t + coefs[..., k]
        return 1.0e-5 * v, err

    def mixture_viscosity(self, water_visc, t, pg, xg, phase):
        if phase == 0:
            return water_visc, torch.zeros(t.shape, dtype=torch.bool,
                                           device=t.device)
        gv, err = self.gas_viscosity(pg, t)
        return water_visc * (1.0 - xg) + gv * xg, err


def from_name(name: str) -> NCG:
    key = name.strip().lower()
    if key == "air":
        return AirNCG()
    if key == "co2":
        return CO2NCG()
    raise ValueError(f"unknown NCG: {name!r}")
