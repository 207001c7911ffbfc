"""Salt (NaCl) thermodynamics: halite and brine correlations, in
PyTorch (counterpart of waiwera_tpu/thermo/salt.py;
salt_thermodynamics.F90):
- halite solubility (Battistelli 2012 / Driesner 2007) and the
  two-phase solubility on the brine saturation line,
- halite density and internal energy (Driesner 2007),
- brine saturation pressure and temperature (Haas 1976),
- brine density and internal energy (Driesner 2007 T*-scaling),
- brine viscosity (Phillips et al. 1981).

The two root finds (brine saturation temperature, two-phase
solubility) are fixed-iteration Newton loops with finite-difference
derivatives (replacing newton1d, utils.F90:651). Their step, 1e-8
relative, is below f32 resolution, so they compute in f64 whatever the
input dtype and return the input dtype; every other function computes
in the dtype of its input. All are differentiable in forward mode
through every iteration.
"""

from __future__ import annotations

import torch

from waiwera_tpu_torch.tensors import minimum

SALT_MOLECULAR_WEIGHT = 58.443  # g/mol
WATER_MOLECULAR_WEIGHT = 18.0152

_HALITE_DENSITY = (2.1704e3, -2.4599e-1, -9.5797e-5)
_HALITE_ENTHALPY = (-5.615174e5, 8.766380e2, 6.413881e-2, 8.810112e-5)
_HALITE_SOLUBILITY = (
    0.2627980, 3.130833e-2, 2.136495, -9.371763, 3.083588e1,
    -3.959050e1, 1.711302e1,
)
_BRINE_PSAT_A = (0.0, 5.93582e-1, -5.19386, 1.23156)
_BRINE_PSAT_B = (0.0, 1.15420, 1.41254, -1.92476, -1.70717, 1.05390)
_BRINE_VISCOSITY = (1.0, 0.0816, 0.0122, 1.28e-4)

TC_K = 273.15
_FD_INCREMENT = 1e-8


def _poly(coefs, x):
    """sum coefs[k] x^k (utils polynomial)."""
    out = torch.zeros_like(x)
    for c in reversed(coefs):
        out = out * x + c
    return out


def halite_solubility(temperature: torch.Tensor):
    """Equilibrium salt solubility in water against temperature
    (salt_thermodynamics.F90:44-62). Returns (solubility, err)."""
    sol = _poly(_HALITE_SOLUBILITY, temperature * 1e-3)
    err = temperature < 0.0
    return torch.where(err, torch.zeros_like(sol), sol), err


def halite_properties(pressure: torch.Tensor, temperature: torch.Tensor):
    """(density, internal_energy) of halite (Driesner 2007;
    salt_thermodynamics.F90:107-137)."""
    l3, l4, l5 = 5.727e-3, 2.715e-3, 733.4
    pbar = pressure / 1e5
    density0 = _poly(_HALITE_DENSITY, temperature)
    length = l3 + l4 * torch.exp(temperature / l5)
    density = density0 + length * pbar
    h_1bar = _poly(_HALITE_ENTHALPY, temperature)
    enthalpy = h_1bar + 44.14 * (pbar - 1.0)
    return density, enthalpy - pressure / density


def salt_mole_fraction(xs: torch.Tensor) -> torch.Tensor:
    return 1e3 * xs / (SALT_MOLECULAR_WEIGHT * (1.0 - xs))


def brine_saturation_pressure(thermo, temperature: torch.Tensor,
                              xs: torch.Tensor):
    """Brine saturation pressure (Haas 1976;
    salt_thermodynamics.F90:152-176). Returns (pressure, err)."""
    smol = salt_mole_fraction(xs)
    a = 1.0 + 1e-5 * _poly(_BRINE_PSAT_A, smol)
    b = 1e-5 * _poly(_BRINE_PSAT_B, 0.1 * smol)
    tk = temperature + TC_K
    t_eff = torch.exp(torch.log(tk) / (a + b * tk)) - TC_K
    return thermo.saturation_pressure(t_eff)


def _fd_newton(f, t, err, iterations):
    """`iterations` Newton steps on f(t) = (value, err) with a forward
    finite-difference derivative (salt_thermodynamics.F90 newton1d)."""
    inc = _FD_INCREMENT
    for _ in range(iterations):
        f0, e0 = f(t)
        f1, _ = f(t * (1.0 + inc) + inc)
        df = (f1 - f0) / (t * inc + inc)
        ok = torch.abs(df) > 1e-300
        dt = torch.where(ok, -f0 / torch.where(ok, df, 1.0), 0.0)
        t = t + dt
        err = err | e0
    return t, err


def brine_saturation_temperature(thermo, pressure: torch.Tensor,
                                 xs: torch.Tensor, iterations: int = 8):
    """Invert brine_saturation_pressure for the temperature by Newton
    iteration from the pure-water saturation temperature
    (salt_thermodynamics.F90:181-219). Computed in f64. Returns
    (temperature, err)."""
    dtype = pressure.dtype
    pressure = pressure.to(torch.float64)
    xs = xs.to(torch.float64)
    t, err = thermo.saturation_temperature(pressure)

    def f(tt):
        ps, e = brine_saturation_pressure(thermo, tt, xs)
        return pressure - ps, e

    t, err = _fd_newton(f, t, err, iterations)
    return t.to(dtype), err


def halite_solubility_two_phase(thermo, pressure: torch.Tensor,
                                iterations: int = 6):
    """Salt solubility on the brine saturation line against total
    pressure (salt_thermodynamics.F90:66-104), as the JAX package
    reformulates it: Newton on the temperature T with
    P = P_brine_sat(T, solubility(T)), then solubility(T). Computed in
    f64. Returns (solubility, err)."""
    dtype = pressure.dtype
    pressure = pressure.to(torch.float64)
    t, err = thermo.saturation_temperature(pressure)

    def f(tt):
        sol, e1 = halite_solubility(tt)
        ps, e2 = brine_saturation_pressure(thermo, tt, sol)
        return pressure - ps, e1 | e2

    t, err = _fd_newton(f, t, err, iterations)
    xs, serr = halite_solubility(t)
    return xs.to(dtype), err | serr


def brine_properties(thermo, pressure: torch.Tensor,
                     temperature: torch.Tensor, xs: torch.Tensor):
    """(density, internal_energy, err) of brine (Driesner 2007
    T*-scaling; salt_thermodynamics.F90:222-310)."""
    pbar = pressure / 1e5
    f = 1.0 / (xs + (1.0 - xs) * SALT_MOLECULAR_WEIGHT
               / WATER_MOLECULAR_WEIGHT)
    xmol = xs * f
    xmol1 = 1.0 - xmol
    xmol12 = xmol1 * xmol1
    brine_mw = SALT_MOLECULAR_WEIGHT * f

    # density T*_V (eq. 9-13)
    n11 = -54.2958 - 45.7623 * torch.exp(-9.44785e-4 * pbar)
    n21 = -2.6142 - 0.000239092 * pbar
    n22 = _poly((0.0356828, 4.37235e-3, 2.0566e-3), pbar / 1e3)
    sq = torch.sqrt(pbar)
    n1x1 = _poly((0.0, 8.17193, -2.47556e-4, 3.45052e-4), pbar / 1e2) + (
        330.47 + 0.942876 * sq
    )
    n2x1 = _poly((0.0, 5.42049e-1, 5.84709e-1, -5.99373e-1), pbar / 1e4) + (
        -0.0370751 + 0.00237723 * sq
    )
    n10 = n1x1
    n20 = 1.0 - n21 * torch.sqrt(n22)
    n12 = -n11 - n10
    n23 = n2x1 - n20 - n21 * torch.sqrt(1.0 + n22)
    n1 = n10 + n11 * xmol1 + n12 * xmol12
    n2 = n20 + n21 * torch.sqrt(xmol + n22) + n23 * xmol

    # deviation (eq. 14)
    pp = pbar + 472.051
    n300 = 7.60664e6 / (pp * pp)
    n301 = -50.0 - 86.1446 * torch.exp(-6.21128e-4 * pbar)
    n302 = 294.318 * torch.exp(-5.66735e-3 * pbar)
    n310 = -0.0732761 * torch.exp(-2.3772e-3 * pbar) - 5.2948e-5 * pbar
    n311 = -47.2747 + 24.3653 * torch.exp(-1.25533e-3 * pbar)
    n312 = -0.278529 - 0.00081381 * pbar
    n30 = n300 * (torch.exp(n301 * xmol) - 1.0) + n302 * xmol
    n31 = n310 * torch.exp(n311 * xmol) + n312 * xmol
    deviation = n30 * torch.exp(n31 * temperature)

    tstar_v = n1 + n2 * temperature + deviation

    ts, ts_err = thermo.saturation_temperature(
        minimum(pressure, 0.99 * 22.064e6)
    )
    extrapolate = (pressure <= 22.064e6) & (tstar_v > ts) & ~ts_err

    # normal branch: water density at (P, T*_V)
    t_in = torch.where(extrapolate, ts, tstar_v)
    dw, _, werr = thermo.water_properties(pressure, t_in)
    density_normal = dw * brine_mw / WATER_MOLECULAR_WEIGHT

    # extrapolation branch (eq. 17)
    dt = 0.2
    dws, _, e1 = thermo.water_properties(pressure, ts)
    dws1, _, e2 = thermo.water_properties(pressure, ts - dt)
    vws = 1e3 * WATER_MOLECULAR_WEIGHT / dws
    vws1 = 1e3 * WATER_MOLECULAR_WEIGHT / dws1
    dvdt = (vws - vws1) / dt
    logp = torch.log(pbar)
    o2 = _poly(
        (0.0, -1.17748e-7, 7.58009e-8), logp
    ) + 2.0125e-7 + 3.29977e-9 * torch.exp(-4.31279 * logp)
    ts2 = ts * ts
    o1 = dvdt - 3.0 * o2 * ts2
    o0 = vws - ts * (o1 + o2 * ts2)
    vb = o0 + o1 * tstar_v + o2 * tstar_v ** 3
    density_extrap = 1e3 * brine_mw / vb

    density = torch.where(extrapolate, density_extrap, density_normal)
    err = werr | (extrapolate & (e1 | e2))

    # internal energy T*_h (eq. 21-23)
    q11 = -32.1724 + 0.0621255 * pbar
    q21 = _poly((-1.69513, -4.52781, -6.04279), pbar / 1e4)
    q22 = 0.0612567 + 1.88082e-5 * pbar
    q1x1 = _poly((47.9048, -9.36994, 6.51059), pbar / 1e3)
    q2x1 = _poly((0.241022, 3.45087e-1, -4.28356e-1), pbar / 1e4)
    q10 = q1x1
    q20 = 1.0 - q21 * torch.sqrt(q22)
    q12 = -q11 - q10
    q23 = q2x1 - q20 - q21 * torch.sqrt(1.0 + q22)
    q1 = q10 + q11 * xmol1 + q12 * xmol12
    q2 = q20 + q21 * torch.sqrt(xmol + q22) + q23 * xmol
    tstar_h = q1 + q2 * temperature
    dwh, uwh, herr = thermo.water_properties(pressure, tstar_h)
    hb = uwh + pressure / dwh
    internal_energy = hb - pressure / density
    return density, internal_energy, err | herr


def brine_viscosity(thermo, temperature: torch.Tensor,
                    pressure: torch.Tensor, xs: torch.Tensor):
    """Brine viscosity (Phillips et al. 1981;
    salt_thermodynamics.F90:396-427). Returns (viscosity, err)."""
    smol = salt_mole_fraction(xs)
    factor = _poly(_BRINE_VISCOSITY, smol) + 6.29e-4 * temperature * (
        1.0 - torch.exp(-0.7 * smol)
    )
    dw, _, err = thermo.water_properties(pressure, temperature)
    visc_w = thermo.phase_viscosity(0, temperature, pressure, dw)
    return factor * visc_w, err
