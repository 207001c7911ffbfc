"""Plain thermodynamics of water and air, in PyTorch, written from the
published formulations and Waiwera's documented choices:

- water: IAPWS-IF97 regions 1 and 2 (Gibbs free energy), the region 4
  saturation line, and the IAPWS 2008 viscosity without its critical
  enhancement (Waiwera's IAPWS.F90 makes the same choices);
- air: ideal-gas density, the Irvine and Liley enthalpy, a Henry's law
  of 79% N2 and 21% O2 and the kinetic-theory viscosity of air and
  water vapour (Waiwera's ncg_air_thermodynamics.F90).

Each function takes tensors of one floating dtype and computes in it:
float64 for the reference, float32 for its control. Temperatures are
in degrees Celsius and pressures in Pa.
"""

from __future__ import annotations

import torch

TC_K = 273.15
R_WATER = 461.526  # J/(kg K), IF97
M_WATER = 18.01528  # g/mol
R_UNIVERSAL = 8.3144598  # J/(mol K)
T_CRIT = 647.096  # K
P_CRIT = 22.064e6
RHO_CRIT = 322.0
P_SAT_MIN = 611.213

# IF97 region 1: (I, J, n)
_R1 = (
    (0, -2, 0.14632971213167), (0, -1, -0.84548187169114),
    (0, 0, -0.37563603672040e1), (0, 1, 0.33855169168385e1),
    (0, 2, -0.95791963387872), (0, 3, 0.15772038513228),
    (0, 4, -0.16616417199501e-1), (0, 5, 0.81214629983568e-3),
    (1, -9, 0.28319080123804e-3), (1, -7, -0.60706301565874e-3),
    (1, -1, -0.18990068218419e-1), (1, 0, -0.32529748770505e-1),
    (1, 1, -0.21841717175414e-1), (1, 3, -0.52838357969930e-4),
    (2, -3, -0.47184321073267e-3), (2, 0, -0.30001780793026e-3),
    (2, 1, 0.47661393906987e-4), (2, 3, -0.44141845330846e-5),
    (2, 17, -0.72694996297594e-15), (3, -4, -0.31679644845054e-4),
    (3, 0, -0.28270797985312e-5), (3, 6, -0.85205128120103e-9),
    (4, -5, -0.22425281908000e-5), (4, -2, -0.65171222895601e-6),
    (4, 10, -0.14341729937924e-12), (5, -8, -0.40516996860117e-6),
    (8, -11, -0.12734301741641e-8), (8, -6, -0.17424871230634e-9),
    (21, -29, -0.68762131295531e-18), (23, -31, 0.14478307828521e-19),
    (29, -38, 0.26335781662795e-22), (30, -39, -0.11947622640071e-22),
    (31, -40, 0.18228094581404e-23), (32, -41, -0.93537087292458e-25),
)
# IF97 region 2, ideal-gas part: (J, n)
_R2_0 = (
    (0, -0.96927686500217e1), (1, 0.10086655968018e2),
    (-5, -0.56087911283020e-2), (-4, 0.71452738081455e-1),
    (-3, -0.40710498223928), (-2, 0.14240819171444e1),
    (-1, -0.43839511319450e1), (2, -0.28408632460772),
    (3, 0.21268463753307e-1),
)
# IF97 region 2, residual part: (I, J, n)
_R2_R = (
    (1, 0, -0.17731742473213e-2), (1, 1, -0.17834862292358e-1),
    (1, 2, -0.45996013696365e-1), (1, 3, -0.57581259083432e-1),
    (1, 6, -0.50325278727930e-1), (2, 1, -0.33032641670203e-4),
    (2, 2, -0.18948987516315e-3), (2, 4, -0.39392777243355e-2),
    (2, 7, -0.43797295650573e-1), (2, 36, -0.26674547914087e-4),
    (3, 0, 0.20481737692309e-7), (3, 1, 0.43870667284435e-6),
    (3, 3, -0.32277677238570e-4), (3, 6, -0.15033924542148e-2),
    (3, 35, -0.40668253562649e-1), (4, 1, -0.78847309559367e-9),
    (4, 2, 0.12790717852285e-7), (4, 3, 0.48225372718507e-6),
    (5, 7, 0.22922076337661e-5), (6, 3, -0.16714766451061e-10),
    (6, 16, -0.21171472321355e-2), (6, 35, -0.23895741934104e2),
    (7, 0, -0.59059564324270e-17), (7, 11, -0.12621808899101e-5),
    (7, 25, -0.38946842435739e-1), (8, 8, 0.11256211360459e-10),
    (8, 36, -0.82311340897998e1), (9, 13, 0.19809712802088e-7),
    (10, 4, 0.10406965210174e-18), (10, 10, -0.10234747095929e-12),
    (10, 14, -0.10018179379511e-8), (16, 29, -0.80882908646985e-10),
    (16, 50, 0.10693031879409), (18, 57, -0.33662250574171),
    (20, 20, 0.89185845355421e-24), (20, 35, 0.30629316876232e-12),
    (20, 48, -0.42002467698208e-5), (21, 21, -0.59056029685639e-25),
    (22, 53, 0.37826947613457e-5), (23, 39, -0.12768608934681e-14),
    (24, 26, 0.73087610595061e-28), (24, 40, 0.55414715350778e-16),
    (24, 58, -0.94369707241210e-6),
)
# IF97 region 4 (saturation line)
_SAT = (
    0.11670521452767e4, -0.72421316703206e6, -0.17073846940092e2,
    0.12020824702470e5, -0.32325550322333e7, 0.14915108613530e2,
    -0.48232657361591e4, 0.40511340542057e6, -0.23855557567849,
    0.65017534844798e3,
)
# IAPWS 2008 viscosity: dilute gas H_i, and the nonzero H_ij
_VISC_H0 = (1.67752, 2.20462, 0.6366564, -0.241605)
_VISC_H1 = {
    (0, 0): 5.20094e-1, (1, 0): 8.50895e-2, (2, 0): -1.08374,
    (3, 0): -2.89555e-1, (0, 1): 2.22531e-1, (1, 1): 9.99115e-1,
    (2, 1): 1.88797, (3, 1): 1.26613, (5, 1): 1.20573e-1,
    (0, 2): -2.81378e-1, (1, 2): -9.06851e-1, (2, 2): -7.72479e-1,
    (3, 2): -4.89837e-1, (4, 2): -2.57040e-1, (0, 3): 1.61913e-1,
    (1, 3): 2.57399e-1, (0, 4): -3.25372e-2, (3, 4): 6.98452e-2,
    (4, 5): 8.72102e-3, (3, 6): -4.35673e-3, (5, 6): -5.93264e-4,
}


def _ipow(x, k: int):
    """x ** k for an integer k (x ** 0 is 1, also where x is 0)."""
    if k == 0:
        return torch.ones_like(x)
    return x ** k


def water_liquid(p, t):
    """IF97 region 1: (density, internal energy) of liquid water."""
    tk = t + TC_K
    pi = p / 16.53e6
    tau = 1386.0 / tk
    a = 7.1 - pi
    b = tau - 1.222
    g_pi = torch.zeros_like(p)
    g_tau = torch.zeros_like(p)
    for i, j, n in _R1:
        if i:
            g_pi = g_pi - n * i * _ipow(a, i - 1) * _ipow(b, j)
        if j:
            g_tau = g_tau + n * j * _ipow(a, i) * _ipow(b, j - 1)
    rt = R_WATER * tk
    density = 16.53e6 / (rt * g_pi)
    return density, rt * (tau * g_tau - pi * g_pi)


def water_vapour(p, t):
    """IF97 region 2: (density, internal energy) of steam."""
    tk = t + TC_K
    pi = p / 1.0e6
    tau = 540.0 / tk
    b = tau - 0.5
    g0_tau = torch.zeros_like(p)
    for j, n in _R2_0:
        if j:
            g0_tau = g0_tau + n * j * _ipow(tau, j - 1)
    gr_pi = torch.zeros_like(p)
    gr_tau = torch.zeros_like(p)
    for i, j, n in _R2_R:
        gr_pi = gr_pi + n * i * _ipow(pi, i - 1) * _ipow(b, j)
        if j:
            gr_tau = gr_tau + n * _ipow(pi, i) * j * _ipow(b, j - 1)
    g_pi = 1.0 / pi + gr_pi
    rt = R_WATER * tk
    density = 1.0e6 / (rt * g_pi)
    return density, rt * (tau * (g0_tau + gr_tau) - pi * g_pi)


def saturation_temperature(p):
    """IF97 eq. (31): (saturation temperature, out of range)."""
    n = _SAT
    beta2 = torch.sqrt(p / 1.0e6)
    beta = torch.sqrt(beta2)
    e = beta2 + n[2] * beta + n[5]
    f = n[0] * beta2 + n[3] * beta + n[6]
    g = n[1] * beta2 + n[4] * beta + n[7]
    d = 2.0 * g / (-f - torch.sqrt(f * f - 4.0 * e * g))
    x = n[9] + d
    t = 0.5 * (x - torch.sqrt(x * x - 4.0 * (n[8] + n[9] * d))) - TC_K
    return t, (p < P_SAT_MIN) | (p > P_CRIT)


def water_viscosity(t, density):
    """IAPWS 2008 viscosity (Pa s), without the critical enhancement."""
    tbar = (t + TC_K) / T_CRIT
    rbar = density / RHO_CRIT
    s0 = sum(h / tbar ** i for i, h in enumerate(_VISC_H0))
    mu0 = 100.0 * torch.sqrt(tbar) / s0
    x = 1.0 / tbar - 1.0
    y = rbar - 1.0
    s1 = sum(h * _ipow(x, i) * _ipow(y, j) for (i, j), h in _VISC_H1.items())
    return 1.0e-6 * mu0 * torch.exp(rbar * s1)


# -- air ----------------------------------------------------------------

M_AIR = 28.96  # g/mol
_AIR_H = (1.20740, 9.24502, 0.115984, -5.63568e-4)  # Irvine and Liley
# Henry's law: weight, reference pressure, coefficients in t / 100
_AIR_HENRY = (
    (0.79, 1.01325e5, (0.513726, 1.58603, -5.9378e-1, -6.98282e-1,
                       5.10330e-1, -1.21388e-1, 1.00041e-2)),
    (0.21, 1.0e5, (0.26234, 0.610628, 7.00732e-1, -0.139299e1,
                   7.13850e-1, -1.54216e-1, 1.23190e-2)),
)
# Lennard-Jones parameters of the viscosity: epsilon/k (K), sigma (A)
_EPS_AIR, _EPS_WATER = 97.0, 363.0
_SIG_AIR, _SIG_WATER = 3.617, 2.655


def _poly(c, x):
    out = torch.zeros_like(x) + c[-1]
    for a in c[-2::-1]:
        out = out * x + a
    return out


def air_density(pg, t):
    return pg * M_AIR / (1.0e3 * R_UNIVERSAL * (t + TC_K))


def air_enthalpy(t):
    tk0 = torch.full_like(t, (0.01 + TC_K) / 100.0)
    return 1.0e4 * (_poly(_AIR_H, (t + TC_K) / 100.0) - _poly(_AIR_H, tk0))


def air_henry(t):
    """Henry's constant (Pa) and d ln H / dT (1/K)."""
    x = t / 100.0
    h = torch.zeros_like(t)
    dlnh = torch.zeros_like(t)
    for w, p0, c in _AIR_HENRY:
        hc = 1.0e5 * p0 * _poly(c, x)
        dc = [k * a for k, a in enumerate(c)][1:]
        h = h + w * hc
        dlnh = dlnh + w * (1.0e5 * p0 * _poly(dc, x)) / (hc * 100.0)
    return h, dlnh


def air_solution_energy(t, dlnh):
    tk = t + TC_K
    return -1.0e3 * R_UNIVERSAL * tk * tk * dlnh / M_AIR


def air_mass_fraction_liquid(pg, henry):
    xm = pg / henry
    w = xm * M_AIR
    return w / (w + (1.0 - xm) * M_WATER)


def air_vapour_viscosity(water_visc, t, xg):
    """Viscosity of air and water vapour of air mass fraction xg
    (kinetic theory of Hirschfelder, Curtiss and Bird)."""
    m1, m2 = M_AIR, M_WATER
    x1 = (xg / m1) / (xg / m1 + (1.0 - xg) / m2)
    x2 = 1.0 - x1
    tk = t + TC_K
    eps3 = (_EPS_AIR * _EPS_WATER) ** 0.5
    sig3 = 0.5 * (_SIG_AIR + _SIG_WATER)
    m3 = 2.0 * m1 * m2 / (m1 + m2)
    tr1 = tk / _EPS_AIR
    tr3 = tk / eps3
    om1 = (1.188 - 0.051 * tr1) / tr1
    om3 = (1.48 - 0.412 * torch.log(tr3)) / tr3
    v1 = 266.93e-7 * torch.sqrt(m1 * tr1 * _EPS_AIR) / (
        _SIG_AIR ** 2 * om1 * tr1)
    v3 = 266.93e-7 * torch.sqrt(m3 * tr3 * eps3) / (sig3 ** 2 * om3 * tr3)
    v2 = 10.0 * water_visc
    a = 1.095 / tr3
    z1 = x1 * x1 / v1 + 2.0 * x2 * x1 / v3 + x2 * x2 / v2
    g = x1 * x1 * m1 / m2
    h = x2 * x2 * m2 / m1
    e = (2.0 * x1 * x2 * m1 * m2 / (m3 * m3)) * v3 / (v1 * v2)
    z2 = 0.6 * a * (g / v1 + e + h / v2)
    z3 = 0.6 * a * (g + e * (v1 + v2) - 2.0 * x1 * x2 + h)
    return 0.1 * (1.0 + z3) / (z1 + z2)
