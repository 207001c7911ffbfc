"""IAPWS-IF97 industrial formulation for water/steam, in PyTorch
(counterpart of waiwera_tpu/thermo/iapws97.py).

Elementwise functions over tensors: regions 1, 2 and 3, the region 4
saturation line, the 2/3 boundary and the IAPWS-2008 viscosity without
critical enhancement. Properties are (density, internal energy) from
(pressure [Pa], temperature [deg C]). Coefficient tables are the
published IAPWS-IF97 / IAPWS-2008 constants.

Every function computes in the dtype of its input (f64 for the
residual, f32 for the Jacobian tangent chain) and is differentiable in
forward mode: out-of-range inputs set an ``err`` flag and are clamped,
so no NaN or Inf is produced.
"""

from __future__ import annotations

import numpy as np
import torch

from waiwera_tpu_torch.tensors import const_like, index_on
from waiwera_tpu_torch.thermo.base import (
    DCRITICAL,
    PCRITICAL,
    RCONST,
    TC_K,
    TCRITICAL,
    TCRITICAL_K,
    Thermodynamics,
)

# ----------------------------------------------------------------------
# Region 1 (liquid water): IF97 eq. (7), 34 terms
# ----------------------------------------------------------------------
_R1_PSTAR = 16.53e6
_R1_TSTAR = 1386.0

_R1_N = np.array([
    0.14632971213167, -0.84548187169114, -0.37563603672040e1,
    0.33855169168385e1, -0.95791963387872, 0.15772038513228,
    -0.16616417199501e-1, 0.81214629983568e-3, 0.28319080123804e-3,
    -0.60706301565874e-3, -0.18990068218419e-1, -0.32529748770505e-1,
    -0.21841717175414e-1, -0.52838357969930e-4, -0.47184321073267e-3,
    -0.30001780793026e-3, 0.47661393906987e-4, -0.44141845330846e-5,
    -0.72694996297594e-15, -0.31679644845054e-4, -0.28270797985312e-5,
    -0.85205128120103e-9, -0.22425281908000e-5, -0.65171222895601e-6,
    -0.14341729937924e-12, -0.40516996860117e-6, -0.12734301741641e-8,
    -0.17424871230634e-9, -0.68762131295531e-18, 0.14478307828521e-19,
    0.26335781662795e-22, -0.11947622640071e-22, 0.18228094581404e-23,
    -0.93537087292458e-25,
])
_R1_I = np.array([
    0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 1, 1,
    2, 2, 2, 2, 2, 3, 3, 3, 4, 4, 4, 5, 8, 8,
    21, 23, 29, 30, 31, 32,
], dtype=np.float64)
_R1_J = np.array([
    -2, -1, 0, 1, 2, 3, 4, 5, -9, -7, -1, 0, 1,
    3, -3, 0, 1, 3, 17, -4, 0, 6, -5, -2, 10, -8,
    -11, -6, -29, -31, -38, -39, -40, -41,
], dtype=np.float64)

# ----------------------------------------------------------------------
# Region 2 (steam): IF97 eqs. (15)-(17), 9 ideal-gas + 43 residual terms
# ----------------------------------------------------------------------
_R2_PSTAR = 1.0e6
_R2_TSTAR = 540.0

_R2_N0 = np.array([
    -0.96927686500217e1, 0.10086655968018e2, -0.56087911283020e-2,
    0.71452738081455e-1, -0.40710498223928, 0.14240819171444e1,
    -0.43839511319450e1, -0.28408632460772, 0.21268463753307e-1,
])
_R2_J0 = np.array([0, 1, -5, -4, -3, -2, -1, 2, 3], dtype=np.float64)

_R2_N = np.array([
    -0.17731742473213e-2, -0.17834862292358e-1, -0.45996013696365e-1,
    -0.57581259083432e-1, -0.50325278727930e-1, -0.33032641670203e-4,
    -0.18948987516315e-3, -0.39392777243355e-2, -0.43797295650573e-1,
    -0.26674547914087e-4, 0.20481737692309e-7, 0.43870667284435e-6,
    -0.32277677238570e-4, -0.15033924542148e-2, -0.40668253562649e-1,
    -0.78847309559367e-9, 0.12790717852285e-7, 0.48225372718507e-6,
    0.22922076337661e-5, -0.16714766451061e-10, -0.21171472321355e-2,
    -0.23895741934104e2, -0.59059564324270e-17, -0.12621808899101e-5,
    -0.38946842435739e-1, 0.11256211360459e-10, -0.82311340897998e1,
    0.19809712802088e-7, 0.10406965210174e-18, -0.10234747095929e-12,
    -0.10018179379511e-8, -0.80882908646985e-10, 0.10693031879409,
    -0.33662250574171, 0.89185845355421e-24, 0.30629316876232e-12,
    -0.42002467698208e-5, -0.59056029685639e-25, 0.37826947613457e-5,
    -0.12768608934681e-14, 0.73087610595061e-28, 0.55414715350778e-16,
    -0.94369707241210e-6,
])
_R2_I = np.array([
    1, 1, 1, 1, 1, 2, 2, 2, 2, 2, 3, 3, 3, 3, 3,
    4, 4, 4, 5, 6, 6, 6, 7, 7, 7, 8, 8, 9, 10, 10,
    10, 16, 16, 18, 20, 20, 20, 21, 22, 23, 24, 24, 24,
], dtype=np.float64)
_R2_J = np.array([
    0, 1, 2, 3, 6, 1, 2, 4, 7, 36, 0, 1, 3, 6,
    35, 1, 2, 3, 7, 3, 16, 35, 0, 11, 25, 8, 36,
    13, 4, 10, 14, 29, 50, 57, 20, 35, 48, 21, 53,
    39, 26, 40, 58,
], dtype=np.float64)

# ----------------------------------------------------------------------
# Region 3 (supercritical): IF97 eq. (28), 40 terms of phi(delta, tau)
# ----------------------------------------------------------------------
_R3_N = np.array([
    0.10658070028513e1, -0.15732845290239e2, 0.20944396974307e2,
    -0.76867707878716e1, 0.26185947787954e1, -0.28080781148620e1,
    0.12053369696517e1, -0.84566812812502e-2, -0.12654315477714e1,
    -0.11524407806681e1, 0.88521043984318, -0.64207765181607,
    0.38493460186671, -0.85214708824206, 0.48972281541877e1,
    -0.30502617256965e1, 0.39420536879154e-1, 0.12558408424308,
    -0.27999329698710, 0.13899799569460e1, -0.20189915023570e1,
    -0.82147637173963e-2, -0.47596035734923, 0.43984074473500e-1,
    -0.44476435428739, 0.90572070719733, 0.70522450087967,
    0.10770512626332, -0.32913623258954, -0.50871062041158,
    -0.22175400873096e-1, 0.94260751665092e-1, 0.16436278447961,
    -0.13503372241348e-1, -0.14834345352472e-1, 0.57922953628084e-3,
    0.32308904703711e-2, 0.80964802996215e-4, -0.16557679795037e-3,
    -0.44923899061815e-4,
])
_R3_I = np.array([
    0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2, 2, 2, 2,
    3, 3, 3, 3, 3, 4, 4, 4, 4, 5, 5, 5, 6, 6, 6, 7, 8, 9,
    9, 10, 10, 11,
], dtype=np.float64)
_R3_J = np.array([
    0, 0, 1, 2, 7, 10, 12, 23, 2, 6, 15, 17, 0, 2, 6, 7, 22,
    26, 0, 2, 4, 16, 26, 0, 2, 4, 26, 1, 3, 26, 0, 2, 26, 2,
    26, 2, 26, 0, 1, 26,
], dtype=np.float64)

# first term of phi_delta in IF97 region 3 involves n1*ln(delta); its
# delta-derivative is n1/delta.
_R3_N1 = float(_R3_N[0])

# ----------------------------------------------------------------------
# Region 4 saturation line: IF97 eqs. (29)-(31), 10 coefficients
# ----------------------------------------------------------------------
_SAT_PSTAR = 1.0e6
_SAT_N = np.array([
    0.11670521452767e4, -0.72421316703206e6, -0.17073846940092e2,
    0.12020824702470e5, -0.32325550322333e7, 0.14915108613530e2,
    -0.48232657361591e4, 0.40511340542057e6, -0.23855557567849,
    0.65017534844798e3,
])

# ----------------------------------------------------------------------
# Region 2/3 boundary: IF97 eqs. (5)-(6), 5 coefficients
# ----------------------------------------------------------------------
_B23_PSTAR = 1.0e6
_B23_N = np.array([
    0.34805185628969e3, -0.11671859879975e1, 0.10192970039326e-2,
    0.57254459862746e3, 0.13918839778870e2,
])

# ----------------------------------------------------------------------
# IAPWS-2008 viscosity (no critical enhancement)
# ----------------------------------------------------------------------
_VISC_MUSTAR = 1.0e-6
_VISC_H0 = np.array([1.67752, 2.20462, 0.6366564, -0.241605])
_VISC_H1 = np.array([
    5.20094e-1, 8.50895e-2, -1.08374, -2.89555e-1, 2.22531e-1,
    9.99115e-1, 1.88797, 1.26613, 1.20573e-1, -2.81378e-1,
    -9.06851e-1, -7.72479e-1, -4.89837e-1, -2.57040e-1, 1.61913e-1,
    2.57399e-1, -3.25372e-2, 6.98452e-2, 8.72102e-3, -4.35673e-3,
    -5.93264e-4,
])
_VISC_I = np.array(
    [0, 1, 2, 3, 0, 1, 2, 3, 5, 0, 1, 2, 3, 4, 0, 1, 0, 3, 4, 3, 5],
    dtype=np.int64,
)
_VISC_J = np.array(
    [0, 0, 0, 0, 1, 1, 1, 1, 1, 2, 2, 2, 2, 2, 3, 3, 4, 4, 5, 6, 6],
    dtype=np.int64,
)

# Operating-range limits (IAPWS.F90 region property routines)
REGION1_MAX_TEMPERATURE = 350.0  # deg C (360 with "extrapolate")
REGION2_MAX_TEMPERATURE = 800.0  # deg C
MAX_PRESSURE = 100.0e6  # Pa
SATURATION_MIN_PRESSURE = 611.213  # Pa


# per-term coefficient and exponent tables of the partial derivatives
# (n*I, I-1, J) and (n*J, I, J-1), built once in f64
_R1_GAMPI = (_R1_N * _R1_I, _R1_I - 1.0, _R1_J)
_R1_GAMT = (_R1_N * _R1_J, _R1_I, _R1_J - 1.0)
_R2_GAMT0 = (_R2_N0 * _R2_J0, _R2_J0 - 1.0)
_R2_GAMPI = (_R2_N * _R2_I, _R2_I - 1.0, _R2_J)
_R2_GAMT = (_R2_N * _R2_J, _R2_I, _R2_J - 1.0)
_R3_PHIDELTA = (_R3_N * _R3_I, _R3_I - 1.0, _R3_J)
_R3_PHITAU = (_R3_N * _R3_J, _R3_I, _R3_J - 1.0)
_SAT = [float(v) for v in _SAT_N]
_B23 = [float(v) for v in _B23_N]
_VH0 = [float(v) for v in _VISC_H0]


def _powsum(x, y, table):
    """sum_k n_k * x**ix_k * y**jy_k with x, y of shape [...] and
    table = (n, ix, jy). Exponents may be negative; x and y must be
    strictly positive (guaranteed by input clamping)."""
    n, ix, jy = (const_like(a, x) for a in table)
    lx = torch.log(x)[..., None]
    ly = torch.log(y)[..., None]
    return torch.sum(n * torch.exp(ix * lx + jy * ly), dim=-1)


def saturation_pressure(t: torch.Tensor):
    """Saturation pressure (Pa) from temperature (deg C). IF97 eq. (30)."""
    n = _SAT
    err = (t < 0.0) | (t > TCRITICAL)
    ts = torch.clamp(t, 0.0, TCRITICAL)
    tk = ts + TC_K
    theta = tk + n[8] / (tk - n[9])
    theta2 = theta * theta
    a = theta2 + n[0] * theta + n[1]
    b = n[2] * theta2 + n[3] * theta + n[4]
    c = n[5] * theta2 + n[6] * theta + n[7]
    x = 2.0 * c / (-b + torch.sqrt(b * b - 4.0 * a * c))
    x = x * x
    p = _SAT_PSTAR * x * x
    return p, err


def saturation_temperature(p: torch.Tensor):
    """Saturation temperature (deg C) from pressure (Pa). IF97 eq. (31)."""
    n = _SAT
    err = (p < SATURATION_MIN_PRESSURE) | (p > PCRITICAL)
    ps = torch.clamp(p, SATURATION_MIN_PRESSURE, PCRITICAL)
    beta2 = torch.sqrt(ps / _SAT_PSTAR)
    beta = torch.sqrt(beta2)
    e = beta2 + n[2] * beta + n[5]
    f = n[0] * beta2 + n[3] * beta + n[6]
    g = n[1] * beta2 + n[4] * beta + n[7]
    d = 2.0 * g / (-f - torch.sqrt(f * f - 4.0 * e * g))
    x = n[9] + d
    t = 0.5 * (x - torch.sqrt(x * x - 4.0 * (n[8] + n[9] * d))) - TC_K
    return t, err


def region1_properties(p: torch.Tensor, t: torch.Tensor,
                       max_temperature=REGION1_MAX_TEMPERATURE):
    """Liquid-water density (kg/m3) and internal energy (J/kg) from
    pressure (Pa), temperature (deg C). IF97 region 1, eq. (7)."""
    err = (t > max_temperature) | (p > MAX_PRESSURE)
    ts = torch.clamp(t, 0.0, max_temperature)
    ps = torch.clamp(p, 0.0, MAX_PRESSURE)
    tk = ts + TC_K
    rt = RCONST * tk
    pi = ps / _R1_PSTAR
    tau = _R1_TSTAR / tk
    x = 7.1 - pi
    y = tau - 1.222
    gampi = -_powsum(x, y, _R1_GAMPI)
    gamt = _powsum(x, y, _R1_GAMT)
    density = _R1_PSTAR / (rt * gampi)
    energy = rt * (tau * gamt - pi * gampi)
    return density, energy, err


def region2_properties(p: torch.Tensor, t: torch.Tensor):
    """Dry-steam density (kg/m3) and internal energy (J/kg) from
    pressure (Pa), temperature (deg C). IF97 region 2, eqs. (15)-(17)."""
    err = (t > REGION2_MAX_TEMPERATURE) | (p > MAX_PRESSURE)
    ts = torch.clamp(t, 0.0, REGION2_MAX_TEMPERATURE)
    ps = torch.clamp(p, 1e-3, MAX_PRESSURE)
    tk = ts + TC_K
    rt = RCONST * tk
    pi = ps / _R2_PSTAR
    tau = _R2_TSTAR / tk
    y = tau - 0.5
    n0, j0 = (const_like(a, tau) for a in _R2_GAMT0)
    gamt0 = torch.sum(n0 * torch.exp(j0 * torch.log(tau)[..., None]), dim=-1)
    gampir = _powsum(pi, y, _R2_GAMPI)
    gamtr = _powsum(pi, y, _R2_GAMT)
    gampi = 1.0 / pi + gampir
    density = _R2_PSTAR / (rt * gampi)
    energy = rt * (tau * (gamt0 + gamtr) - pi * gampi)
    return density, energy, err


def region3_properties(d: torch.Tensor, t: torch.Tensor):
    """Supercritical pressure (Pa) and internal energy (J/kg) from
    density (kg/m3), temperature (deg C). IF97 region 3, eq. (28)."""
    tk = t + TC_K
    rt = RCONST * tk
    tau = TCRITICAL_K / tk
    delta = d / DCRITICAL
    phidelta = _R3_N1 / delta + _powsum(delta, tau, _R3_PHIDELTA)
    phitau = _powsum(delta, tau, _R3_PHITAU)
    pressure = d * rt * delta * phidelta
    energy = rt * tau * phitau
    err = pressure > MAX_PRESSURE
    return pressure, energy, err


def region3_density(p: torch.Tensor, t: torch.Tensor, d0: torch.Tensor,
                    num_iterations: int = 16):
    """Invert region 3 for density from (pressure, temperature) by a
    fixed number of Newton steps on p(d, t), starting from d0. The
    derivative dp/dd is a forward-mode jvp, which nests inside an outer
    jvp of the caller."""

    def pressure_of_d(d):
        return region3_properties(d, t)[0]

    d = d0
    for _ in range(num_iterations):
        pr, dp_dd = torch.func.jvp(pressure_of_d, (d,), (torch.ones_like(d),))
        step = (pr - p) / torch.where(torch.abs(dp_dd) > 1e-30, dp_dd, 1e-30)
        d = torch.clamp(d - step, 1.0, 1200.0)
    pr = region3_properties(d, t)[0]
    err = torch.abs(pr - p) > 1e-6 * torch.clamp_min(p, 1.0)
    return d, err


def viscosity(t: torch.Tensor, density: torch.Tensor):
    """Dynamic viscosity (Pa.s) from temperature (deg C) and density
    (kg/m3). IAPWS-2008 correlation without critical enhancement
    (IAPWS.F90:409-443)."""
    h0 = _VH0
    tk = t + TC_K
    tau = tk / TCRITICAL_K
    delta = density / DCRITICAL
    itau = 1.0 / tau
    # dilute-gas limit
    s0 = h0[0] + h0[1] * itau + h0[2] * itau * itau + h0[3] * itau * itau * itau
    mu0 = 100.0 * torch.sqrt(tau) / s0
    # finite-density contribution: small non-negative integer powers of
    # possibly-negative bases, by iterated multiplication (a pow with
    # exponent 0 would put 0 * inf into the tangent at a zero base)
    x = itau - 1.0
    y = delta - 1.0
    xs = [torch.ones_like(x)]
    for _ in range(5):
        xs.append(xs[-1] * x)
    ys = [torch.ones_like(y)]
    for _ in range(6):
        ys.append(ys[-1] * y)
    xp = torch.stack(xs, dim=-1)  # exponents 0..5
    yp = torch.stack(ys, dim=-1)  # exponents 0..6
    h1 = const_like(_VISC_H1, x)
    s1 = torch.sum(
        h1 * xp[..., index_on(_VISC_I, x.device)]
        * yp[..., index_on(_VISC_J, x.device)],
        dim=-1,
    )
    mu1 = torch.exp(delta * s1)
    return _VISC_MUSTAR * mu0 * mu1


def boundary23_pressure(t: torch.Tensor):
    """Pressure (Pa) on the region 2/3 boundary from temperature (deg C)."""
    tk = t + TC_K
    n = _B23
    return _B23_PSTAR * (n[0] + tk * (n[1] + tk * n[2]))


def boundary23_temperature(p: torch.Tensor):
    """Temperature (deg C) on the region 2/3 boundary from pressure (Pa)."""
    n = _B23
    return n[3] + torch.sqrt((p / _B23_PSTAR - n[4]) / n[2]) - TC_K


class IAPWS97(Thermodynamics):
    """IAPWS-97 thermodynamics backend (IAPWS.F90 equivalent)."""

    name = "IAPWS-97"

    def __init__(self, extrapolate: bool = False):
        self.region1_max_temperature = 360.0 if extrapolate else 350.0

    def water_properties(self, p, t):
        return region1_properties(p, t, self.region1_max_temperature)

    def steam_properties(self, p, t):
        return region2_properties(p, t)

    def supercritical_properties(self, d, t):
        return region3_properties(d, t)

    @staticmethod
    def saturation_pressure(t):
        return saturation_pressure(t)

    @staticmethod
    def saturation_temperature(p):
        return saturation_temperature(p)

    @staticmethod
    def viscosity(t, density):
        return viscosity(t, density)

    @staticmethod
    def phase_viscosity(phase_index, t, p, density):
        """IAPWS-2008 viscosity for any phase (pressure unused)."""
        del phase_index, p
        return viscosity(t, density)

    @staticmethod
    def boundary23_pressure(t):
        return boundary23_pressure(t)

    @staticmethod
    def boundary23_temperature(p):
        return boundary23_temperature(p)
