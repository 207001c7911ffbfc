"""IFC-67 thermodynamic formulation (TOUGH2/AUTOUGH2-compatible), in
PyTorch (counterpart of waiwera_tpu/thermo/ifc67.py).

The 1967 International Formulation Committee formulation ("A
formulation of the thermodynamic properties of ordinary water
substance", IFC, Duesseldorf, 1967), as the reference's IFC67 backend
(IFC67.F90), selected by JSON "thermodynamics": "ifc67". All
coefficients are the published IFC-67 standard constants. The critical
point is the IFC-67 one (647.3 K, 22.12 MPa).

Every function computes in the dtype of its input and is
differentiable in forward mode; the saturation temperature is a fixed
number of Newton steps whose derivative is a nested torch.func.jvp.
"""

from __future__ import annotations

import torch

from waiwera_tpu_torch.thermo.base import TC_K, Thermodynamics

TCRITICAL_K = 647.3
TCRITICAL = TCRITICAL_K - TC_K
PCRITICAL = 22.12e6

# saturation-curve coefficients
_SA = [
    -7.691234564, -2.608023696e1, -1.681706546e2, 6.423285504e1,
    -1.189646225e2, 4.167117320, 2.097506760e1, 1.0e9, 6.0,
]

# region 1 coefficients
_A = [
    6.824687741e3, -5.422063673e2, -2.096666205e4, 3.941286787e4,
    -13.466555478e4, 29.707143084e4, -4.375647096e5, 42.954208335e4,
    -27.067012452e4, 9.926972482e4, -16.138168904e3, 7.982692717,
    -2.616571843e-2, 1.522411790e-3, 2.284279054e-2, 2.421647003e2,
    1.269716088e-10, 2.074838328e-7, 2.174020350e-8, 1.105710498e-9,
    1.293441934e1, 1.308119072e-5, 6.047626338e-14,
]
_S = [
    8.438375405e-1, 5.362162162e-4, 1.72, 7.342278489e-2,
    4.975858870e-2, 6.537154300e-1, 1.150e-6, 1.51080e-5,
    1.41880e-1, 7.002753165, 2.995284926e-4, 2.040e-1,
]

# region 2 coefficients
_B0 = 16.83599274
_B0X = [28.56067796, -54.38923329, 0.4330662834, -0.6547711697,
        8.565182058e-2]
_B11, _B12 = 6.670375918e-2, 1.388983801
_B21, _B22, _B23 = 8.390104328e-2, 2.614670893e-2, -3.373439453e-2
_B31, _B32 = 4.520918904e-1, 1.069036614e-1
_B41, _B42 = -5.975336707e-1, -8.847535804e-2
_B51, _B52, _B53 = 5.958051609e-1, -5.159303373e-1, 2.075021122e-1
_B61, _B62 = 1.190610271e-1, -9.867174132e-2
_B71, _B72 = 1.683998803e-1, -5.809438001e-2
_B81, _B82 = 6.552390126e-3, 5.710218649e-4
_B9 = [1.936587558e2, -1.388522425e3, 4.126607219e3, -6.508211677e3,
       5.745984054e3, -2.693088365e3, 5.235718623e2]
_SB = 7.633333333e-1
_SB61, _SB71 = 4.006073948e-1, 8.636081627e-2
_SB81, _SB82 = -8.532322921e-1, 3.460208861e-1

REGION1_MAX_TEMPERATURE = 350.0
REGION2_MAX_TEMPERATURE = 800.0
MAX_PRESSURE = 100.0e6


def saturation_pressure(t: torch.Tensor):
    """Saturation pressure (Pa) from temperature (deg C)."""
    err = (t < 1.0) | (t > TCRITICAL)
    ts = torch.clamp(t, 1.0, TCRITICAL)
    tc = (ts + TC_K) / TCRITICAL_K
    x1 = 1.0 - tc
    x2 = x1 * x1
    sc = _SA[4] * x1 + _SA[3]
    sc = sc * x1 + _SA[2]
    sc = sc * x1 + _SA[1]
    sc = sc * x1 + _SA[0]
    sc = sc * x1
    pc = torch.exp(
        sc / (tc * (1.0 + _SA[5] * x1 + _SA[6] * x2))
        - x1 / (_SA[7] * x2 + _SA[8])
    )
    return pc * PCRITICAL, err


def saturation_temperature(p: torch.Tensor, num_iterations: int = 12):
    """Saturation temperature (deg C) from pressure (Pa): a fixed number
    of Newton steps on the saturation curve (the reference uses
    newton1d), each derivative a forward-mode jvp, which nests inside an
    outer jvp of the caller."""
    err = (p < 0.0061e5) | (p > PCRITICAL)
    ps = torch.clamp(p, 0.0061e5, PCRITICAL)
    t = torch.clamp_min(4606.0 / (24.02 - torch.log(ps)) - TC_K, 5.0)

    def f(x):
        pr, _ = saturation_pressure(x)
        return pr - ps

    for _ in range(num_iterations):
        fx, dfx = torch.func.jvp(f, (t,), (torch.ones_like(t),))
        t_new = t - fx / torch.where(torch.abs(dfx) > 1e-300, dfx, 1.0)
        t = torch.clamp(t_new, 1.0, TCRITICAL)
    return t, err


def region1_properties(p: torch.Tensor, t: torch.Tensor,
                       max_temperature=REGION1_MAX_TEMPERATURE):
    """Liquid water density / internal energy (IFC67.F90:260-368)."""
    err = (t > max_temperature) | (p > MAX_PRESSURE)
    ts = torch.clamp(t, 0.0, max_temperature)
    ps = torch.clamp(p, 0.0, MAX_PRESSURE)

    A = _A
    S = _S
    tkr = (ts + TC_K) / TCRITICAL_K
    tkr2 = tkr * tkr
    tkr3 = tkr * tkr2
    tkr4 = tkr2 * tkr2
    tkr6 = tkr4 * tkr2
    tkr7 = tkr4 * tkr3
    tkr8 = tkr4 * tkr4
    tkr10 = tkr4 * tkr6
    tkr11 = tkr * tkr10
    tkr18 = tkr8 * tkr10
    tkr19 = tkr8 * tkr11
    tkr20 = tkr10 * tkr10
    pnmr = ps / PCRITICAL
    pnmr2 = pnmr * pnmr
    pnmr3 = pnmr * pnmr2
    pnmr4 = pnmr * pnmr3
    y = 1.0 - S[0] * tkr2 - S[1] / tkr6
    zp = S[2] * y * y - 2.0 * S[3] * tkr + 2.0 * S[4] * pnmr
    err = err | (zp < 0.0)
    zp = torch.clamp_min(zp, 0.0)
    z = y + torch.sqrt(zp)
    cz = torch.clamp_min(z, 1e-10) ** (5.0 / 17.0)
    par1 = A[11] * S[4] / cz
    cc1 = S[5] - tkr
    cc2 = cc1 * cc1
    cc4 = cc2 * cc2
    cc8 = cc4 * cc4
    cc10 = cc2 * cc8
    aa1 = S[6] + tkr19
    par2 = A[12] + A[13] * tkr + A[14] * tkr2 + A[15] * cc10 + A[16] / aa1
    par3 = (A[17] + 2.0 * A[18] * pnmr + 3.0 * A[19] * pnmr2) / (
        S[7] + tkr11
    )
    dd1 = S[9] + pnmr
    dd2 = dd1 * dd1
    dd4 = dd2 * dd2
    par4 = A[20] * tkr18 * (S[8] + tkr2) * (-3.0 / dd4 + S[10])
    par5 = 3.0 * A[21] * (S[11] - tkr) * pnmr2 + 4.0 * A[22] / tkr20 * pnmr3
    vmkr = par1 + par2 - par3 - par4 + par5
    v = vmkr * 3.17e-3
    d = 1.0 / v
    yd = -2.0 * S[0] * tkr + 6.0 * S[1] / tkr7
    snum = A[9] + A[10] * tkr
    snum = snum * tkr + A[8]
    snum = snum * tkr + A[7]
    snum = snum * tkr + A[6]
    snum = snum * tkr + A[5]
    snum = snum * tkr + A[4]
    snum = snum * tkr + A[3]
    snum = snum * tkr2 - A[1]
    prt1 = (
        A[11]
        * (
            z * (17.0 * (z / 29.0 - y / 12.0) + 5.0 * tkr * yd / 12.0)
            + S[3] * tkr
            - (S[2] - 1.0) * tkr * y * yd
        )
        / cz
    )
    prt2 = pnmr * (
        A[12]
        - A[14] * tkr2
        + A[15] * (9.0 * tkr + S[5]) * cc8 * cc1
        + A[16] * (19.0 * tkr19 + aa1) / (aa1 * aa1)
    )
    bb1 = S[7] + tkr11
    bb2 = bb1 * bb1
    prt3 = (
        (11.0 * tkr11 + bb1)
        / bb2
        * (A[17] * pnmr + A[18] * pnmr2 + A[19] * pnmr3)
    )
    ee1 = S[9] + pnmr
    ee3 = ee1 * ee1 * ee1
    prt4 = (
        A[20] * tkr18 * (17.0 * S[8] + 19.0 * tkr2)
        * (1.0 / ee3 + S[10] * pnmr)
    )
    prt5 = A[21] * S[11] * pnmr3 + 21.0 * A[22] / tkr20 * pnmr4
    entr = A[0] * tkr - snum + prt1 + prt2 - prt3 + prt4 + prt5
    h = entr * 70120.4
    u = h - ps * v
    return d, u, err


def region2_properties(p: torch.Tensor, t: torch.Tensor):
    """Dry steam density / internal energy (IFC67.F90:425-570)."""
    err = (t > REGION2_MAX_TEMPERATURE) | (p > MAX_PRESSURE)
    ts = torch.clamp(t, 0.0, REGION2_MAX_TEMPERATURE)
    ps = torch.clamp(p, 1.0, MAX_PRESSURE)

    theta = (ts + TC_K) / TCRITICAL_K
    beta = ps / PCRITICAL
    ri1 = 4.260321148
    x = torch.exp(_SB * (1.0 - theta))
    x2 = x * x
    x3 = x2 * x
    x4 = x3 * x
    x5 = x4 * x
    x6 = x5 * x
    x8 = x6 * x2
    x10 = x6 * x4
    x11 = x10 * x
    x14 = x10 * x4
    x18 = x14 * x4
    x19 = x18 * x
    x24 = x18 * x6
    x27 = x24 * x3

    theta2 = theta * theta
    theta3 = theta2 * theta
    theta4 = theta3 * theta
    beta2 = beta * beta
    beta3 = beta2 * beta
    beta4 = beta3 * beta
    beta5 = beta4 * beta
    beta6 = beta5 * beta
    beta7 = beta6 * beta

    betal = 15.74373327 - 34.17061978 * theta + 19.31380707 * theta2
    dbetal = -34.17061978 + 38.62761414 * theta
    r = beta / betal
    r2 = r * r
    r4 = r2 * r2
    r6 = r4 * r2
    r10 = r6 * r4

    chi2 = ri1 * theta / beta
    chi2 = chi2 - (_B11 * x10 + _B12) * x3
    chi2 = chi2 - 2.0 * beta * (_B21 * x18 + _B22 * x2 + _B23 * x)
    chi2 = chi2 - 3.0 * beta2 * ((_B31 * x8 + _B32) * x10)
    chi2 = chi2 - 4.0 * beta3 * ((_B41 * x11 + _B42) * x14)
    chi2 = chi2 - 5.0 * beta4 * ((_B51 * x8 + _B52 * x4 + _B53) * x24)

    sd1 = 1.0 / beta4 + _SB61 * x14
    sd2 = 1.0 / beta5 + _SB71 * x19
    sd3 = 1.0 / beta6 + (_SB81 * x27 + _SB82) * x27
    sd12 = sd1 * sd1
    sd22 = sd2 * sd2
    sd32 = sd3 * sd3

    chi2 = chi2 - ((_B61 * x + _B62) * x11) / sd12 * 4.0 / beta5
    chi2 = chi2 - ((_B71 * x6 + _B72) * x18) / sd22 * 5.0 / beta6
    chi2 = chi2 - ((_B81 * x10 + _B82) * x14) / sd32 * 6.0 / beta7
    sc = _B9[6]
    for b in (_B9[5], _B9[4], _B9[3], _B9[2], _B9[1], _B9[0]):
        sc = sc * x + b
    chi2 = chi2 + 11.0 * r10 * sc
    v = chi2 * 0.00317
    d = 1.0 / v

    os1 = _SB * theta
    eps2 = _B0 * theta - (
        -_B0X[0] + _B0X[2] * theta2 + 2.0 * _B0X[3] * theta3
        + 3.0 * _B0X[4] * theta4
    )
    eps2 = eps2 - beta * (
        (_B11 * (1.0 + 13.0 * os1) * x10 + _B12 * (1.0 + 3.0 * os1)) * x3
    )
    eps2 = eps2 - beta2 * (
        _B21 * (1.0 + 18.0 * os1) * x18
        + _B22 * (1.0 + 2.0 * os1) * x2
        + _B23 * (1.0 + os1) * x
    )
    eps2 = eps2 - beta3 * (
        (_B31 * (1.0 + 18.0 * os1) * x8 + _B32 * (1.0 + 10.0 * os1)) * x10
    )
    eps2 = eps2 - beta4 * (
        (_B41 * (1.0 + 25.0 * os1) * x11 + _B42 * (1.0 + 14.0 * os1)) * x14
    )
    eps2 = eps2 - beta5 * (
        (
            _B51 * (1.0 + 32.0 * os1) * x8
            + _B52 * (1.0 + 28.0 * os1) * x4
            + _B53 * (1.0 + 24.0 * os1)
        )
        * x24
    )

    sn6 = 14.0 * _SB61 * x14
    sn7 = 19.0 * _SB71 * x19
    sn8 = (54.0 * _SB81 * x27 + 27.0 * _SB82) * x27
    os5 = 1.0 + 11.0 * os1 - os1 * sn6 / sd1
    eps2 = eps2 - (_B61 * x * (os1 + os5) + _B62 * os5) * (x11 / sd1)
    os6 = 1.0 + 24.0 * os1 - os1 * sn7 / sd2
    eps2 = eps2 - (
        _B71 * x6 * os6 + _B72 * (os6 - 6.0 * os1)
    ) * (x18 / sd2)
    os7 = 1.0 + 24.0 * os1 - os1 * sn8 / sd3
    eps2 = eps2 - (
        _B81 * x10 * os7 + _B82 * (os7 - 10.0 * os1)
    ) * (x14 / sd3)
    os2 = 1.0 + theta * 10.0 * dbetal / betal
    sc = (os2 + 6.0 * os1) * _B9[6]
    sc = sc * x + (os2 + 5.0 * os1) * _B9[5]
    sc = sc * x + (os2 + 4.0 * os1) * _B9[4]
    sc = sc * x + (os2 + 3.0 * os1) * _B9[3]
    sc = sc * x + (os2 + 2.0 * os1) * _B9[2]
    sc = sc * x + (os2 + os1) * _B9[1]
    sc = sc * x + os2 * _B9[0]
    eps2 = eps2 + beta * r10 * sc
    h = eps2 * 70120.4
    u = h - ps * v
    return d, u, err


def viscosity_liquid(t: torch.Tensor, p: torch.Tensor):
    """Liquid viscosity (IFC67.F90:374-393)."""
    ex = 247.8 / (t + 133.15)
    phi = 1.0467 * (t - 31.85)
    ps, _ = saturation_pressure(t)
    am = 1.0 + phi * (p - ps) * 1.0e-11
    return 1.0e-7 * am * 241.4 * torch.pow(10.0, ex)


def viscosity_steam(t: torch.Tensor, density: torch.Tensor):
    """Steam viscosity (IFC67.F90:576-600)."""
    v1 = 0.407 * t + 80.4
    low = 1.0e-7 * (v1 - density * (1858.0 - 5.9 * t) * 1.0e-3)
    high = 1.0e-7 * (
        v1 + density * (0.353 + density * (676.5e-6 + density * 102.1e-9))
    )
    return torch.where(t <= 350.0, low, high)


class IFC67(Thermodynamics):
    """IFC-67 thermodynamics backend."""

    name = "IFC-67"
    tcritical = TCRITICAL
    pcritical = PCRITICAL

    def __init__(self, extrapolate: bool = False):
        self.region1_max_temperature = 360.0 if extrapolate else 350.0

    def water_properties(self, p, t):
        return region1_properties(p, t, self.region1_max_temperature)

    def steam_properties(self, p, t):
        return region2_properties(p, t)

    def supercritical_properties(self, d, t):
        raise NotImplementedError("IFC-67 has no supercritical region")

    @staticmethod
    def saturation_pressure(t):
        return saturation_pressure(t)

    @staticmethod
    def saturation_temperature(p):
        return saturation_temperature(p)

    @staticmethod
    def phase_viscosity(phase_index, t, p, density):
        """IFC-67 per-phase viscosity: the liquid correlation takes
        (t, p), the steam correlation (t, density)."""
        if phase_index == 0:
            return viscosity_liquid(t, p)
        return viscosity_steam(t, density)

    def viscosity(self, t, density):
        """Generic fallback: a density threshold picks the branch."""
        liquid = density > 200.0
        ps, _ = saturation_pressure(t)
        return torch.where(
            liquid, viscosity_liquid(t, ps), viscosity_steam(t, density)
        )

    def phase_composition(self, region, p, t):
        """IFC67_phase_composition (IFC67.F90:200-218): purely
        region-driven, int32."""
        zero = torch.zeros_like(region, dtype=torch.int32)
        return torch.where(
            region == 1, zero + 0b01,
            torch.where(region == 2, zero + 0b10,
                        torch.where(region == 4, zero + 0b11, zero)),
        )
