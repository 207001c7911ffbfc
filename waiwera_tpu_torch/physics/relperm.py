"""Relative permeability curves (counterpart of
waiwera_tpu/physics/relperm.py; relative_permeability.F90:597-611):
fully_mobile, linear, pickens, corey, grant, van_genuchten, table. Each
model maps liquid saturation sl [...] to (kr_liquid, kr_vapour) of
shape [..., 2], in the dtype of sl."""

from __future__ import annotations

import numpy as np
import torch

from waiwera_tpu_torch.tensors import clip, minimum
from waiwera_tpu_torch.utils.interpolation import InterpolationTable


class RelativePermeability:
    name = "abstract"

    def __call__(self, sl: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError


class FullyMobile(RelativePermeability):
    """kr = 1 for both phases (relative_permeability.F90:197-207)."""

    name = "Fully mobile"

    def __call__(self, sl):
        one = torch.ones_like(sl)
        return torch.stack([one, one], dim=-1)


class Linear(RelativePermeability):
    """Linear ramp between saturation limits per phase
    (relative_permeability.F90:214-258)."""

    name = "Linear"

    def __init__(self, liquid_limits=(0.0, 1.0), vapour_limits=(0.0, 1.0)):
        self.liquid = tuple(map(float, liquid_limits))
        self.vapour = tuple(map(float, vapour_limits))

    @staticmethod
    def _ramp(s, lim):
        lo, hi = lim
        if hi == lo:
            return torch.where(s >= hi, 1.0, torch.zeros_like(s))
        return clip((s - lo) / (hi - lo), 0.0, 1.0)

    def __call__(self, sl):
        krl = self._ramp(sl, self.liquid)
        krv = self._ramp(1.0 - sl, self.vapour)
        return torch.stack([krl, krv], dim=-1)


class Pickens(RelativePermeability):
    """kr_l = sl**power, kr_v = 1 (relative_permeability.F90:297-307)."""

    name = "Pickens"

    def __init__(self, power=1.0):
        self.power = float(power)

    def __call__(self, sl):
        krl = clip(sl, 0.0, 1.0) ** self.power
        return torch.stack([krl, torch.ones_like(sl)], dim=-1)


class Corey(RelativePermeability):
    """Corey's curves (relative_permeability.F90:336-370)."""

    name = "Corey"

    def __init__(self, slr=0.3, ssr=0.05):
        self.slr = float(slr)
        self.ssr = float(ssr)

    def _sstar(self, sl):
        return (sl - self.slr) / (1.0 - self.slr - self.ssr)

    def _ends(self, sl, krl, krv):
        """kr_l = 1, kr_v = 0 below the residual gas saturation; kr_l =
        0, kr_v = 1 above 1 - slr."""
        sv = 1.0 - sl
        low = sv < self.ssr
        high = sv > 1.0 - self.slr
        one = torch.ones_like(sl)
        zero = torch.zeros_like(sl)
        krl = torch.where(low, one, torch.where(high, zero, krl))
        krv = torch.where(low, zero, torch.where(high, one, krv))
        return torch.stack([krl, krv], dim=-1)

    def __call__(self, sl):
        sstar = clip(self._sstar(sl), 0.0, 1.0)
        s2 = sstar * sstar
        krl = s2 * s2
        krv = (1.0 - 2.0 * sstar + s2) * (1.0 - s2)
        return self._ends(sl, krl, krv)


class Grant(Corey):
    """Grant's curves: kr_v = 1 - kr_l
    (relative_permeability.F90:399-420)."""

    name = "Grant"

    def __init__(self, slr=0.3, ssr=0.6):
        super().__init__(slr=slr, ssr=ssr)

    def __call__(self, sl):
        sstar = clip(self._sstar(sl), 0.0, 1.0)
        s2 = sstar * sstar
        krl = s2 * s2
        return self._ends(sl, krl, 1.0 - krl)


class VanGenuchten(RelativePermeability):
    """van Genuchten curves (relative_permeability.F90:461-494)."""

    name = "van Genuchten"

    def __init__(self, lam=0.45, slr=1e-3, sls=1.0, sum_unity=True, ssr=0.6):
        self.lam = float(lam)
        self.slr = float(slr)
        self.sls = float(sls)
        self.sum_unity = bool(sum_unity)
        self.ssr = float(ssr)

    def __call__(self, sl):
        sstar = (sl - self.slr) / (self.sls - self.slr)
        ss = clip(sstar, 1e-12, 1.0)
        krl_mid = (
            torch.sqrt(ss)
            * (1.0 - (1.0 - ss ** (1.0 / self.lam)) ** self.lam) ** 2
        )
        krl = torch.where(
            sstar < 0.0, torch.zeros_like(sl),
            torch.where(sstar < 1.0, krl_mid, torch.ones_like(sl)),
        )
        if self.sum_unity:
            krv = 1.0 - krl
        else:
            s_hat = (sl - self.slr) / (1.0 - self.slr - self.ssr)
            s2 = s_hat * s_hat
            krv = minimum((1.0 - 2.0 * s_hat + s2) * (1.0 - s2), 1.0)
        return torch.stack([krl, krv], dim=-1)


class Table(RelativePermeability):
    """Piecewise tables per phase (relative_permeability.F90:547-558)."""

    name = "Table"

    def __init__(self, liquid, vapour, interpolation="linear"):
        self.liquid = InterpolationTable(np.asarray(liquid),
                                         interpolation=interpolation)
        self.vapour = InterpolationTable(np.asarray(vapour),
                                         interpolation=interpolation)

    def __call__(self, sl):
        krl = self.liquid.component(sl, 0)
        krv = self.vapour.component(1.0 - sl, 0)
        return torch.stack([krl, krv], dim=-1)


def from_json(spec: dict | None) -> RelativePermeability:
    """Construct from the JSON 'rock.relative_permeability' object
    (relative_permeability.F90:597-651)."""
    if not spec:
        return FullyMobile()
    kind = spec.get("type", "fully_mobile").lower().replace(" ", "_")
    if kind == "fully_mobile":
        return FullyMobile()
    if kind == "linear":
        return Linear(spec.get("liquid", [0.0, 1.0]),
                      spec.get("vapour", [0.0, 1.0]))
    if kind == "pickens":
        return Pickens(spec.get("power", 1.0))
    if kind == "corey":
        return Corey(spec.get("slr", 0.3), spec.get("ssr", 0.05))
    if kind == "grant":
        return Grant(spec.get("slr", 0.3), spec.get("ssr", 0.6))
    if kind == "van_genuchten":
        return VanGenuchten(
            spec.get("lambda", 0.45),
            spec.get("slr", 1e-3),
            spec.get("sls", 1.0),
            spec.get("sum_unity", True),
            spec.get("ssr", 0.6),
        )
    if kind == "table":
        return Table(spec["liquid"], spec["vapour"],
                     spec.get("interpolation", "linear"))
    raise ValueError(f"unknown relative permeability type: {kind!r}")
