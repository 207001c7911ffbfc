"""Capillary pressure functions (counterpart of
waiwera_tpu/physics/capillarity.py; capillary_pressure.F90:396-402):
zero, linear, van_genuchten, table. Each maps (sl, t) [...] to the
liquid-phase capillary pressure (Pa, <= 0), in the dtype of sl."""

from __future__ import annotations

import numpy as np
import torch

from waiwera_tpu_torch.tensors import clip, maximum, minimum
from waiwera_tpu_torch.utils.interpolation import InterpolationTable


class CapillaryPressure:
    name = "abstract"

    def __call__(self, sl: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError


class Zero(CapillaryPressure):
    name = "zero"

    def __call__(self, sl, t):
        return torch.zeros_like(sl)


class LinearCP(CapillaryPressure):
    """Linear in sl between saturation limits, from -pressure to 0
    (capillary_pressure.F90:186-214)."""

    name = "linear"

    def __init__(self, saturation_limits=(0.0, 1.0), pressure=0.125e5):
        lo, hi = map(float, saturation_limits)
        if hi <= lo:
            # degenerate limits (e.g. [0, 0]): step from -P to 0 at lo
            hi = lo + 1e-10
        self.table = InterpolationTable(
            np.array([[lo, -float(pressure)], [hi, 0.0]])
        )

    def __call__(self, sl, t):
        return self.table.component(sl, 0)


class VanGenuchtenCP(CapillaryPressure):
    """van Genuchten capillary pressure
    (capillary_pressure.F90:274-305)."""

    name = "van_genuchten"

    def __init__(self, P0=0.125e5, lam=0.45, slr=1e-3, sls=1.0, Pmax=None):
        self.P0 = float(P0)
        self.lam = float(lam)
        self.slr = float(slr)
        self.sls = float(sls)
        self.apply_Pmax = Pmax is not None
        self.Pmax = abs(float(Pmax)) if Pmax is not None else 0.0

    def __call__(self, sl, t):
        eps = 1e-3
        sstar = (sl - self.slr) / (self.sls - self.slr)
        ss = clip(sstar, 1e-10, 1.0 - 1e-14)
        cp_mid = -self.P0 * (ss ** (-1.0 / self.lam) - 1.0) ** (
            1.0 - self.lam)
        cp = torch.where(
            sstar < 0.0, torch.full_like(sl, -self.Pmax),
            torch.where(sstar < 1.0, cp_mid, torch.zeros_like(sl)),
        )
        cp = minimum(cp, 0.0)
        if self.apply_Pmax:
            cp = maximum(cp, -self.Pmax)
        cp = torch.where(sl > 1.0 - eps, cp * (1.0 - sl) / eps, cp)
        return torch.where(sl < 1.0, cp, torch.zeros_like(sl))


class TableCP(CapillaryPressure):
    """Tabulated cp(sl) (capillary_pressure.F90:324-356)."""

    name = "table"

    def __init__(self, pressure, interpolation="linear"):
        self.table = InterpolationTable(np.asarray(pressure),
                                        interpolation=interpolation)

    def __call__(self, sl, t):
        return self.table.component(sl, 0)


def from_json(spec: dict | None) -> CapillaryPressure:
    """Construct from the JSON 'rock.capillary_pressure' object
    (capillary_pressure.F90:380-453)."""
    if not spec:
        return Zero()
    kind = spec.get("type", "zero").lower().replace(" ", "_").replace(
        "-", "_"
    )
    if kind == "zero":
        return Zero()
    if kind == "linear":
        return LinearCP(
            spec.get("saturation_limits", [0.0, 1.0]),
            spec.get("pressure", 0.125e5),
        )
    if kind == "van_genuchten":
        return VanGenuchtenCP(
            spec.get("P0", 0.125e5),
            spec.get("lambda", 0.45),
            spec.get("slr", 1e-3),
            spec.get("sls", 1.0),
            spec.get("Pmax", None),
        )
    if kind == "table":
        return TableCP(
            spec.get("pressure", [[0.0, 0.0], [1.0, 0.0]]),
            spec.get("interpolation", "linear"),
        )
    raise ValueError(f"unknown capillary pressure type: {kind!r}")
