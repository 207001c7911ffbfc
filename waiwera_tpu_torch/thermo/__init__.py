"""Thermodynamics formulations (counterpart of waiwera_tpu/thermo)."""

from waiwera_tpu_torch.thermo.base import Thermodynamics
from waiwera_tpu_torch.thermo.iapws97 import IAPWS97


def from_name(name: str) -> Thermodynamics:
    """Thermodynamics backend selection by JSON name
    (thermodynamics_setup.F90:18-95)."""
    key = name.strip().lower()
    if key in ("iapws", "iapws97", "iapws-97"):
        return IAPWS97()
    if key in ("ifc67", "ifc-67"):
        from waiwera_tpu_torch.thermo.ifc67 import IFC67

        return IFC67()
    raise ValueError(f"unknown thermodynamics: {name!r}")
