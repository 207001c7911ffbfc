"""Source network: the part the flagship model uses (counterpart of
waiwera_tpu/sim/network.py).

Sources with a scalar rate and enthalpy, deliverability producers with
a scalar productivity (or one computed from an initial rate) and a
scalar or 'initial' reference pressure, and direction controls. The
update is a pure function of the fluid state, traced into the residual
so that deliverability rates enter the Jacobian's diagonal blocks.

Deliverability (source_control.F90:359-403):
  q = -PI * permeability_factor * sum_p mobility_p * (P - Pref)

Tables, recharge, separators, limiters, tracers, groups and reinjectors
raise NotImplementedError (ROADMAP A13).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np
import torch

from waiwera_tpu_torch.sim.sources import (
    SourceArrays,
    SourceCellState,
    gather_cell_state,
)
from waiwera_tpu_torch.tensors import const_like

# directions (source_control.F90:38-40)
DIR_BOTH, DIR_PRODUCTION, DIR_INJECTION = 0, 1, 2

DEFAULT_PRODUCTIVITY = 1.0e-11
DEFAULT_REFERENCE_PRESSURE = 1.0e5
DEFAULT_INJECTION_ENTHALPY = 83.9e3

# source keys of the ported subset; any other key raises
_SOURCE_KEYS = {
    "name", "cell", "cells", "zones", "component", "direction", "rate", "enthalpy",
    "deliverability", "interpolation", "averaging",
}
_DELIVERABILITY_KEYS = {"productivity", "pressure", "threshold"}
# keys of controls that are not ported (ROADMAP A13): a source that has
# one is refused with the other unknown keys; they are still read, in the
# JAX package's order, so that a tracked config logs the same defaults
_UNPORTED_SOURCE_KEYS = ("injectivity", "recharge", "separator", "limiter",
                         "tracer")


def _direction_from_str(s) -> int:
    s = str(s).lower()
    if s in ("production", "out"):
        return DIR_PRODUCTION
    if s in ("injection", "in"):
        return DIR_INJECTION
    return DIR_BOTH


def _scalar(value, what: str) -> float:
    if isinstance(value, (list, tuple, dict, np.ndarray)):
        raise NotImplementedError(
            f"source {what} tables are not ported yet (ROADMAP A13)"
        )
    return float(value)


@dataclass
class _SourceSpec:
    """Per-source host data (one per cell for multi-cell specs)."""

    name: str = ""
    cell: int = 0
    inj_component: int = 1
    prod_component: int = 0
    base_rate: float = 0.0
    base_enthalpy: float = DEFAULT_INJECTION_ENTHALPY
    direction: int = DIR_BOTH
    deliv: bool = False
    deliv_pi: float = DEFAULT_PRODUCTIVITY
    deliv_pi_from_rate: bool = False
    deliv_pref_initial: bool = False
    deliv_pref: float = DEFAULT_REFERENCE_PRESSURE


class SourceNetwork:
    """Parses the JSON 'source' section and provides the pure update
    `flows(fluid, t0, t1)` (source_setup.F90 + source_network.F90)."""

    def __init__(self, specs: List[dict], network_cfg: dict, mesh, eos,
                 thermo, device="cpu", zones=None):
        if network_cfg:
            raise NotImplementedError(
                "source network groups and reinjectors are not ported yet "
                "(ROADMAP A13)"
            )
        self.eos = eos
        self.thermo = thermo
        self.isothermal = eos.isothermal
        self.specs: List[_SourceSpec] = []
        cells_list = []
        for i, spec in enumerate(specs):
            extra = set(spec) - _SOURCE_KEYS
            if extra:
                raise NotImplementedError(
                    f"source {i}: keys {sorted(extra)} are not ported yet "
                    "(ROADMAP A13)"
                )
            cells = (
                [int(spec["cell"])]
                if "cell" in spec and spec["cell"] is not None
                else [int(c) for c in np.atleast_1d(spec.get("cells") or [])]
            )
            # zone-based placement (source_setup.F90:250-345): a source
            # in each cell of every listed zone, besides any cells
            znames = spec.get("zones", []) or []
            if isinstance(znames, str):
                znames = [znames]
            for zn in znames:
                if not zones or zn not in zones:
                    raise ValueError(f"source {i}: unknown zone {zn!r}")
                cells.extend(int(c) for c in np.asarray(zones[zn]))
            if not cells:
                raise ValueError(f"source {i}: no cell given")
            # table options: read as the reference reads them; they act
            # on rate tables only, which are not ported
            spec.get("interpolation", "linear")
            spec.get("averaging", "integrate")
            for c in cells:
                s = _SourceSpec(name=spec.get("name", f"source {i}"), cell=c)
                self._parse_source(s, spec)
                self.specs.append(s)
                cells_list.append(c)

        self.num_sources = len(self.specs)
        cells = np.asarray(cells_list, np.int64)
        self.arrays = SourceArrays(
            cell=torch.as_tensor(cells, device=device),
            injection_component=torch.as_tensor(
                [s.inj_component for s in self.specs], dtype=torch.int64,
                device=device,
            ),
            production_component=torch.as_tensor(
                [s.prod_component for s in self.specs], dtype=torch.int64,
                device=device,
            ),
            volume=torch.as_tensor(mesh.cell_volume[cells],
                                   dtype=torch.float64, device=device),
        )
        self._direction = torch.as_tensor(
            [s.direction for s in self.specs], device=device
        )
        deliv_mask = [s.deliv for s in self.specs]
        self._deliv_mask = torch.as_tensor(deliv_mask, device=device)
        self.has_deliv = any(deliv_mask)
        self._base_rate = np.asarray([s.base_rate for s in self.specs])
        self._base_enthalpy = np.asarray(
            [s.base_enthalpy for s in self.specs]
        )
        self._pref_initial = np.full(self.num_sources,
                                     DEFAULT_REFERENCE_PRESSURE)
        self._pi_from_rate = np.zeros(self.num_sources)
        self._set_deliverability_tables()

    def _parse_source(self, s: _SourceSpec, spec: dict):
        comp = int(spec.get("component", 0))
        s.inj_component = comp if comp > 0 else 1
        s.prod_component = comp
        if "direction" in spec:
            s.direction = _direction_from_str(spec["direction"])
        if "rate" in spec and spec["rate"] is not None:
            s.base_rate = _scalar(spec["rate"], "rate")
        if "enthalpy" in spec and spec["enthalpy"] is not None:
            s.base_enthalpy = _scalar(spec["enthalpy"], "enthalpy")
        deliv = spec.get("deliverability")
        if deliv is not None:
            s.deliv = True
            if not isinstance(deliv, dict):
                deliv = {}
            extra = set(deliv) - _DELIVERABILITY_KEYS
            if extra:
                raise NotImplementedError(
                    f"deliverability keys {sorted(extra)} are not ported "
                    "yet (ROADMAP A13)"
                )
            # read as the JAX package reads it; it acts nowhere there
            float(deliv.get("threshold", -1.0))
            pref = deliv.get("pressure")
            if isinstance(pref, str):
                s.deliv_pref_initial = True
            elif pref is not None:
                s.deliv_pref = _scalar(pref, "reference pressure")
            prod = deliv.get("productivity")
            if prod is None:
                # PI from the initial rate (source_control.F90:408-470)
                s.deliv_pi_from_rate = True
            else:
                s.deliv_pi = _scalar(prod, "productivity")
        for key in _UNPORTED_SOURCE_KEYS:
            spec.get(key)

    def _set_deliverability_tables(self):
        self._deliv_pi = np.asarray([
            self._pi_from_rate[i] if s.deliv_pi_from_rate else s.deliv_pi
            for i, s in enumerate(self.specs)
        ])
        self._deliv_pref = np.asarray([
            self._pref_initial[i] if s.deliv_pref_initial else s.deliv_pref
            for i, s in enumerate(self.specs)
        ])

    # -- initial-state-dependent setup --------------------------------

    def finalize(self, fluid0):
        """PI-from-rate and 'initial' reference pressures from the
        initial fluid state (source_setup.F90:2893-2917,
        source_control.F90:408-470)."""
        cells = self.arrays.cell
        P0 = fluid0.pressure[cells].cpu().numpy()
        mob = fluid0.mobility()[cells].sum(dim=1).cpu().numpy()
        pf = fluid0.permeability_factor[cells].cpu().numpy()
        self._pref_initial = P0.copy()
        for i, s in enumerate(self.specs):
            if s.deliv and s.deliv_pi_from_rate:
                pref = P0[i] if s.deliv_pref_initial else s.deliv_pref
                factor = mob[i] * (P0[i] - pref) * pf[i]
                if abs(factor) > 1e-9:
                    self._pi_from_rate[i] = abs(s.base_rate) / factor
                else:
                    self._pi_from_rate[i] = DEFAULT_PRODUCTIVITY
        self._set_deliverability_tables()

    # -- the pure update ----------------------------------------------

    def flows(self, fluid, t0, t1, collect=None):
        """Returns (rate [ns], enthalpy [ns]): signed source rates and
        effective (injection or flowing) enthalpies. A dict passed as
        `collect` receives the separated water and steam flows for
        output (zero without separators)."""
        return self.flows_from_state(
            gather_cell_state(fluid, self.arrays.cell), t0, t1,
            collect=collect,
        )

    def flows_from_state(self, state: SourceCellState, t0, t1,
                         collect=None):
        """The network update on the gathered per-source state
        (non-network branch: no separators, limiters or groups)."""
        P = state.pressure
        q = const_like(self._base_rate, P)
        h_inj = const_like(self._base_enthalpy, P)
        pf = state.permeability_factor
        if self.isothermal:
            h_flow = torch.zeros_like(P)
        else:
            h_flow = torch.sum(
                state.phase_flow_fractions * state.specific_enthalpy, dim=-1
            )

        if self.has_deliv:
            mob_tot = torch.sum(state.mobility, dim=-1)
            pi = const_like(self._deliv_pi, P)
            pref = const_like(self._deliv_pref, P)
            qd = -pi * pf * mob_tot * (P - pref)
            q = torch.where(self._deliv_mask, qd, q)

        # direction control (source_control.F90:597-619)
        direction = self._direction
        q = torch.where((direction == DIR_PRODUCTION) & (q > 0.0), 0.0, q)
        q = torch.where((direction == DIR_INJECTION) & (q < 0.0), 0.0, q)

        h_eff = torch.where(q >= 0.0, h_inj, h_flow)
        if collect is not None:
            z = torch.zeros_like(q)
            collect["separated"] = (z, z, z, z)
        return q, h_eff
