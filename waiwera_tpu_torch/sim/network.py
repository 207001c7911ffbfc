"""Source network: controls, separators, groups and reinjectors
(counterpart of waiwera_tpu/sim/network.py; source_control.F90,
separator.F90, source_network_node.F90, source_network_group.F90,
source_network_reinjector.F90, source_network.F90, source_setup.F90).

The reference updates the network mutably inside every residual
evaluation; here the whole update is a pure function of the fluid state,
evaluated inside the residual and the Jacobian's tangent chain:

- per-source controls (rate, enthalpy and rate-factor tables,
  deliverability, recharge and injectivity, direction) are vectorised
  over sources: constant arrays plus batched table stacks
  (utils.interpolation.StackedTables), so `flows` is the same sequence
  of tensor operations whatever the number of sources;
- separators are closed-form (steam fraction from enthalpy at the
  separator pressure, separator.F90:141-166), with the stages' reference
  enthalpies computed on the host at construction;
- groups and reinjectors are small scalar DAGs, unrolled in Python in a
  topological order fixed at construction; a group's member sums and its
  progressive scaling are segment sums over its descendant sources, so
  their cost does not grow with the group's size;
- group scales and reinjected rates and enthalpies are detached, so the
  block Jacobian keeps only cell-local source derivatives (the JAX
  package's stop_gradient). The Jacobian seeds every cell at once
  (solver/system.py), which is valid only because every term left
  attached to the tangent chain is cell-local.

Deliverability (source_control.F90:359-403):
  q = -PI * permeability_factor * sum_p mobility_p * (P - Pref)
with PI from a value or table, or computed from an initial rate
(:408-470), and Pref constant, 'initial', or a table against time,
enthalpy or pressure. Recharge (:516-577): q = -coeff * (P - Pref).
No value crosses to the host inside `flows`.
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from waiwera_tpu_torch.ops.segment import SegmentSum
from waiwera_tpu_torch.sim.sources import (
    SourceArrays,
    SourceCellState,
    gather_cell_state,
)
from waiwera_tpu_torch.tensors import const_like, maximum, minimum
from waiwera_tpu_torch.utils.interpolation import (
    InterpolationTable,
    scalar_like,
    build_sparse_updates,
    from_json as table_from_json,
)

# flow types (separator.F90:30-31)
FLOW_TOTAL, FLOW_WATER, FLOW_STEAM = 0, 1, 2
# directions (source_control.F90:38-40)
DIR_BOTH, DIR_PRODUCTION, DIR_INJECTION = 0, 1, 2
# reference pressure coordinate (source_control.F90:41-43)
PREF_TIME, PREF_ENTHALPY, PREF_PRESSURE, PREF_INITIAL = 0, 1, 2, 3

DEFAULT_PRODUCTIVITY = 1.0e-11
DEFAULT_REFERENCE_PRESSURE = 1.0e5
DEFAULT_RECHARGE_COEFFICIENT = 1.0e-2
DEFAULT_SEPARATOR_PRESSURE = 0.55e6
DEFAULT_INJECTION_ENTHALPY = 83.9e3
RATE_TOL = 1.0e-9
LIMIT_SMALL = 1.0e-6


def _direction_from_str(s) -> int:
    s = str(s).lower()
    if s in ("production", "out"):
        return DIR_PRODUCTION
    if s in ("injection", "in"):
        return DIR_INJECTION
    return DIR_BOTH


def _scalar_or_table(value, spec, default):
    """(constant, table or None)."""
    if value is None:
        return float(default), None
    if isinstance(value, (int, float)):
        return float(value), None
    return 0.0, table_from_json(value, spec)


def _table_average(table: InterpolationTable, t0, t1, like) -> torch.Tensor:
    """0-d average of a one-column time table over [t0, t1], in the dtype
    and on the device of `like`."""
    return table.average(scalar_like(t0, like), scalar_like(t1, like))[0]


def _safe_ratio(num, den):
    """num / den where |den| > RATE_TOL, else 0 (a mass-weighted
    enthalpy of a negligible flow)."""
    nz = torch.abs(den) > RATE_TOL
    return torch.where(nz, num / torch.where(nz, den, 1.0), 0.0)


def _flash_stage(h, hw_ref, hs_ref):
    """One separator flash stage (separator.F90:141-166): the steam
    fraction from the inflow enthalpy against the stage's saturated
    water and steam reference enthalpies, and the stage's outflow water
    and steam enthalpies. Shared by the scalar node separator
    (_Separator.separate) and the per-source path
    (SourceNetwork._separated). The reference enthalpies are tensors
    or numbers."""
    if not isinstance(hw_ref, torch.Tensor):
        hw_ref, hs_ref = h.new_full((), hw_ref), h.new_full((), hs_ref)
    sf = torch.where(
        h <= hw_ref,
        0.0,
        torch.where(
            h <= hs_ref,
            (h - hw_ref)
            / torch.where(hs_ref > hw_ref, hs_ref - hw_ref, 1.0),
            1.0,
        ),
    )
    hs = torch.where(h <= hw_ref, 0.0, torch.where(h <= hs_ref, hs_ref, h))
    hw = torch.where(h <= hw_ref, h, torch.where(h <= hs_ref, hw_ref, 0.0))
    return sf, hw, hs


@dataclass
class _Separator:
    """Separator stages: pressures and the reference enthalpies computed
    on the host from the water thermodynamics (separator.F90:113-136)."""

    on: bool = False
    pressures: List[float] = field(default_factory=list)
    ref_water_h: List[float] = field(default_factory=list)
    ref_steam_h: List[float] = field(default_factory=list)

    @staticmethod
    def build(pressures, thermo) -> "_Separator":
        if pressures is None:
            return _Separator()
        pressures = [float(p) for p in np.atleast_1d(pressures)]
        if any(p <= 0 for p in pressures):
            return _Separator()
        sep = _Separator(on=True, pressures=pressures)
        for p in pressures:
            pa = torch.tensor([p], dtype=torch.float64)
            ts, _ = thermo.saturation_temperature(pa)
            dw, uw, _ = thermo.water_properties(pa, ts)
            ds, us, _ = thermo.steam_properties(pa, ts)
            sep.ref_water_h.append(float(uw[0] + p / dw[0]))
            sep.ref_steam_h.append(float(us[0] + p / ds[0]))
        return sep

    def separate(self, q, h):
        """(q, h) -> (qw, hw, qs, hs), the rates keeping the sign of q
        (separator.F90:141-166, multi-stage :215-260)."""
        if not self.on:
            z = torch.zeros_like(q)
            return z, z, z, z
        steam_mass = torch.zeros_like(q)
        steam_energy = torch.zeros_like(q)
        for hw_ref, hs_ref in zip(self.ref_water_h, self.ref_steam_h):
            sf, hw, hs = _flash_stage(h, hw_ref, hs_ref)
            qs = sf * q
            steam_mass = steam_mass + qs
            steam_energy = steam_energy + qs * hs
            q = (1.0 - sf) * q
            h = hw
        return q, h, steam_mass, _safe_ratio(steam_energy, steam_mass)


@dataclass
class _Limiter:
    """Flow limits by type, each (constant, table or None); None means
    unlimited."""

    total: Optional[Tuple[float, Optional[InterpolationTable]]] = None
    water: Optional[Tuple[float, Optional[InterpolationTable]]] = None
    steam: Optional[Tuple[float, Optional[InterpolationTable]]] = None

    @staticmethod
    def parse(cfg, spec) -> Optional["_Limiter"]:
        if not cfg:
            return None
        lim = _Limiter()
        if "limit" in cfg:
            ftype = str(cfg.get("type", "total")).lower()
            setattr(lim, ftype if ftype in ("water", "steam") else "total",
                    _scalar_or_table(cfg["limit"], spec, 1.0))
        for key in ("total", "water", "steam"):
            if key in cfg:
                setattr(lim, key, _scalar_or_table(cfg[key], spec, 1.0))
        return lim

    def limits_at(self, t0, t1, like) -> Dict[int, object]:
        """{flow type: limit} over [t0, t1]: a number, or a 0-d tensor
        for a table."""
        out = {}
        for ft, entry in ((FLOW_TOTAL, self.total), (FLOW_WATER, self.water),
                          (FLOW_STEAM, self.steam)):
            if entry is None:
                continue
            const, tab = entry
            out[ft] = (_table_average(tab, t0, t1, like) if tab is not None
                       else const)
        return out

    @staticmethod
    def separator_pressure(cfg):
        """A water or steam limiter with separator_pressure implies a
        separator on the node (source_setup.F90:2255-2310)."""
        if not cfg:
            return None
        ftype = str(cfg.get("type", "")).lower()
        typed = ("water" in cfg) or ("steam" in cfg) or ftype in (
            "water", "steam"
        )
        if typed and "separator_pressure" in cfg:
            return cfg["separator_pressure"]
        return None


def _limit_scale(rates: Dict[int, torch.Tensor], limits: Dict[int, object]):
    """min over the limited flow types of limit / |rate|, 1 where under
    the limit (source_network_node.F90:247-300)."""
    scale = None
    for ft, limit in limits.items():
        r = torch.abs(rates[ft])
        s = torch.where(
            r > limit,
            torch.where(r > LIMIT_SMALL, limit / maximum(r, LIMIT_SMALL), 1.0),
            1.0,
        )
        scale = s if scale is None else minimum(scale, s)
    return scale


@dataclass
class _SourceSpec:
    """Per-source host data (one per cell for multi-cell specs)."""

    name: str = ""
    cell: int = 0
    inj_component: int = 1
    prod_component: int = 0
    rate_specified: bool = False
    base_rate: float = 0.0
    rate_table: Optional[InterpolationTable] = None
    enthalpy_specified: bool = False
    base_enthalpy: float = DEFAULT_INJECTION_ENTHALPY
    enthalpy_table: Optional[InterpolationTable] = None
    rate_factor_table: Optional[InterpolationTable] = None
    direction: int = DIR_BOTH
    # deliverability
    deliv: bool = False
    deliv_pi: float = DEFAULT_PRODUCTIVITY
    deliv_pi_table: Optional[InterpolationTable] = None
    deliv_pi_from_rate: bool = False
    deliv_pref_mode: int = PREF_TIME
    deliv_pref: float = DEFAULT_REFERENCE_PRESSURE
    deliv_pref_table: Optional[InterpolationTable] = None
    deliv_threshold: float = -1.0
    # recharge / injectivity
    recharge: bool = False
    recharge_coeff: float = DEFAULT_RECHARGE_COEFFICIENT
    recharge_coeff_table: Optional[InterpolationTable] = None
    recharge_pref_mode: int = PREF_TIME
    recharge_pref: float = DEFAULT_REFERENCE_PRESSURE
    recharge_pref_table: Optional[InterpolationTable] = None
    # separator / limiter
    separator: _Separator = field(default_factory=_Separator)
    limiter: Optional[_Limiter] = None
    # tracer injection rates, one (constant, table) per tracer
    tracer_rates: List[Tuple[float, Optional[InterpolationTable]]] = field(
        default_factory=list
    )


@dataclass
class _Group:
    name: str
    members: List[str]
    separator: _Separator
    limiter: Optional[_Limiter]
    scaling: str  # 'uniform' | 'progressive'
    descendant_sources: List[int] = field(default_factory=list)
    member_descendants: List[List[int]] = field(default_factory=list)


@dataclass
class _ReinjectorOutput:
    target: str  # source or reinjector name
    flow_type: int  # FLOW_WATER or FLOW_STEAM
    kind: str  # 'rate' | 'proportion' | 'remaining'
    value: float = 0.0
    table: Optional[InterpolationTable] = None
    enthalpy: float = -1.0  # < 0: the input enthalpy


@dataclass
class _Reinjector:
    name: str
    input: Optional[str]  # node name; None when fed by an overflow
    outputs: List[_ReinjectorOutput]
    overflow: Optional[str]  # name of the overflow reinjector


class NodeFlows:
    """Per-node scalar flows during an update."""

    __slots__ = ("q", "h", "qw", "hw", "qs", "hs")

    def __init__(self, q, h, qw, hw, qs, hs):
        self.q, self.h = q, h
        self.qw, self.hw, self.qs, self.hs = qw, hw, qs, hs


class SourceNetwork:
    """Parses the JSON 'source' and 'network' sections and provides the
    pure update `flows(fluid, t0, t1)`.

    The update follows source_network_update (source_network.F90:91-127):
    separators -> source controls -> groups -> network controls
    (limiters) -> reinjector capacities -> reinjector distribution."""

    def __init__(self, specs: List[dict], network_cfg: dict, mesh, eos,
                 thermo, tracer_names=(), device="cpu", zones=None):
        self.eos = eos
        self.thermo = thermo
        self.isothermal = eos.isothermal
        self.device = torch.device(device)
        self.tracer_names = [str(n).lower() for n in tracer_names]
        self.specs: List[_SourceSpec] = []
        self.names: List[str] = []
        cells_list = []
        for i, spec in enumerate(specs):
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
            ispec = {
                "interpolation": spec.get("interpolation", "linear"),
                "averaging": spec.get("averaging", "integrate"),
            }
            for c in cells:
                s = _SourceSpec(name=spec.get("name", f"source {i}"), cell=c)
                self._parse_source(s, spec, ispec)
                self.specs.append(s)
                self.names.append(s.name)
                cells_list.append(c)

        self.num_sources = ns = len(self.specs)
        cells = np.asarray(cells_list, np.int64)

        def dev(a, dtype=None):
            return torch.as_tensor(np.asarray(a), dtype=dtype,
                                   device=self.device)

        self.arrays = SourceArrays(
            cell=dev(cells, torch.int64),
            injection_component=dev(
                [s.inj_component for s in self.specs], torch.int64),
            production_component=dev(
                [s.prod_component for s in self.specs], torch.int64),
            volume=dev(mesh.cell_volume[cells], torch.float64),
            cell_sum=SegmentSum(cells, mesh.num_cells, self.device),
        )
        self.rate_specified = np.asarray(
            [s.rate_specified for s in self.specs], bool)
        self.enthalpy_specified = np.asarray(
            [s.enthalpy_specified for s in self.specs], bool)
        self.deliv_mask = np.asarray([s.deliv for s in self.specs], bool)
        self.recharge_mask = np.asarray([s.recharge for s in self.specs],
                                        bool)
        self._direction = dev([s.direction for s in self.specs], torch.int64)
        self._deliv_mask = dev(self.deliv_mask)
        self._recharge_mask = dev(self.recharge_mask)
        self.has_deliv = bool(self.deliv_mask.any())
        self.has_recharge = bool(self.recharge_mask.any())
        self.has_separators = any(s.separator.on for s in self.specs)
        self.has_limiters = any(s.limiter is not None for s in self.specs)
        # values filled by finalize()
        self._pi_from_rate = np.zeros(ns)
        self._pref_initial = np.full(ns, DEFAULT_REFERENCE_PRESSURE)

        self._parse_network(network_cfg or {})
        self.has_network = bool(self.groups or self.reinjectors)
        self._build_stacks()

    def _build_stacks(self):
        """Constant per-source arrays and batched table stacks, so that
        `flows` is vectorised over sources: no Python loop over sources
        runs inside the residual."""
        specs = self.specs
        ns = self.num_sources
        dev = self.device
        self._base_rate = np.asarray([s.base_rate for s in specs])
        self._base_enthalpy = np.asarray([s.base_enthalpy for s in specs])
        self._upd_rate = build_sparse_updates(
            [(i, s.rate_table) for i, s in enumerate(specs)])
        self._upd_enthalpy = build_sparse_updates(
            [(i, s.enthalpy_table) for i, s in enumerate(specs)])
        self._upd_rate_factor = build_sparse_updates(
            [(i, s.rate_factor_table) for i, s in enumerate(specs)])
        self._ones = np.ones(ns)
        self._set_deliverability()
        self._upd_deliv_pi = build_sparse_updates(
            [(i, s.deliv_pi_table) for i, s in enumerate(specs)])
        self._recharge_coeff_base = np.asarray(
            [s.recharge_coeff for s in specs])
        self._upd_recharge_coeff = build_sparse_updates(
            [(i, s.recharge_coeff_table) for i, s in enumerate(specs)])
        # reference pressures: a constant base per prefix ('initial'
        # substituted by finalize()), then table updates by abscissa
        self._pref_updates = {}
        for prefix in ("deliv", "recharge"):
            by_mode = {PREF_TIME: [], PREF_ENTHALPY: [], PREF_PRESSURE: []}
            for i, s in enumerate(specs):
                tab = getattr(s, f"{prefix}_pref_table")
                mode = getattr(s, f"{prefix}_pref_mode")
                if tab is not None and mode in by_mode:
                    by_mode[mode].append((i, tab))
            self._pref_updates[prefix] = {
                m: build_sparse_updates(lst) for m, lst in by_mode.items()
            }
        self._set_pref_base()
        # separators: stages stacked to [ns, max_stages]
        max_st = max([len(s.separator.pressures) for s in specs] + [1])
        self._sep_hw = np.zeros((ns, max_st))
        self._sep_hs = np.ones((ns, max_st))
        sep_stage = np.zeros((ns, max_st), bool)
        for i, s in enumerate(specs):
            st = len(s.separator.pressures)
            if s.separator.on and st:
                self._sep_hw[i, :st] = s.separator.ref_water_h
                self._sep_hs[i, :st] = s.separator.ref_steam_h
                sep_stage[i, :st] = True
        self._sep_stage = torch.as_tensor(sep_stage, device=dev)
        self._sep_on = torch.as_tensor(
            np.asarray([s.separator.on for s in specs], bool), device=dev)
        # per-source limiters: [ns * 3] constants (inf = unlimited) and
        # table updates into the flattened array
        lim_const = np.full((ns, 3), np.inf)
        lim_tabs = []
        for i, s in enumerate(specs):
            if s.limiter is None:
                continue
            for ft, entry in ((FLOW_TOTAL, s.limiter.total),
                              (FLOW_WATER, s.limiter.water),
                              (FLOW_STEAM, s.limiter.steam)):
                if entry is None:
                    continue
                const, tab = entry
                if tab is None:
                    lim_const[i, ft] = const
                else:
                    lim_const[i, ft] = 0.0
                    lim_tabs.append((i * 3 + ft, tab))
        self._lim_const = lim_const.reshape(-1)
        self._upd_limits = build_sparse_updates(lim_tabs)
        self._lim_any = torch.as_tensor(
            np.isfinite(lim_const).any(axis=1), device=dev)
        # tracer injection rates: [ns * nt] constants and table updates
        nt = max(len(self.tracer_names), 1)
        tr_const = np.zeros((ns, nt))
        tr_tabs = []
        for i, s in enumerate(specs):
            for k, (c, tab) in enumerate(s.tracer_rates):
                tr_const[i, k] = c
                if tab is not None:
                    tr_tabs.append((i * nt + k, tab))
        self._tracer_const = tr_const.reshape(-1)
        self._upd_tracer = build_sparse_updates(tr_tabs)
        self._build_network_indices()

    def _set_deliverability(self):
        self._deliv_pi_base = np.asarray([
            self._pi_from_rate[i] if s.deliv_pi_from_rate else s.deliv_pi
            for i, s in enumerate(self.specs)
        ])

    def _set_pref_base(self):
        self._pref_base = {
            prefix: np.where(
                np.asarray([getattr(s, f"{prefix}_pref_mode") == PREF_INITIAL
                            for s in self.specs], bool),
                self._pref_initial,
                np.asarray([getattr(s, f"{prefix}_pref") for s in self.specs]),
            )
            for prefix in ("deliv", "recharge")
        }

    def _build_network_indices(self):
        """Device index tensors of the group and reinjector DAG: each
        group's descendant sources and, for its scaling, the member each
        descendant belongs to; each reinjector output's target sources."""
        dev = self.device
        ns = self.num_sources

        def idx(a):
            return torch.as_tensor(np.asarray(a, np.int64), device=dev)

        self._group_index = {}
        for g in self.groups:
            slot = np.full(ns, len(g.member_descendants), np.int64)
            member = []
            for k, mm in enumerate(g.member_descendants):
                slot[mm] = k
                member.extend([k] * len(mm))
            desc = np.asarray(g.descendant_sources, np.int64)
            mask = np.zeros(ns, bool)
            mask[desc] = True
            self._group_index[g.name] = (
                idx(desc),
                SegmentSum(member, len(g.member_descendants), dev),
                idx(slot),
                torch.as_tensor(mask, device=dev),
            )
        self._target_index = {}
        for r in self.reinjectors:
            for o in r.outputs:
                if o.target in self._name_to_idx:
                    ii = self._name_to_idx[o.target]
                    free_h = [i for i in ii if not self.specs[i].enthalpy_specified]
                    self._target_index[o.target] = (idx(ii), idx(free_h))
        self._input_index = {
            r.input: idx(self._name_to_idx[r.input])
            for r in self.reinjectors
            if r.input is not None and r.input in self._name_to_idx
        }

    # -- parsing ------------------------------------------------------

    def _parse_source(self, s: _SourceSpec, spec: dict, ispec: dict):
        comp = int(spec.get("component", 0))
        s.inj_component = comp if comp > 0 else 1
        s.prod_component = comp
        if "direction" in spec:
            s.direction = _direction_from_str(spec["direction"])

        if "rate" in spec and spec["rate"] is not None:
            s.rate_specified = True
            r = spec["rate"]
            if isinstance(r, (list, np.ndarray)):
                s.rate_table = table_from_json(r, ispec)
            else:
                s.base_rate = float(r)
        if "enthalpy" in spec and spec["enthalpy"] is not None:
            s.enthalpy_specified = True
            h = spec["enthalpy"]
            if isinstance(h, (list, np.ndarray)):
                s.enthalpy_table = table_from_json(h, ispec)
            else:
                s.base_enthalpy = float(h)
        if "rate_factor" in spec and spec["rate_factor"] is not None:
            s.rate_factor_table = table_from_json(spec["rate_factor"], ispec)

        deliv = spec.get("deliverability")
        if deliv is not None:
            s.deliv = True
            s.rate_specified = True
            if not isinstance(deliv, dict):
                deliv = {}
            s.deliv_threshold = float(deliv.get("threshold", -1.0))
            if "threshold" in deliv:
                # ROADMAP C14: read and kept as the JAX package keeps
                # it, but no rule applies it
                warnings.warn(
                    f"source {s.name!r}: deliverability.threshold is read "
                    "but not applied (the production rate ignores it)",
                    stacklevel=2)
            self._parse_pref(s, deliv, "deliv", ispec)
            prod = deliv.get("productivity")
            if prod is None:
                s.deliv_pi_from_rate = s.rate_specified
                s.deliv_pi = DEFAULT_PRODUCTIVITY
            elif isinstance(prod, dict):
                s.deliv_pi_table = table_from_json(prod.get("time", prod),
                                                   ispec)
            else:
                s.deliv_pi = float(prod)

        rech = spec.get("recharge", spec.get("injectivity"))
        if rech is not None:
            s.recharge = True
            s.rate_specified = True
            if not isinstance(rech, dict):
                rech = {}
            self._parse_pref(s, rech, "recharge", ispec)
            coeff = rech.get("coefficient")
            if coeff is None:
                s.recharge_coeff = DEFAULT_RECHARGE_COEFFICIENT
            elif isinstance(coeff, (list, np.ndarray)):
                s.recharge_coeff_table = table_from_json(coeff, ispec)
            else:
                s.recharge_coeff = float(coeff)

        sep_p = None
        sep_cfg = spec.get("separator")
        if sep_cfg is not None:
            if isinstance(sep_cfg, bool):
                sep_p = [DEFAULT_SEPARATOR_PRESSURE] if sep_cfg else None
            elif isinstance(sep_cfg, dict):
                sep_p = sep_cfg.get("pressure", DEFAULT_SEPARATOR_PRESSURE)
        lim_cfg = spec.get("limiter")
        if sep_p is None and lim_cfg:
            sep_p = _Limiter.separator_pressure(lim_cfg)
        s.separator = _Separator.build(sep_p, self.thermo)
        s.limiter = _Limiter.parse(lim_cfg, ispec)

        # tracer injection rates (source_setup get_tracer_injection_rate):
        # a scalar (every tracer), a list per tracer, or {name: rate};
        # each entry may be a time table
        nt = len(self.tracer_names)
        s.tracer_rates = [(0.0, None)] * nt
        tcfg = spec.get("tracer")
        if tcfg is not None and nt:
            def entry(v):
                if isinstance(v, (list, np.ndarray)) and np.ndim(v) == 2:
                    return (0.0, table_from_json(v, ispec))
                return (float(v), None)

            if isinstance(tcfg, dict):
                for name, v in tcfg.items():
                    if str(name).lower() in self.tracer_names:
                        k = self.tracer_names.index(str(name).lower())
                        s.tracer_rates[k] = entry(v)
            elif isinstance(tcfg, (list, np.ndarray)) and np.ndim(tcfg) == 1:
                for k, v in enumerate(tcfg):
                    if k < nt:
                        s.tracer_rates[k] = entry(v)
            else:
                s.tracer_rates = [entry(tcfg)] * nt

    def _parse_pref(self, s: _SourceSpec, cfg: dict, prefix: str,
                    ispec: dict):
        """Reference pressure: a number, 'initial', or a table against
        time, enthalpy or pressure (source_setup.F90:2667-2740)."""
        p = cfg.get("pressure")
        mode, const, table = PREF_TIME, DEFAULT_REFERENCE_PRESSURE, None
        if p is None:
            pass
        elif isinstance(p, str):
            mode = PREF_INITIAL
        elif isinstance(p, dict):
            if "enthalpy" in p:
                mode = PREF_ENTHALPY
                table = table_from_json(p["enthalpy"], ispec)
            elif "pressure" in p:
                mode = PREF_PRESSURE
                table = table_from_json(p["pressure"], ispec)
            else:
                table = table_from_json(p.get("time"), ispec)
        elif isinstance(p, (list, np.ndarray)):
            table = table_from_json(p, ispec)
        else:
            const = float(p)
        setattr(s, f"{prefix}_pref_mode", mode)
        setattr(s, f"{prefix}_pref", const)
        setattr(s, f"{prefix}_pref_table", table)

    def _parse_network(self, cfg: dict):
        self.groups: List[_Group] = []
        self.reinjectors: List[_Reinjector] = []
        ispec = {"interpolation": "linear", "averaging": "integrate"}

        raw_groups = cfg.get("group", []) or []
        if isinstance(raw_groups, dict):
            raw_groups = [raw_groups]
        group_specs = {}
        for g in raw_groups:
            sep_p = None
            sep_cfg = g.get("separator")
            if sep_cfg is not None:
                if isinstance(sep_cfg, bool):
                    sep_p = [DEFAULT_SEPARATOR_PRESSURE] if sep_cfg else None
                elif isinstance(sep_cfg, dict):
                    sep_p = sep_cfg.get("pressure",
                                        DEFAULT_SEPARATOR_PRESSURE)
            lim_cfg = g.get("limiter")
            if sep_p is None and lim_cfg:
                sep_p = _Limiter.separator_pressure(lim_cfg)
            grp = _Group(
                name=g.get("name", f"group {len(group_specs)}"),
                members=[str(m) for m in np.atleast_1d(g.get("in", []))],
                separator=_Separator.build(sep_p, self.thermo),
                limiter=_Limiter.parse(lim_cfg, ispec),
                scaling=str(g.get("scaling", "uniform")).lower(),
            )
            group_specs[grp.name] = grp

        # topological order: members before the group (dag.F90)
        placed = set()
        order: List[_Group] = []
        pending = list(group_specs.values())
        while pending:
            progressed = False
            rest = []
            for g in pending:
                if all(m in placed for m in g.members if m in group_specs):
                    order.append(g)
                    placed.add(g.name)
                    progressed = True
                else:
                    rest.append(g)
            if not progressed:
                raise ValueError("cyclic source network group structure")
            pending = rest
        self.groups = order

        # descendant source indices per group (for scaling)
        name_to_idx: Dict[str, List[int]] = {}
        for i, nm in enumerate(self.names):
            name_to_idx.setdefault(nm, []).append(i)
        group_desc: Dict[str, List[int]] = {}
        for g in self.groups:
            desc: List[int] = []
            per_member: List[List[int]] = []
            for m in g.members:
                if m in group_desc:
                    mm = list(group_desc[m])
                elif m in name_to_idx:
                    mm = list(name_to_idx[m])
                else:
                    raise ValueError(f"unknown network node {m!r}")
                per_member.append(mm)
                desc.extend(mm)
            g.descendant_sources = desc
            g.member_descendants = per_member
            group_desc[g.name] = desc

        raw_re = cfg.get("reinject", []) or []
        if isinstance(raw_re, dict):
            raw_re = [raw_re]
        rein_specs: Dict[str, _Reinjector] = {}
        for r in raw_re:
            outputs = []
            for key, ftype in (("water", FLOW_WATER), ("steam", FLOW_STEAM)):
                for o in r.get(key, []) or []:
                    out = _ReinjectorOutput(target=str(o["out"]),
                                            flow_type=ftype,
                                            kind="remaining")
                    for kind in ("rate", "proportion"):
                        if kind in o:
                            v = o[kind]
                            out.kind = kind
                            if isinstance(v, (list, np.ndarray)):
                                out.table = table_from_json(v, ispec)
                            else:
                                out.value = float(v)
                            break
                    if "enthalpy" in o:
                        out.enthalpy = float(o["enthalpy"])
                    outputs.append(out)
            rj = _Reinjector(
                name=r.get("name", f"reinjector {len(rein_specs)}"),
                input=r.get("in"),
                outputs=outputs,
                overflow=r.get("overflow"),
            )
            rein_specs[rj.name] = rj

        # reinjectors in order, each after every reinjector that feeds
        # it (by its overflow or an output)
        feeders: Dict[str, List[str]] = {name: [] for name in rein_specs}
        for r in rein_specs.values():
            if r.overflow and r.overflow in rein_specs:
                feeders[r.overflow].append(r.name)
            for o in r.outputs:
                if o.target in rein_specs:
                    feeders[o.target].append(r.name)
        placed = set()
        order_r: List[_Reinjector] = []
        pending_r = list(rein_specs.values())
        while pending_r:
            progressed = False
            rest = []
            for r in pending_r:
                if all(f in placed for f in feeders[r.name]):
                    order_r.append(r)
                    placed.add(r.name)
                    progressed = True
                else:
                    rest.append(r)
            if not progressed:
                raise ValueError("cyclic reinjector structure")
            pending_r = rest
        self.reinjectors = order_r
        self._name_to_idx = name_to_idx

    # -- initial-state-dependent setup --------------------------------

    def finalize(self, fluid0):
        """PI-from-rate and 'initial' reference pressures from the
        initial fluid state (source_setup.F90:2893-2917,
        source_control.F90:408-470)."""
        cells = self.arrays.cell
        P0 = fluid0.pressure[cells].cpu().numpy()
        mob = fluid0.mobility()[cells].sum(dim=1).cpu().numpy()
        pf = fluid0.permeability_factor[cells].cpu().numpy()
        zero = torch.zeros((), dtype=torch.float64)
        self._pref_initial = P0.copy()
        for i, s in enumerate(self.specs):
            if s.deliv and s.deliv_pi_from_rate:
                if s.deliv_pref_mode == PREF_INITIAL:
                    pref = P0[i]
                elif (s.deliv_pref_table is not None
                      and s.deliv_pref_mode == PREF_TIME):
                    pref = float(s.deliv_pref_table(zero)[0])
                else:
                    pref = s.deliv_pref
                factor = mob[i] * (P0[i] - pref) * pf[i]
                rate = s.base_rate
                if s.rate_table is not None:
                    rate = float(s.rate_table(zero)[0])
                if abs(factor) > 1e-9:
                    self._pi_from_rate[i] = abs(rate) / factor
                else:
                    self._pi_from_rate[i] = DEFAULT_PRODUCTIVITY
        self._set_deliverability()
        self._set_pref_base()

    # -- the pure update ----------------------------------------------

    def flows(self, fluid, t0, t1, collect=None):
        """(rate [ns], enthalpy [ns]): signed source rates and effective
        (injection or flowing) enthalpies. A dict passed as `collect`
        receives the intermediate node flows for output: the separated
        water and steam flows, and the groups' and reinjectors' flows."""
        return self.flows_from_state(
            gather_cell_state(fluid, self.arrays.cell), t0, t1,
            collect=collect,
        )

    def flows_from_state(self, state: SourceCellState, t0, t1,
                         collect=None):
        """The network update on the gathered per-source cell state."""
        P = state.pressure
        q = const_like(self._base_rate, P)
        h_inj = const_like(self._base_enthalpy, P)
        for upd in self._upd_rate:
            q = upd.average_into(q, t0, t1)
        for upd in self._upd_enthalpy:
            h_inj = upd.average_into(h_inj, t0, t1)

        pf = state.permeability_factor
        if self.isothermal:
            h_flow = torch.zeros_like(P)
        else:
            h_flow = torch.sum(
                state.phase_flow_fractions * state.specific_enthalpy, dim=-1
            )

        if self.has_deliv:
            mob_tot = torch.sum(state.mobility, dim=-1)
            pi = const_like(self._deliv_pi_base, P)
            for upd in self._upd_deliv_pi:
                pi = upd.average_into(pi, t0, t1)
            pref = self._reference_pressure("deliv", t0, t1, h_flow, P)
            qd = -pi * pf * mob_tot * (P - pref)
            q = torch.where(self._deliv_mask, qd, q)

        if self.has_recharge:
            coeff = const_like(self._recharge_coeff_base, P)
            for upd in self._upd_recharge_coeff:
                coeff = upd.average_into(coeff, t0, t1)
            pref_r = self._reference_pressure("recharge", t0, t1, h_flow, P)
            qr = -coeff * (P - pref_r)
            q = torch.where(self._recharge_mask, qr, q)

        if self._upd_rate_factor:
            factor = const_like(self._ones, P)
            for upd in self._upd_rate_factor:
                factor = upd.average_into(factor, t0, t1)
            q = q * factor

        # direction control (source_control.F90:597-619)
        direction = self._direction
        q = torch.where((direction == DIR_PRODUCTION) & (q > 0.0), 0.0, q)
        q = torch.where((direction == DIR_INJECTION) & (q < 0.0), 0.0, q)

        h_eff = torch.where(q >= 0.0, h_inj, h_flow)

        if not (self.has_separators or self.has_limiters
                or self.has_network):
            if collect is not None:
                z = torch.zeros_like(q)
                collect["separated"] = (z, z, z, z)
            return q, h_eff

        qw, hw, qs, hs = self._separated(q, h_eff)

        # per-source limiters (source_network_node.F90:247-300): the
        # limit is inf where unlimited
        if self.has_limiters:
            limits = const_like(self._lim_const, P)
            for upd in self._upd_limits:
                limits = upd.average_into(limits, t0, t1)
            limits = limits.reshape(-1, 3)
            r = torch.abs(torch.stack([q, qw, qs], dim=1))  # [ns, 3]
            s = torch.where(
                (r > limits) & torch.isfinite(limits),
                torch.where(r > LIMIT_SMALL,
                            limits / maximum(r, LIMIT_SMALL), 1.0),
                1.0,
            )
            scale = torch.where(self._lim_any, torch.amin(s, dim=1), 1.0)
            q = q * scale
            qw = qw * scale
            qs = qs * scale

        if self.has_network:
            q, h_eff, qw, hw, qs, hs = self._network_update(
                q, h_eff, qw, hw, qs, hs, t0, t1, collect=collect
            )

        if collect is not None:
            collect["separated"] = (qw, hw, qs, hs)
        return q, h_eff

    def tracer_injection(self, t0, t1, like=None):
        """[ns, nt] tracer injection rates over [t0, t1], in the dtype and
        on the device of `like` (default: f64 on the network's device)."""
        if like is None:
            like = torch.zeros((), dtype=torch.float64, device=self.device)
        nt = len(self.tracer_names)
        out = const_like(self._tracer_const, like)
        for upd in self._upd_tracer:
            out = upd.average_into(out, t0, t1)
        return out.reshape(self.num_sources, -1)[:, :nt]

    def _reference_pressure(self, prefix, t0, t1, h_flow, P):
        pref = const_like(self._pref_base[prefix], P)
        upd = self._pref_updates[prefix]
        for u in upd[PREF_TIME]:
            pref = u.average_into(pref, t0, t1)
        for u in upd[PREF_ENTHALPY]:
            pref = u.eval_into(pref, h_flow)
        for u in upd[PREF_PRESSURE]:
            pref = u.eval_into(pref, P)
        return pref

    def _separated(self, q, h):
        """Per-source separated water and steam flows over the stacked
        stages; zero where not producing or without a separator
        (source_network_node.F90:116-158, separator.F90:141-166,
        multi-stage :215-260)."""
        z = torch.zeros_like(q)
        if not self.has_separators:
            return z, z, z, z
        sep_hw = const_like(self._sep_hw, q)
        sep_hs = const_like(self._sep_hs, q)
        steam_mass = z
        steam_energy = z
        qr, hr = q, h
        for st in range(self._sep_hw.shape[1]):
            active = self._sep_stage[:, st]
            sf, hw_st, hs_st = _flash_stage(hr, sep_hw[:, st], sep_hs[:, st])
            sf = torch.where(active, sf, 0.0)
            qs_st = sf * qr
            steam_mass = steam_mass + qs_st
            steam_energy = steam_energy + qs_st * hs_st
            qr = (1.0 - sf) * qr
            hr = torch.where(active, hw_st, hr)
        hs_out = _safe_ratio(steam_energy, steam_mass)
        keep = self._sep_on & (q < 0.0)
        return (torch.where(keep, qr, 0.0), torch.where(keep, hr, 0.0),
                torch.where(keep, steam_mass, 0.0),
                torch.where(keep, hs_out, 0.0))

    # -- groups and reinjectors (detached in the Jacobian) -------------

    def _group_sums(self, g: _Group, q, h, qw, hw, qs, hs) -> NodeFlows:
        desc = self._group_index[g.name][0]
        qd = q[desc]
        tq = torch.sum(qd)
        gh = _safe_ratio(torch.sum(qd * h[desc]), tq)
        if g.separator.on:
            gqw, ghw, gqs, ghs = g.separator.separate(tq, gh)
            producing = tq < 0.0
            return NodeFlows(
                tq, gh,
                torch.where(producing, gqw, 0.0),
                torch.where(producing, ghw, 0.0),
                torch.where(producing, gqs, 0.0),
                torch.where(producing, ghs, 0.0),
            )
        # no group separator: the sum of the inputs' separated flows
        # (source_network_group.F90:309-371)
        qwd = qw[desc]
        qsd = qs[desc]
        gqw = torch.sum(qwd)
        gqs = torch.sum(qsd)
        return NodeFlows(tq, gh, gqw, _safe_ratio(torch.sum(qwd * hw[desc]),
                                                  gqw),
                         gqs, _safe_ratio(torch.sum(qsd * hs[desc]), gqs))

    def _network_update(self, q, h, qw, hw, qs, hs, t0, t1, collect=None):
        nodes: Dict[str, NodeFlows] = {}

        # groups in topological order, with limiter scaling
        for g in self.groups:
            nf = self._group_sums(g, q, h, qw, hw, qs, hs)
            limits = (g.limiter.limits_at(t0, t1, q)
                      if g.limiter is not None else {})
            if limits:
                _, _, slot, mask = self._group_index[g.name]
                if g.scaling == "progressive":
                    member_scale = self._progressive_scales(g, q, qw, qs,
                                                            limits)
                    full = torch.cat([member_scale.detach(),
                                      q.new_ones(1)])[slot]
                else:
                    s_g = _limit_scale(
                        {FLOW_TOTAL: nf.q, FLOW_WATER: nf.qw,
                         FLOW_STEAM: nf.qs},
                        limits,
                    )
                    full = torch.where(mask, s_g.detach(), 1.0)
                q = q * full
                qw = qw * full
                qs = qs * full
                nf = self._group_sums(g, q, h, qw, hw, qs, hs)
            nodes[g.name] = nf

        if self.reinjectors:
            q, h = self._reinject(q, h, qw, hw, qs, hs, nodes, t0, t1,
                                  collect)
        if collect is not None:
            collect["group"] = dict(nodes)
        return q, h, qw, hw, qs, hs

    def _reinject(self, q, h, qw, hw, qs, hs, nodes, t0, t1, collect):
        """Reinjector capacities and distribution
        (source_network_reinjector.F90:1014-1290): each output's rate and
        enthalpy are set, detached, into its target sources or carried to
        its target reinjector."""
        zero = q.new_zeros(())
        capacity: Dict[Tuple[str, int], torch.Tensor] = {}
        rein_in: Dict[str, Tuple] = {}

        def target_cap(o):
            """The target's capacity: |q| of a rated source, a
            reinjector's capacity (< 0: unrated), else None."""
            if o.target in self._name_to_idx:
                i = self._name_to_idx[o.target][0]
                return torch.abs(q[i]) if self.rate_specified[i] else None
            return capacity.get((o.target, o.flow_type))

        # capacities: chained targets come later in self.reinjectors
        for r in reversed(self.reinjectors):
            for ft in (FLOW_WATER, FLOW_STEAM):
                cap = zero
                unrated = False
                for o in r.outputs:
                    if o.flow_type != ft:
                        continue
                    c = target_cap(o)
                    if c is None:
                        unrated = True
                    else:
                        cap = cap + c
                capacity[(r.name, ft)] = q.new_full((), -1.0) if unrated \
                    else cap

        for r in self.reinjectors:
            if r.input is not None:
                if r.input in nodes:
                    src = nodes[r.input]
                    in_qw, in_hw = torch.abs(src.qw), src.hw
                    in_qs, in_hs = torch.abs(src.qs), src.hs
                else:
                    ii = self._input_index[r.input]
                    in_qw = torch.abs(torch.sum(qw[ii]))
                    in_hw = hw[ii][0]
                    in_qs = torch.abs(torch.sum(qs[ii]))
                    in_hs = hs[ii][0]
            elif r.name in rein_in:
                in_qw, in_hw, in_qs, in_hs = rein_in[r.name]
            else:
                in_qw = in_hw = in_qs = in_hs = zero

            balance = {FLOW_WATER: in_qw, FLOW_STEAM: in_qs}
            in_h = {FLOW_WATER: in_hw, FLOW_STEAM: in_hs}
            in_rate = {FLOW_WATER: in_qw, FLOW_STEAM: in_qs}
            out_tot = {FLOW_WATER: zero, FLOW_STEAM: zero}
            for o in r.outputs:
                if o.kind == "remaining":
                    req = q.new_full((), -1.0)
                else:
                    req = (_table_average(o.table, t0, t1, q)
                           if o.table is not None
                           else q.new_full((), o.value))
                    if o.kind == "proportion":
                        req = req * in_rate[o.flow_type]
                # node limit (source_network_reinjector.F90:199-215,
                # 433-457): a rated target caps the request; an unrated
                # request takes the target's capacity
                cap = target_cap(o)
                if cap is not None:
                    if o.target not in self._name_to_idx:
                        cap = torch.where(cap >= 0.0, cap, torch.inf)
                    req = torch.where(
                        cap < torch.inf,
                        torch.where(req < 0.0, cap, minimum(req, cap)),
                        req,
                    )
                bal = balance[o.flow_type]
                rate_out = torch.where(req < 0.0, bal, minimum(req, bal))
                balance[o.flow_type] = maximum(bal - rate_out, 0.0)
                out_tot[o.flow_type] = out_tot[o.flow_type] + rate_out
                h_out = (q.new_full((), o.enthalpy) if o.enthalpy > 0.0
                         else in_h[o.flow_type])
                if o.target in self._name_to_idx:
                    ii, free_h = self._target_index[o.target]
                    q = q.index_put((ii,), rate_out.detach().expand(len(ii)))
                    if len(free_h):
                        h = h.index_put((free_h,),
                                        h_out.detach().expand(len(free_h)))
                else:
                    prev = rein_in.get(o.target, (zero,) * 4)
                    if o.flow_type == FLOW_WATER:
                        rein_in[o.target] = (prev[0] + rate_out, h_out,
                                             prev[2], prev[3])
                    else:
                        rein_in[o.target] = (prev[0], prev[1],
                                             prev[2] + rate_out, h_out)
            if r.overflow is not None:
                prev = rein_in.get(r.overflow, (zero,) * 4)
                rein_in[r.overflow] = (
                    prev[0] + balance[FLOW_WATER], in_hw,
                    prev[2] + balance[FLOW_STEAM], in_hs,
                )
            if collect is not None:
                # reinjector output fields (setup_output.rst,
                # source_network_reinjector.F90)
                collect.setdefault("reinject", {})[r.name] = {
                    "water_rate": in_qw,
                    "water_enthalpy": in_hw,
                    "steam_rate": in_qs,
                    "steam_enthalpy": in_hs,
                    "output_water_rate": out_tot[FLOW_WATER],
                    "output_steam_rate": out_tot[FLOW_STEAM],
                    "output_rate": out_tot[FLOW_WATER] + out_tot[FLOW_STEAM],
                    "overflow_water_rate": balance[FLOW_WATER],
                    "overflow_steam_rate": balance[FLOW_STEAM],
                }
        return q, h

    def _progressive_scales(self, g: _Group, q, qw, qs, limits):
        """[members] scale factors limiting the members progressively in
        order (source_network_group.F90:676-764, utils.F90:607-647); the
        member sums are one segment sum over the descendant sources."""
        desc, member_sum, _, _ = self._group_index[g.name]
        nm = len(g.member_descendants)
        rates = {FLOW_TOTAL: q, FLOW_WATER: qw, FLOW_STEAM: qs}
        member_scale = q.new_ones(nm)
        for ft, limit in limits.items():
            a = torch.abs(member_sum.add(q.new_zeros(nm), rates[ft][desc]))
            total_over = torch.sum(a) > limit
            prev = torch.cumsum(a, 0) - a
            node_limit = minimum(maximum(limit - prev, 0.0), a)
            s = torch.where(
                a > node_limit,
                torch.where(a > LIMIT_SMALL,
                            node_limit / maximum(a, LIMIT_SMALL), 1.0),
                1.0,
            )
            s = torch.where(total_over, s, 1.0)
            member_scale = minimum(member_scale, s)
        return member_scale
