"""Source / sink terms (counterpart of waiwera_tpu/sim/sources.py,
source.F90:341-486): injection puts the rate into one mass component
with a given enthalpy; production distributes the rate over components
by phase mobility fractions and produces the flowing enthalpy.
Component index num_primary_variables means direct heat input.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from waiwera_tpu_torch.ops.segment import SegmentSum
from waiwera_tpu_torch.physics.state import FluidState


class SourceArrays(NamedTuple):
    """Static per-source data (device)."""

    cell: torch.Tensor  # [ns] int64 cell index
    injection_component: torch.Tensor  # [ns] int64 (1-based; 0 = default)
    production_component: torch.Tensor  # [ns] int64 (1-based; 0 = distribute)
    volume: torch.Tensor  # [ns] f64 volume of the host cell
    cell_sum: SegmentSum  # per-source values into their cells


class SourceCellState(NamedTuple):
    """Fluid state gathered at source cells [ns, ...]."""

    pressure: torch.Tensor  # [ns]
    permeability_factor: torch.Tensor  # [ns]
    phase_flow_fractions: torch.Tensor  # [ns, np]
    specific_enthalpy: torch.Tensor  # [ns, np]
    mass_fraction: torch.Tensor  # [ns, np, nc]
    mobility: torch.Tensor  # [ns, np]


def gather_cell_state(fluid: FluidState, cell: torch.Tensor) -> SourceCellState:
    return SourceCellState(
        pressure=fluid.pressure[cell],
        permeability_factor=fluid.permeability_factor[cell],
        phase_flow_fractions=fluid.phase_flow_fractions()[cell],
        specific_enthalpy=fluid.specific_enthalpy[cell],
        mass_fraction=fluid.mass_fraction[cell],
        mobility=fluid.mobility()[cell],
    )


def source_flows(
    fluid: FluidState,
    src: SourceArrays,
    rate: torch.Tensor,
    injection_enthalpy: torch.Tensor,
    num_primary: int,
    num_components: int,
    isothermal: bool,
) -> torch.Tensor:
    """[ns, npv] per-source, per-equation flows (source.F90:386-486):
    injection puts the rate into one mass component; production
    distributes over components by phase mobility fractions; the last
    column carries the energy flow for non-isothermal EOSs."""
    npv = num_primary
    nc = num_components
    injecting = rate >= 0.0

    def into(component0):
        # rate placed in one (0-based) column: the one-hot product is
        # exact, so this equals a scatter of `rate`
        onehot = F.one_hot(torch.clamp(component0, 0, npv - 1), npv)
        return rate[:, None] * onehot.to(rate.dtype)

    # --- injection: rate into one component --------------------------
    inj_flow = into(src.injection_component - 1)

    # --- production: distribute by phase mobility fractions ----------
    cell = src.cell
    frac = fluid.phase_flow_fractions()[cell]  # [ns, np]
    h = fluid.specific_enthalpy[cell]  # [ns, np]
    xf = fluid.mass_fraction[cell]  # [ns, np, nc]
    prod_enthalpy = torch.sum(frac * h, dim=-1)  # [ns]
    comp_frac = torch.sum(frac[:, :, None] * xf, dim=1)  # [ns, nc]
    prod_comp = src.production_component  # 1-based; 0 = distribute
    distributed = torch.cat(
        [rate[:, None] * comp_frac, rate.new_zeros((rate.shape[0], npv - nc))],
        dim=1,
    )
    single = into(prod_comp - 1)
    prod_flow = torch.where((prod_comp <= 0)[:, None], distributed, single)

    flow = torch.where(injecting[:, None], inj_flow, prod_flow)
    comp_eff = torch.where(
        injecting,
        src.injection_component,
        torch.where(prod_comp <= 0, torch.ones_like(prod_comp), prod_comp),
    )
    if not isothermal:
        enthalpy = torch.where(injecting, injection_enthalpy, prod_enthalpy)
        # energy flow only for mass sources (component npv means heat)
        energy = torch.where(comp_eff < npv, enthalpy * rate, 0.0)
        flow = torch.cat(
            [flow[:, : npv - 1], (flow[:, npv - 1] + energy)[:, None]], dim=1
        )
    return flow


def source_inflows(
    fluid: FluidState,
    src: SourceArrays,
    rate: torch.Tensor,
    injection_enthalpy: torch.Tensor,
    num_primary: int,
    num_components: int,
    num_cells: int,
    isothermal: bool,
) -> torch.Tensor:
    """[N, npv] cell inflows (per unit volume) from sources
    (source.F90:386-486). Differentiable in `fluid`, so production terms
    enter the Jacobian's diagonal blocks through the same AD chain as
    the balances."""
    flow = source_flows(
        fluid, src, rate, injection_enthalpy, num_primary,
        num_components, isothermal,
    )
    inflow = flow.new_zeros((num_cells, num_primary))
    return src.cell_sum.add(inflow, flow / src.volume.to(flow.dtype)[:, None])
