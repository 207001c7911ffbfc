"""Finite-volume assembly: per-cell balances (LHS) and per-face fluxes
and per-cell inflows (RHS) (counterpart of
waiwera_tpu/physics/assembly.py).

- cell_balance (cell.F90:114-142)
- face_flux (face.F90:443-515): upstream weighting, harmonic
  permeability/conductivity averaging, saturation-weighted face density,
  capillary and gravity effective gradients
- cell_inflows (flow_simulation.F90:1334-1485): flux * area / volume,
  added with sign -1 into cell 1 and +1 into cell 2 (a fixed-order
  scatter-sum, ops/segment.py)

Everything is out-of-place tensor code, differentiable under
torch.func.jvp (the AD block Jacobian is built on it).
"""

from __future__ import annotations

import torch

from waiwera_tpu_torch.mesh.device import MeshArrays
from waiwera_tpu_torch.physics.state import FluidState, RockState


def cell_balances(fluid: FluidState, rock: RockState,
                  num_primary: int) -> torch.Tensor:
    """[N, npv] mass (and energy) balances per unit volume
    (cell.F90:114-142)."""
    nc = fluid.num_components
    mass = rock.porosity[:, None] * fluid.component_density()  # [N, nc]
    if num_primary == nc:  # isothermal
        return mass
    energy = rock.porosity * fluid.energy() + (
        1.0 - rock.porosity
    ) * rock.energy(fluid.temperature)
    return torch.cat([mass, energy[:, None]], dim=-1)


def _harmonic_average(x1, x2, d1, d2, d12):
    """Distance-weighted harmonic average (face.F90:361-379)."""
    wx = (d1 * x2 + d2 * x1) / d12
    nz = torch.abs(wx) > 1e-30
    return torch.where(nz, x1 * x2 / torch.where(nz, wx, 1.0), 0.0)


def face_permeability_sides(rock: RockState, mesh: MeshArrays):
    """Direction-selected rock permeability on each side of each face."""
    dir_ = mesh.face_permeability_direction[:, None]
    perm_l = torch.gather(rock.permeability[mesh.face_cells[:, 0]], 1, dir_)
    perm_r = torch.gather(rock.permeability[mesh.face_cells[:, 1]], 1, dir_)
    return perm_l[:, 0], perm_r[:, 0]


def face_fluxes_pairs(
    fl: FluidState,
    fr: FluidState,
    perm_l: torch.Tensor,
    perm_r: torch.Tensor,
    cond_l,
    cond_r,
    mesh: MeshArrays,
    num_primary: int,
    num_mobile_phases: int,
    isothermal: bool,
) -> torch.Tensor:
    """[F, npv + num_mobile_phases] fluxes through each face from cell 1
    to cell 2 (face.F90:443-515), from the two cells' fluid states
    gathered per face: per-component mass fluxes, the energy flux
    (non-isothermal), then per-phase total mass fluxes.

    Written over gathered pairs, so that a jvp against one side yields
    the face Jacobian blocks dflux/dy_side directly."""
    nc = fl.mass_fraction.shape[-1]
    d1 = mesh.face_distance[:, 0]
    d2 = mesh.face_distance[:, 1]
    d12 = mesh.face_distance12

    # permeability: direction-selected, harmonic (face.F90:381-398)
    k = _harmonic_average(
        perm_l * fl.permeability_factor,
        perm_r * fr.permeability_factor,
        d1, d2, d12,
    )

    phases_l = fl.phase_composition
    phases_r = fr.phase_composition
    comp_flux = torch.zeros_like(fl.mass_fraction[:, 0, :])  # [F, nc]
    energy_flux = torch.zeros_like(d12)
    phase_flux = []

    mob_l = fl.mobility()
    mob_r = fr.mobility()

    for p in range(num_mobile_phases):
        bit = 1 << p
        in_l = (phases_l & bit) > 0
        in_r = (phases_r & bit) > 0
        present = in_l | in_r

        s_l = fl.saturation[:, p]
        s_r = fr.saturation[:, p]
        wsum = s_l + s_r
        face_density = torch.where(
            wsum > 0.0,
            (s_l * fl.density[:, p] + s_r * fr.density[:, p])
            / torch.where(wsum > 0, wsum, 1.0),
            0.0,
        )

        dpdn = (
            (fr.pressure + fr.capillary_pressure[:, p])
            - (fl.pressure + fl.capillary_pressure[:, p])
        ) / d12
        g = dpdn - face_density * mesh.face_gravity_normal

        up_is_l = g <= 0.0  # upstream_index (face.F90:426-439)
        up_in = torch.where(up_is_l, in_l, in_r)
        active = present & up_in

        mob_up = torch.where(up_is_l, mob_l[:, p], mob_r[:, p])
        f = torch.where(active, -k * mob_up * g, 0.0)
        xf_up = torch.where(
            up_is_l[:, None],
            fl.mass_fraction[:, p, :],
            fr.mass_fraction[:, p, :],
        )
        pcf = f[:, None] * xf_up
        comp_flux = comp_flux + torch.where(active[:, None], pcf, 0.0)
        if not isothermal:
            h_up = torch.where(
                up_is_l, fl.specific_enthalpy[:, p], fr.specific_enthalpy[:, p]
            )
            energy_flux = energy_flux + torch.where(active, h_up * f, 0.0)
        phase_flux.append(torch.where(active, torch.sum(pcf, dim=-1), 0.0))

    if not isothermal:
        cond = _harmonic_average(cond_l, cond_r, d1, d2, d12)
        dtdn = (fr.temperature - fl.temperature) / d12
        energy_flux = energy_flux - cond * dtdn
        return torch.cat(
            [comp_flux, energy_flux[:, None]]
            + [pf[:, None] for pf in phase_flux],
            dim=-1,
        )
    return torch.cat([comp_flux] + [pf[:, None] for pf in phase_flux], dim=-1)


def cell_inflows(fluxes: torch.Tensor, mesh: MeshArrays,
                 num_primary: int) -> torch.Tensor:
    """[N, npv] net inflow per unit volume from face fluxes
    (flow_simulation.F90:1429-1460): -flux*area/vol into cell 1,
    +flux*area/vol into cell 2, none into ghost cells; summed in face
    order (mesh.face_sum)."""
    flow = fluxes[:, :num_primary] * mesh.face_area[:, None]  # [F, npv]
    n = mesh.cell_volume.shape[0]
    rhs = mesh.face_sum.add(fluxes.new_zeros((n, num_primary)),
                            torch.cat([-flow, flow]))
    vol = torch.where(mesh.cell_volume > 0.0, mesh.cell_volume, 1.0)
    rhs = rhs / vol[:, None]
    return torch.where(mesh.is_ghost[:, None], 0.0, rhs)
