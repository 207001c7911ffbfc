"""Fluid and rock state containers (counterpart of
waiwera_tpu/physics/state.py): NamedTuples of [N, ...] tensors."""

from __future__ import annotations

from typing import NamedTuple

import torch

# FluidState fields holding integers; every other field is floating
# and carries tangents in the AD Jacobian
INT_FIELDS = ("region", "old_region", "phase_composition")


class FluidState(NamedTuple):
    """Per-cell fluid state (fluid.F90:36-53). Shapes: [N] bulk,
    [N, np] per phase, [N, np, nc] mass fraction, [N, nc] partial
    pressure."""

    pressure: torch.Tensor  # [N]
    temperature: torch.Tensor  # [N] (deg C)
    region: torch.Tensor  # [N] int32 thermodynamic region
    old_region: torch.Tensor  # [N] int32 region before last transition
    phase_composition: torch.Tensor  # [N] int32 bitmask
    permeability_factor: torch.Tensor  # [N]
    partial_pressure: torch.Tensor  # [N, nc]
    density: torch.Tensor  # [N, np]
    viscosity: torch.Tensor  # [N, np]
    saturation: torch.Tensor  # [N, np]
    relative_permeability: torch.Tensor  # [N, np]
    capillary_pressure: torch.Tensor  # [N, np]
    specific_enthalpy: torch.Tensor  # [N, np]
    internal_energy: torch.Tensor  # [N, np]
    mass_fraction: torch.Tensor  # [N, np, nc]

    @property
    def num_components(self) -> int:
        return self.mass_fraction.shape[-1]

    def phase_present(self) -> torch.Tensor:
        """[N, np] bool: is phase p present (bit p of composition)."""
        bits = torch.arange(self.density.shape[-1], dtype=torch.int32,
                            device=self.phase_composition.device)
        return (self.phase_composition[:, None] >> bits) & 1 > 0

    def float_fields(self) -> tuple:
        """The floating fields, in field order (the arguments and
        outputs of the Jacobian's jvps)."""
        return tuple(
            v for k, v in zip(self._fields, self) if k not in INT_FIELDS
        )

    def with_float_fields(self, floats) -> "FluidState":
        """This state's integer fields with new floating fields."""
        it = iter(floats)
        return FluidState(
            *(v if k in INT_FIELDS else next(it)
              for k, v in zip(self._fields, self))
        )

    def index(self, idx: torch.Tensor) -> "FluidState":
        """Rows idx of every field."""
        return FluidState(*(v[idx] for v in self))

    def component_density(self) -> torch.Tensor:
        """[N, nc]: sum_p S_p rho_p X_pc (fluid.F90 component_density)."""
        w = self.saturation * self.density  # [N, np]
        return torch.sum(w[:, :, None] * self.mass_fraction, dim=1)

    def energy(self) -> torch.Tensor:
        """[N]: sum_p S_p rho_p u_p (fluid.F90 energy)."""
        return torch.sum(
            self.saturation * self.density * self.internal_energy, dim=-1
        )

    def mobility(self) -> torch.Tensor:
        """[N, np]: kr rho / mu per phase (fluid.F90:197-206), 0 where
        the phase is absent."""
        mu = torch.where(self.viscosity > 0.0, self.viscosity, 1.0)
        return torch.where(
            self.viscosity > 0.0,
            self.relative_permeability * self.density / mu,
            0.0,
        )

    def phase_flow_fractions(self) -> torch.Tensor:
        """[N, np]: mobility fractions (used for production flows)."""
        mob = self.mobility()
        total = torch.sum(mob, dim=-1, keepdim=True)
        return torch.where(
            total > 0.0, mob / torch.where(total > 0, total, 1.0), 0.0
        )


def empty_fluid(num_cells: int, num_phases: int, num_components: int,
                device="cpu", dtype=torch.float64) -> FluidState:
    def f(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    def i(value):
        return torch.full((num_cells,), value, dtype=torch.int32,
                          device=device)

    return FluidState(
        pressure=f(num_cells),
        temperature=f(num_cells),
        region=i(1),
        old_region=i(1),
        phase_composition=i(0),
        permeability_factor=torch.ones(num_cells, dtype=dtype,
                                       device=device),
        partial_pressure=f(num_cells, num_components),
        density=f(num_cells, num_phases),
        viscosity=f(num_cells, num_phases),
        saturation=f(num_cells, num_phases),
        relative_permeability=f(num_cells, num_phases),
        capillary_pressure=f(num_cells, num_phases),
        specific_enthalpy=f(num_cells, num_phases),
        internal_energy=f(num_cells, num_phases),
        mass_fraction=f(num_cells, num_phases, num_components),
    )


class RockState(NamedTuple):
    """Per-cell rock properties (rock.F90:56-76)."""

    permeability: torch.Tensor  # [N, 3]
    wet_conductivity: torch.Tensor  # [N]
    dry_conductivity: torch.Tensor  # [N]
    porosity: torch.Tensor  # [N]
    density: torch.Tensor  # [N]
    specific_heat: torch.Tensor  # [N]

    def energy(self, temperature: torch.Tensor) -> torch.Tensor:
        """Rock energy density rho_r c_r T (rock.F90 rock_energy)."""
        return self.density * self.specific_heat * temperature

    def to(self, dtype: torch.dtype) -> "RockState":
        return RockState(*(v.to(dtype) for v in self))


# Default rock properties (rock.F90:68-76)
DEFAULT_PERMEABILITY = 1.0e-13
DEFAULT_POROSITY = 0.1
DEFAULT_ROCK_DENSITY = 2200.0
DEFAULT_SPECIFIC_HEAT = 1000.0
DEFAULT_HEAT_CONDUCTIVITY = 2.5


def default_rock(num_cells: int, device="cpu",
                 dtype=torch.float64) -> RockState:
    """Every cell with the default rock properties (rock.F90:68-76)."""
    def full(shape, value):
        return torch.full(shape, value, dtype=dtype, device=device)

    return RockState(
        permeability=full((num_cells, 3), DEFAULT_PERMEABILITY),
        wet_conductivity=full((num_cells,), DEFAULT_HEAT_CONDUCTIVITY),
        dry_conductivity=full((num_cells,), DEFAULT_HEAT_CONDUCTIVITY),
        porosity=full((num_cells,), DEFAULT_POROSITY),
        density=full((num_cells,), DEFAULT_ROCK_DENSITY),
        specific_heat=full((num_cells,), DEFAULT_SPECIFIC_HEAT),
    )
