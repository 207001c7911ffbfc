"""Abstract EOS interface (counterpart of waiwera_tpu/eos/base.py).

Methods are vectorised over cells: primary variables are [N, npv]
tensors and regions [N] int32. Scaling tables are [max_region, npv],
indexed by region - 1 (eos.F90:186-210).
"""

from __future__ import annotations

import numpy as np
import torch

from waiwera_tpu_torch.tensors import const_like


def bisect(f_of, f0, like, steps):
    """x in [0, 1] with f_of(x) = 0 where f changes sign on [0, 1]: a
    fixed number of bisection steps from f0 = f_of(0), each a where
    over every cell (the JAX package's fori_loop)."""
    a = torch.zeros_like(like)
    b = torch.ones_like(like)
    fa = f0
    for _ in range(steps):
        m = 0.5 * (a + b)
        fm = f_of(m)
        go_left = fa * fm <= 0.0
        a, b, fa = (
            torch.where(go_left, a, m),
            torch.where(go_left, m, b),
            torch.where(go_left, fa, fm),
        )
    return 0.5 * (a + b)


def interpolation_fraction(bound, old_second, second):
    """xi with old_second + xi (second - old_second) = bound (where the
    Newton path crosses a saturation bound), or -1 where the second
    primary variable did not move."""
    ds = second - old_second
    moved = torch.abs(ds) > 1e-30
    return torch.where(
        moved, (bound - old_second) / torch.where(moved, ds, 1.0), -1.0
    )


class EOS:
    name: str = "abstract"
    description: str = ""
    num_primary_variables: int
    num_phases: int
    num_mobile_phases: int
    num_components: int
    phase_names: tuple
    component_names: tuple
    primary_variable_names: tuple
    default_primary: np.ndarray
    default_region: int = 1
    default_tracer_phase: str = "liquid"
    isothermal: bool = False
    required_output_fluid_fields: tuple = ()
    default_output_fluid_fields: tuple = ()

    # [max_region, npv] scale factors; set by subclasses
    primary_scale: np.ndarray

    def __init__(self, thermo, relperm, capillarity):
        self.thermo = thermo
        self.relative_permeability = relperm
        self.capillary_pressure = capillarity

    def _scale_rows(self, like: torch.Tensor, region: torch.Tensor):
        return const_like(self.primary_scale, like)[region.long() - 1]

    # -- scaling (eos.F90:186-210) ----------------------------------

    def scale(self, primary: torch.Tensor, region: torch.Tensor):
        return primary / self._scale_rows(primary, region)

    def unscale(self, scaled: torch.Tensor, region: torch.Tensor):
        return scaled * self._scale_rows(scaled, region)

    # -- properties --------------------------------------------------

    def properties(self, primary, region, rock):
        """Full fluid recompute at unscaled primaries and regions.
        Returns (FluidState, err[N] bool)."""
        raise NotImplementedError

    def transition(self, old_primary, primary, region, old_temperature):
        """Region transitions. Returns (new_primary, new_region,
        transition_mask[N], err[N]); none by default (an EOS with one
        region)."""
        del old_primary, old_temperature
        none = torch.zeros(region.shape, dtype=torch.bool,
                           device=region.device)
        return primary, region, none, none

    def check_primary_variables(self, primary, region):
        """Bounds check. Returns (primary, err[N])."""
        raise NotImplementedError

    def primary_from_output_fields(self, fields):
        """(primary [n, npv], region [n]) as numpy arrays from the
        required output fluid fields of a restart file
        (initial.F90:421-679 'minimal' restart)."""
        raise NotImplementedError

    def primary_variables(self, fluid) -> torch.Tensor:
        """Primary variables recovered from a fluid state (for
        restarts)."""
        raise NotImplementedError

    # -- misc --------------------------------------------------------

    def conductivity(self, rock, fluid) -> torch.Tensor:
        """Effective heat conductivity with sqrt(S_l) dependence
        (eos.F90:240-257)."""
        sl = torch.clamp(fluid.saturation[:, 0], 0.0, 1.0)
        # gradient-safe sqrt: d(sqrt)/dsl is unbounded at sl=0 (dry
        # cells), so branch with where and keep the tangent at sl=0 zero
        root = torch.where(
            sl > 0.0, torch.sqrt(torch.where(sl > 0.0, sl, 1.0)), 0.0
        )
        return rock.dry_conductivity + root * (
            rock.wet_conductivity - rock.dry_conductivity
        )

    def phase_composition(self, region, p, t):
        return self.thermo.phase_composition(region, p, t)
