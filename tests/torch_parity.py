"""Shared set-up for the parity tests of waiwera_tpu_torch against
waiwera_tpu: the flagship model's configuration (bench.py build_sim, as
waiwera_tpu_torch/bench.py copies it, optionally with its MINC lower
half) on a small box, built through both packages from the same config
dict and mesh spacing, and numpy conversions between them."""

from __future__ import annotations

import numpy as np

from chip_smoke import build_sim, flagship_config, flagship_spacing

__all__ = ["flagship_config", "jax_coeffs", "jax_sim", "np_",
           "torch_coeffs", "torch_sim"]


def jax_sim(nx=5, ny=4, nz=3, minc=False):
    from waiwera_tpu.mesh.rect import rectangular_mesh
    from waiwera_tpu.sim.simulation import Simulation

    widths, origin = flagship_spacing(nx, ny, nz)
    return Simulation(flagship_config(nx, ny, nz, minc=minc),
                      mesh=rectangular_mesh(*widths, origin=origin))


def torch_sim(nx=5, ny=4, nz=3, minc=False):
    return build_sim(nx, ny, nz, "cpu", minc=minc)


def jax_coeffs(sim, dt):
    """(MethodCoeffs, lhs0) of backward Euler at the initial state."""
    import jax.numpy as jnp
    from waiwera_tpu.solver.system import MethodCoeffs

    lhs0, _, _ = sim.lhs_at(sim.y0, sim.region0)
    return MethodCoeffs(c_lhs=jnp.asarray(1.0), dt_eff=jnp.asarray(dt),
                        const=-lhs0), lhs0


def torch_coeffs(sim, dt):
    from waiwera_tpu_torch.solver.system import MethodCoeffs

    lhs0, _, _ = sim.lhs_at(sim.y0, sim.region0)
    return MethodCoeffs(c_lhs=1.0, dt_eff=dt, const=-lhs0), lhs0


def np_(a) -> np.ndarray:
    """numpy view of a jax array or a torch tensor."""
    if hasattr(a, "detach"):
        return a.detach().cpu().numpy()
    return np.asarray(a)
