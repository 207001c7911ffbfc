"""Shared set-up for the parity tests of waiwera_tpu_torch against
waiwera_tpu: the flagship model's configuration (bench.py build_sim, as
waiwera_tpu_torch/bench.py copies it, optionally with its MINC lower
half) on a small box, built through both packages from the same config
dict and mesh spacing, and numpy conversions between them."""

from __future__ import annotations

import numpy as np

from chip_smoke import build_sim, flagship_config, flagship_spacing

__all__ = ["RecordingLogger", "assert_same_records", "flagship_config",
           "jax_coeffs", "jax_sim", "model_config", "np_", "torch_coeffs",
           "torch_sim"]


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


def model_config(nx=5, ny=4, nz=3, **sections):
    """The flagship model as a whole JSON config: flagship_config plus a
    rectangular mesh section from flagship_spacing (its origin left at
    0), with `sections` (time, output, ...) replacing top-level keys."""
    cfg = flagship_config(nx, ny, nz)
    (dx, dy, dz), _ = flagship_spacing(nx, ny, nz)
    cfg["mesh"] = {"type": "rectangular", "dx": dx, "dy": dy, "dz": dz}
    cfg.update(sections)
    return cfg


class RecordingLogger:
    """A Logger stand-in that keeps (level, source, event, data) of every
    message, for comparing two runs event by event."""

    def __init__(self):
        self.records = []

    def write(self, level, source, event, **data):
        self.records.append((level, source, event, dict(data)))

    def events(self, source, event):
        return [d for _, s, e, d in self.records if (s, e) == (source, event)]


def assert_same_records(got, want, rtol=1e-12, skip=("elapsed_seconds",),
                        loose=None):
    """Two RecordingLoggers hold the same messages in the same order:
    levels, sources, events and keys equal; values equal, floats to rtol.
    Keys in `skip` are ignored; `loose` maps a key to (rtol, atol) or, for
    integers, to the allowed difference."""
    loose = loose or {}
    assert [r[:3] for r in got.records] == [r[:3] for r in want.records]
    for (lv, src, ev, a), (_, _, _, b) in zip(got.records, want.records):
        assert list(a) == list(b), (src, ev, a, b)
        for k in a:
            if k in skip:
                continue
            x, y = a[k], b[k]
            where = f"{src}.{ev}.{k}: {x!r} != {y!r}"
            if k in loose and isinstance(x, int) and not isinstance(x, bool):
                assert abs(x - y) <= loose[k], where
            elif isinstance(x, float) or isinstance(y, float):
                r, at = loose.get(k, (rtol, 0.0))
                np.testing.assert_allclose(x, y, rtol=r, atol=at,
                                           err_msg=where)
            else:
                assert x == y, where
