"""Shared set-up for the parity tests of waiwera_tpu_torch against
waiwera_tpu: the flagship model's configuration (bench.py build_sim, as
waiwera_tpu_torch/bench.py copies it, optionally with its MINC lower
half) on a small box, the EOS models and the production-field model of
chip_smoke.py, built through both packages from the same config dict and
mesh spacing, and numpy conversions between them."""

from __future__ import annotations

import copy

import numpy as np

from chip_smoke import (build_sim, eos_model_config, flagship_config,
                        flagship_spacing, network_model_config)

__all__ = ["RecordingLogger", "assert_same_records", "eos_model_config",
           "flagship_config", "jax_coeffs", "jax_native", "jax_sim",
           "model_config",
           "network_model_config", "np_", "rect_system_pair", "sim_pair",
           "torch_coeffs",
           "torch_sim"]


def jax_native():
    """The JAX package's C++ library (waiwera_tpu/native), loaded in this
    process. That package builds it at first use through one fixed
    temporary file name, so test workers that start together on a fresh
    checkout can race for it; a worker that loses gives the library up
    for its whole life and takes the numpy fallbacks and RCB without a
    word (ROADMAP C17, C21), which changes its partitions. A failed load
    is retried here once after a build of this process's own, with the
    package's own g++ commands, into a temporary name of its own that is
    then renamed onto the library's path."""
    import os
    import subprocess

    from waiwera_tpu import native

    if native.available():
        return native._lib
    path = native._lib_path()
    tmp = f"{path}.{os.getpid()}.tmp"
    for flags in (("-O3", "-march=native", "-shared", "-fPIC", "-fopenmp",
                   "-std=c++17"), ("-O3", "-shared", "-fPIC", "-std=c++17")):
        r = subprocess.run(["g++", *flags, native._SRC, "-o", tmp],
                           capture_output=True, text=True, timeout=600)
        if r.returncode == 0:
            break
    if r.returncode != 0:
        raise RuntimeError(f"g++ failed on {native._SRC}: {r.stderr}")
    os.replace(tmp, path)
    native._tried = False
    if not native.available():
        raise RuntimeError(f"{path} does not load")
    return native._lib


def jax_sim(nx=5, ny=4, nz=3, minc=False):
    from waiwera_tpu.mesh.rect import rectangular_mesh
    from waiwera_tpu.sim.simulation import Simulation

    widths, origin = flagship_spacing(nx, ny, nz)
    return Simulation(flagship_config(nx, ny, nz, minc=minc),
                      mesh=rectangular_mesh(*widths, origin=origin))


def torch_sim(nx=5, ny=4, nz=3, minc=False):
    return build_sim(nx, ny, nz, "cpu", minc=minc)


def rect_system_pair(nx=6, ny=5, nz=4):
    """tests/test_solver.py's _rect_system ("we", a box of 10 x 10 x 5 m
    cells with a Dirichlet top) through both packages: (JAX Simulation,
    port Simulation on the CPU)."""
    from test_solver import _rect_system
    from waiwera_tpu_torch.mesh.rect import rectangular_mesh
    from waiwera_tpu_torch.sim.simulation import Simulation

    config = {
        "eos": {"name": "we"},
        "initial": {"primary": [2.0e6, 120.0], "region": 1},
        "boundaries": [{
            "primary": [2.0e6, 120.0], "region": 1,
            "faces": {"cells": list(range(nx * ny)),
                      "normal": [0.0, 0.0, 1.0]},
        }],
    }
    mesh = rectangular_mesh([10.0] * nx, [10.0] * ny, [5.0] * nz,
                            origin=[0, 0, -100.0])
    return (_rect_system(nx, ny, nz),
            Simulation(config, mesh=mesh, device="cpu"))


def sim_pair(config):
    """(JAX Simulation, port Simulation on the CPU) of one whole JSON
    config, any EOS, the mesh built from its mesh section; each package
    gets its own copy of the config."""
    from waiwera_tpu.sim.simulation import Simulation as JSim
    from waiwera_tpu_torch.sim.simulation import Simulation as TSim

    return (JSim(copy.deepcopy(config)),
            TSim(copy.deepcopy(config), device="cpu"))


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


# -- EOS models through both packages: residual, Jacobian parts and runs

EOS_DT = 1.0e4


def two_phase_state(sim, seed=7):
    """Scaled primaries and regions off a simulation's initial state:
    interior primaries perturbed by up to 2%, and every third interior
    cell of a non-isothermal EOS moved to its two-phase region (8 where
    halite is present) with a vapour saturation in (0.05, 0.5)."""
    import jax.numpy as jnp

    rng = np.random.default_rng(seed)
    region = np.array(sim.region0)
    primary = np.array(sim.eos.unscale(sim.y0, sim.region0))
    idx = np.flatnonzero(~np.asarray(sim.mesh_dev.is_ghost))
    primary[idx] *= 1.0 + rng.uniform(-0.02, 0.02, (len(idx),
                                                     primary.shape[1]))
    if not sim.eos.isothermal:
        two = idx[::3]
        region[two] = np.where(region[two] >= 5, 8, 4)
        primary[two, 1] = rng.uniform(0.05, 0.5, len(two))
    y = np.array(sim.eos.scale(jnp.asarray(primary), jnp.asarray(region)))
    return y, region.astype(np.int32)


def check_system(sj, st, states, f32_against="jax_f32"):
    """Residual (f64, rtol 1e-10 of the largest entry) and Jacobian parts
    of both packages' simulations at each (y, region) of `states`: the
    port's f64 parts within 1e-8, and its f32 parts within 2e-4, of each
    b x b block's largest entry (tests/test_solver.py:723, :882-885) in
    the JAX package's parts: its f32 parts, or with
    f32_against="jax_f64" its f64 parts (the exact Jacobian), where the
    JAX package's f32 chain is not sound (the salt EOS: ROADMAP C13).
    One jit of each JAX function serves every state."""
    import jax
    import jax.numpy as jnp
    import torch
    from waiwera_tpu.solver.system import MethodCoeffs as JCoeffs
    from waiwera_tpu_torch.solver.system import MethodCoeffs as TCoeffs

    lhs0, _, _ = sj.lhs_at(sj.y0, sj.region0)
    cj = JCoeffs(c_lhs=jnp.asarray(1.0), dt_eff=jnp.asarray(EOS_DT),
                 const=-lhs0)
    ct = TCoeffs(c_lhs=1.0, dt_eff=EOS_DT,
                 const=-torch.as_tensor(np.array(lhs0)))
    t0, t1 = jnp.asarray(0.0), jnp.asarray(EOS_DT)
    residual = jax.jit(
        lambda y, r: sj.system.residual(y, r, sj.rock, cj, t0, t1))

    def jax_parts(dtype):
        return jax.jit(lambda y, r: sj.system.jacobian_parts(
            y, r, sj.rock, cj, t0, t1, tangent_dtype=dtype))

    def close(pt, pj, dtype, atol, what):
        for a, b, name in zip(pt, pj, ("diag", "J_lr", "J_rl")):
            assert a.dtype == dtype, name
            a = np_(a).astype(np.float64)
            b = np.asarray(b).astype(np.float64)
            assert a.shape == b.shape and np.isfinite(a).all(), name
            scale = np.abs(b).max(axis=0, keepdims=True) + 1e-30
            np.testing.assert_allclose(a / scale, b / scale, rtol=0,
                                       atol=atol, err_msg=f"{what} {name}")

    parts64 = jax_parts(None)
    parts32 = jax_parts(jnp.float32) if f32_against == "jax_f32" else None
    for y, region in states:
        yt, rt = torch.as_tensor(y), torch.as_tensor(region)
        yj, rj_ = jnp.asarray(y), jnp.asarray(region)
        rj, lj, fxj, errj = residual(yj, rj_)
        r_t, lt, fxt, errt = st.system.residual(yt, rt, st.rock, ct, 0.0,
                                                EOS_DT)
        np.testing.assert_array_equal(np_(errt), np.asarray(errj))
        assert not np.asarray(errj).any()
        for a, b, name in ((r_t, rj, "residual"), (lt, lj, "lhs"),
                           (fxt, fxj, "fluxes")):
            b = np.asarray(b)
            np.testing.assert_allclose(np_(a), b, rtol=1e-10,
                                       atol=1e-10 * np.abs(b).max(),
                                       err_msg=name)
        pj64 = parts64(yj, rj_)
        close(st.system.jacobian_parts(yt, rt, st.rock, ct, 0.0, EOS_DT),
              pj64, torch.float64, 1e-8, "f64")
        pt32 = st.system.jacobian_parts(yt, rt, st.rock, ct, 0.0, EOS_DT,
                                        tangent_dtype=torch.float32)
        close(pt32, pj64 if parts32 is None else parts32(yj, rj_),
              torch.float32, 2e-4, f"f32 against {f32_against}")


def run_pair(config):
    """The whole config through both packages' Simulation and
    Timestepper on the CPU, each with a RecordingLogger: (JAX
    Timestepper, port Timestepper)."""
    from waiwera_tpu.sim.timestepper import Timestepper as JTs
    from waiwera_tpu_torch.sim.timestepper import Timestepper as TTs

    sj, st = sim_pair(config)
    out = []
    for ts_cls, sim in ((JTs, sj), (TTs, st)):
        ts = ts_cls(copy.deepcopy(config), sim, logger=RecordingLogger())
        ts.run()
        out.append(ts)
    return out


# Krylov counts and residual norms of a converged solve are round-off;
# as tests/test_torch_run.py allows them
RUN_LOOSE = {"linear_iterations": 2, "max_residual": (1e-3, 1e-9),
             "worst_cell": 10 ** 9, "worst_equation": 3}


def check_run(tj, tt, steps):
    """Both packages' runs of one model: not aborted, `steps` steps, the
    same messages (tries, sizes, statuses) in the same order with sizes
    and times to rtol 1e-12, the same final regions and final scaled
    primaries within rtol 1e-8 (atol 1e-8)."""
    assert not tt.aborted and not tj.aborted
    assert tt.taken == tj.taken == steps
    assert_same_records(tt.log, tj.log, loose=RUN_LOOSE)
    np.testing.assert_allclose(tt.final_time, tj.final_time, rtol=1e-12)
    np.testing.assert_array_equal(np_(tt.final_region),
                                  np.asarray(tj.final_region))
    np.testing.assert_allclose(np_(tt.final_y), np.asarray(tj.final_y),
                               rtol=1e-8, atol=1e-8)
