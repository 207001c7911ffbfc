"""Passive tracers of waiwera_tpu_torch against the JAX package's: one
auxiliary solve (sim/tracer.py through Simulation.make_tracer_step_fn)
on a 5 x 4 x 3 two-phase state with sources, injection, a Dirichlet top
boundary with tracer values (ghost rows) and a vapour-phase tracer
(absent-phase identity rows), with backward Euler and BDF2 coefficients,
at rtol 1e-10; with an f32 GMRES basis; and a one-cell decay model
(no decay, constant and Arrhenius decay) through the port's Timestepper
against the exact exponentials of tests/test_benchmark_tracer.py:30-53."""

import copy

import numpy as np
import pytest
import torch

from torch_parity import (network_model_config, np_, sim_pair,
                          two_phase_state)

TRACERS = [
    {"name": "inj", "phase": "liquid", "decay": 1.0e-9},
    {"name": "arr", "decay": 1.0e-6, "activation": 2000.0,
     "diffusion": 1.0e-6},
    {"name": "vap", "phase": "vapour", "diffusion": 1.0e-7},
]


def _config():
    cfg = network_model_config(5, 4, 3)
    cfg["tracer"] = copy.deepcopy(TRACERS)
    cfg["boundaries"][0]["tracer"] = [2.0e-3, 0.0, 1.0e-3]
    for s in cfg["source"]:
        if "tracer" in s:
            s["tracer"] = {"inj": 1.0e-4, "vap": [[0.0, 1e-6], [5e4, 3e-6]]}
    cfg["initial"]["tracer"] = [0.0, 1.0e-3, 5.0e-4]
    return cfg


@pytest.fixture(scope="module")
def pair():
    """Both packages' simulations, a two-phase state with its fluid and
    face fluxes in each, and random tracer histories."""
    import jax.numpy as jnp

    sj, st = sim_pair(_config())
    y, region = two_phase_state(sj, seed=11)
    fj, cj, _ = sj.system.derived_state(jnp.asarray(y), jnp.asarray(region),
                                        sj.rock)
    fxj = sj.system.fluxes(fj, cj, sj.rock)
    ft, ctt, _ = st.system.derived_state(torch.as_tensor(y),
                                         torch.as_tensor(region), st.rock)
    fxt = st.system.fluxes(ft, ctt, st.rock)
    np.testing.assert_allclose(np_(fxt), np.asarray(fxj), rtol=1e-10,
                               atol=1e-10 * np.abs(np.asarray(fxj)).max())
    rng = np.random.default_rng(4)
    n, nt = np.asarray(sj.tracer0).shape
    hist = [rng.uniform(0.0, 2e-3, (n, nt)) for _ in range(2)]
    x0j, al0j = sj.initial_tracer_state()
    al = [np.array(al0j), np.array(al0j) * (1 + rng.uniform(-0.01, 0.01,
                                                                (n, nt)))]
    return sj, st, (fj, fxj), (ft, fxt), hist, al


@pytest.mark.parametrize("method, first", [
    ("beuler", 1.0), ("bdf2", 1.0), ("bdf2", 0.0),
], ids=["beuler", "bdf2_first", "bdf2"])
def test_tracer_solve_matches_jax(pair, method, first):
    import jax.numpy as jnp

    sj, st, (fj, fxj), (ft, fxt), hist, al = pair
    t0, dt, dt_last = 3.0e3, 2.0e4, 1.0e4
    bdf2 = method == "bdf2"
    rj = sj.make_tracer_step_fn()(
        fj, fxj, jnp.asarray(hist[0]), jnp.asarray(al[0]),
        jnp.asarray(hist[1]), jnp.asarray(al[1]), jnp.asarray(t0),
        jnp.asarray(t0 + dt), jnp.asarray(dt), jnp.asarray(dt_last),
        jnp.asarray(first), jnp.asarray(bdf2))
    t = [torch.as_tensor(a) for a in (hist[0], al[0], hist[1], al[1])]
    rt = st.make_tracer_step_fn()(ft, fxt, *t, t0, t0 + dt, dt, dt_last,
                                  first, bdf2)
    assert rt.converged and bool(rj.converged)
    assert rt.iterations == int(rj.iterations)
    xj = np.asarray(rj.x)
    np.testing.assert_allclose(np_(rt.x), xj, rtol=1e-10,
                               atol=1e-10 * np.abs(xj).max())
    np.testing.assert_allclose(np_(rt.al), np.asarray(rj.al), rtol=1e-12)
    # ghost rows hold the boundary values; rows without vapour are
    # identity rows with a zero right-hand side
    ghost = np_(st.mesh_dev.is_ghost)
    np.testing.assert_array_equal(np_(rt.x)[ghost],
                                  np_(st.tracer0)[ghost])
    no_vapour = (np_(ft.phase_composition) & 2) == 0
    assert no_vapour[~ghost].any()
    np.testing.assert_array_equal(np_(rt.x)[no_vapour & ~ghost, 2], 0.0)


def test_tracer_solve_f32_basis(pair):
    """The f32 Arnoldi basis (taken above the byte cap, here asked for):
    the same solution to the solve's tolerance."""
    from waiwera_tpu_torch.sim import tracer as tracer_mod

    sj, st, _, (ft, fxt), hist, al = pair
    x_last = torch.as_tensor(hist[0])
    al_last = torch.as_tensor(al[0])
    net = st.sources
    rate, _ = net.flows(ft, 0.0, 1.0e4)
    pidx = torch.as_tensor(st.tracers.phase_index)
    frac = ft.phase_flow_fractions()[net.arrays.cell][:, pidx]
    args = (st.tracers, st.mesh_dev, ft, st.rock, fxt,
            st.eos.num_primary_variables, 1.0, 1.0e4, al_last * x_last,
            net.arrays, rate, frac, net.tracer_injection(0.0, 1.0e4),
            st.tracer0)
    r64 = tracer_mod.solve(*args, rtol=1e-10, basis_dtype=None)
    r32 = tracer_mod.solve(*args, rtol=1e-10, basis_dtype=torch.float32)
    assert r64.converged and r32.converged
    x = np_(r64.x)
    np.testing.assert_allclose(np_(r32.x), x, rtol=1e-7,
                               atol=1e-7 * np.abs(x).max())


def test_one_cell_decay_against_exact():
    """A one-cell model with no flow (the reference's tracer decay
    benchmark): no decay, a constant rate of 1e-6 /s and Arrhenius decay
    (1e-6 /s, activation 2,000 J/mol) from 1e-3, BDF2 steps of 1e4 s,
    against 1e-3 exp(-lambda t) within 1e-5 at every output time."""
    from waiwera_tpu_torch.sim.simulation import Simulation
    from waiwera_tpu_torch.sim.timestepper import Timestepper

    config = {
        "mesh": {"type": "column", "dz": [10.0], "area": 100.0},
        "gravity": 0.0,
        "eos": {"name": "we"},
        "initial": {"primary": [1.0e6, 100.0], "region": 1,
                    "tracer": 1.0e-3},
        "tracer": [
            {"name": "no_decay"},
            {"name": "constant", "decay": 1.0e-6},
            {"name": "temperature", "decay": 1.0e-6, "activation": 2000.0},
        ],
        "time": {"step": {"method": "bdf2", "size": 1.0e4,
                          "maximum": {"number": 20}}},
    }

    class Record:
        face_group = None

        def __init__(self):
            self.times, self.x, self.temperature = [], [], []

        def write(self, index, time, fluid, source_data=None, tracer=None,
                  fluxes=None):
            self.times.append(time)
            self.x.append(np_(tracer)[0])
            self.temperature.append(float(fluid.temperature[0]))

    sim = Simulation(config, device="cpu")
    out = Record()
    ts = Timestepper(copy.deepcopy(config), sim, output=out)
    assert ts.run() and ts.taken == 20
    t = np.asarray(out.times)
    x = np.asarray(out.x)
    lam = 1.0e-6 * np.exp(-2000.0 / (8.3144598
                                     * (out.temperature[0] + 273.15)))
    for k, exact in enumerate((np.full_like(t, 1e-3),
                               1e-3 * np.exp(-1e-6 * t),
                               1e-3 * np.exp(-lam * t))):
        assert np.max(np.abs(x[:, k] - exact)) < 1e-5, config["tracer"][k]
    assert t[-1] == pytest.approx(2.0e5)
    assert x[-1, 1] < 0.9e-3
