"""The source network of waiwera_tpu_torch against the JAX package's:
flows(..., collect=) on a 5 x 4 x 3 two-phase state of the default-EOS
model, one case per control (rate, enthalpy and rate-factor tables with
each interpolation and averaging, deliverability with each productivity
and reference-pressure mode, threshold, recharge, injectivity,
direction, source and group separators, limiters, nested groups with
uniform and progressive scaling, reinjectors with rate and proportion
outputs and overflow), at rtol 1e-12 (f64); the Jacobian of a model with
groups and reinjectors at rtol 1e-10 (f64), which fails if a network
coupling is left attached to the tangent chain; and the number of torch
operations `flows` dispatches, which does not grow with the number of
sources."""

import copy

import numpy as np
import pytest
import torch

from torch_parity import (eos_model_config, network_model_config, np_,
                          sim_pair, two_phase_state)

T0, T1 = 2.0e3, 3.7e4
# 5 x 4 x 3 box: layer k holds cells 20 k .. 20 k + 19; the top layer
# (40-59) is two-phase, and two_phase_state makes every third interior
# cell two-phase
TOP = [42, 47, 51, 56]
LOW = [3, 8, 12, 17]
RATE_TABLE = [[0.0, -1.0], [1.0e4, -3.0], [3.0e4, -2.0], [6.0e4, -4.0]]
H_TABLE = [[0.0, 3.0e5], [2.0e4, 9.0e5], [5.0e4, 6.0e5]]


def _prod(name, cell, **kw):
    return dict({"name": name, "cell": cell}, **kw)


def _deliv(**kw):
    return dict({"productivity": 2.0e-12, "pressure": 1.0e6}, **kw)


def _sep_group(name, members, **kw):
    return dict({"name": name, "in": members,
                 "separator": {"pressure": 0.55e6}}, **kw)


def _four_producers(**kw):
    return [_prod(f"p{k}", c, deliverability=_deliv(), **kw)
            for k, c in enumerate(TOP)]


def _injectors(n=4, **kw):
    return [dict({"name": f"i{k}", "cell": c}, **kw)
            for k, c in enumerate(LOW[:n])]


CASES = {
    "rate_table_linear": ([
        _prod("a", 5, rate=RATE_TABLE),
        _prod("b", 6, rate=RATE_TABLE, averaging="endpoint"),
    ], {}),
    "rate_table_step": ([
        _prod("a", 5, rate=RATE_TABLE, interpolation="step"),
        _prod("b", 6, rate=RATE_TABLE, interpolation="step",
              averaging="endpoint"),
    ], {}),
    "rate_table_pchip": ([
        _prod("a", 5, rate=RATE_TABLE, interpolation="pchip"),
        _prod("b", 6, rate=RATE_TABLE, interpolation="pchip",
              averaging="endpoint"),
    ], {}),
    "enthalpy_table": ([
        _prod("a", 5, rate=2.0, enthalpy=H_TABLE),
        _prod("b", 6, rate=1.0, enthalpy=H_TABLE, interpolation="pchip",
              averaging="endpoint"),
    ], {}),
    "rate_factor": ([
        _prod("a", 5, rate=-2.0, rate_factor=[[0.0, 1.0], [4.0e4, 0.5]]),
        _prod("b", TOP[0], deliverability=_deliv(),
              rate_factor=[[0.0, 0.2], [1.0e4, 1.0]]),
    ], {}),
    "productivity_table": ([
        _prod("a", TOP[0], deliverability={
            "productivity": {"time": [[0.0, 1e-12], [5e4, 4e-12]]},
            "pressure": 1.0e6}),
        _prod("b", TOP[1], rate=-1.0, deliverability={
            "productivity": {"time": [[0.0, 2e-12], [5e4, 1e-12]]},
            "pressure": "initial"}, interpolation="step"),
    ], {}),
    "pref_constant_and_initial": ([
        _prod("a", TOP[0], deliverability=_deliv()),
        _prod("b", TOP[1], deliverability=_deliv(pressure="initial")),
    ], {}),
    "pref_time_table": ([
        _prod("a", TOP[0], deliverability=_deliv(
            pressure=[[0.0, 1.5e6], [5e4, 0.5e6]])),
        _prod("b", TOP[1], deliverability=_deliv(
            pressure={"time": [[0.0, 1.2e6], [5e4, 0.8e6]]})),
    ], {}),
    "pref_enthalpy_table": ([
        _prod(f"a{k}", c, deliverability=_deliv(
            pressure={"enthalpy": [[5e5, 1.5e6], [2e6, 0.5e6]]}))
        for k, c in enumerate(TOP)
    ], {}),
    "pref_pressure_table": ([
        _prod(f"a{k}", c, deliverability=_deliv(
            pressure={"pressure": [[1e6, 0.5e6], [4e6, 1.5e6]]}))
        for k, c in enumerate(TOP + LOW)
    ], {}),
    "productivity_from_rate": ([
        _prod("a", TOP[0], rate=-3.0, deliverability={"pressure": 1.0e6}),
        _prod("b", TOP[1], rate=RATE_TABLE,
              deliverability={"pressure": [[0.0, 1.1e6], [5e4, 0.9e6]]}),
        _prod("c", TOP[2], rate=-1.0, deliverability={"pressure": "initial"}),
    ], {}),
    "threshold": ([
        _prod("a", TOP[0], deliverability=_deliv(threshold=1.5e6)),
    ], {}),
    "recharge": ([
        _prod("a", 0, recharge={"coefficient": 1e-5, "pressure": 1.0e6}),
        _prod("b", 10, recharge={"coefficient": [[0.0, 1e-6], [5e4, 1e-5]],
                                 "pressure": "initial"}),
        _prod("c", 19, recharge=True),
    ], {}),
    "injectivity": ([
        _prod("a", 0, injectivity={"coefficient": 2e-6,
                                   "pressure": [[0.0, 5e6], [5e4, 6e6]]},
              enthalpy=4.0e5),
    ], {}),
    "direction": ([
        _prod("a", TOP[0], deliverability=_deliv(pressure=1e7),
              direction="production"),
        _prod("b", TOP[1], deliverability=_deliv(), direction="injection"),
        _prod("c", 5, rate=-1.0, direction="in"),
        _prod("d", 6, rate=1.0, direction="out"),
    ], {}),
    "source_separator": ([
        _prod("a", TOP[0], deliverability=_deliv(),
              separator={"pressure": 0.55e6}),
        _prod("b", TOP[1], deliverability=_deliv(),
              separator={"pressure": [1.2e6, 0.4e6]}),
        _prod("c", TOP[2], deliverability=_deliv(), separator=True),
        _prod("d", 5, rate=1.0, separator=True),
    ], {}),
    "source_limiters": ([
        _prod("a", TOP[0], deliverability=_deliv(productivity=1e-11),
              limiter={"limit": 0.5}),
        _prod("b", TOP[1], deliverability=_deliv(productivity=1e-11),
              limiter={"type": "steam", "limit": 0.05,
                       "separator_pressure": 0.55e6}),
        _prod("c", TOP[2], deliverability=_deliv(productivity=1e-11),
              separator=True, limiter={"water": 0.3, "steam": 0.1}),
        _prod("d", TOP[3], deliverability=_deliv(productivity=1e-11),
              limiter={"total": [[0.0, 0.2], [5e4, 1.0]]}),
    ], {}),
    "group_separator": (_four_producers(), {"group": [
        _sep_group("g", ["p0", "p1", "p2"]),
        {"name": "h", "in": ["p3"]},
    ]}),
    "group_limiter_uniform": (_four_producers(), {"group": [
        _sep_group("g", ["p0", "p1"], limiter={"steam": 0.02}),
        _sep_group("h", ["p2", "p3"], limiter={"total": 0.1}),
        {"name": "all", "in": ["g", "h"], "limiter": {"total": 0.12}},
    ]}),
    "group_limiter_progressive": (_four_producers(), {"group": [
        {"name": "g", "in": ["p0", "p1", "p2"], "scaling": "progressive",
         "limiter": {"total": [[0.0, 0.1], [5e4, 0.3]]}},
        {"name": "all", "in": ["g", "p3"], "scaling": "progressive",
         "limiter": {"type": "water", "limit": 0.1,
                     "separator_pressure": 0.55e6}},
    ]}),
    "reinjector_rate": (_four_producers() + _injectors(
        3, enthalpy=3.0e5) + [_prod("rated", LOW[3], rate=0.01)], {
        "group": [_sep_group("g", ["p0", "p1", "p2", "p3"])],
        "reinject": [{"name": "r", "in": "g", "water": [
            {"out": "i0", "rate": 0.01},
            {"out": "i1", "rate": [[0.0, 0.005], [5e4, 0.02]],
             "enthalpy": 1.0e5},
            {"out": "rated", "rate": 1.0},
            {"out": "i2"},
        ], "steam": [{"out": "i2", "rate": 0.001}]}],
    }),
    "reinjector_proportion": (_four_producers(
        separator={"pressure": 0.55e6}) + _injectors(), {
        "reinject": [{"name": "r", "in": "p0", "water": [
            {"out": "i0", "proportion": 0.3},
            {"out": "i1", "proportion": [[0.0, 0.1], [5e4, 0.5]]},
            {"out": "i2", "proportion": 0.9},
        ], "steam": [{"out": "i3", "proportion": 0.5}]}],
    }),
    "reinjector_overflow": (_four_producers() + _injectors(), {
        "group": [_sep_group("g", ["p0", "p1", "p2", "p3"])],
        "reinject": [
            {"name": "r1", "in": "g", "overflow": "r2",
             "water": [{"out": "i0", "rate": 0.002}]},
            {"name": "r2", "overflow": "r3", "water": [
                {"out": "i1", "rate": 0.001}, {"out": "r3", "rate": 0.001}]},
            {"name": "r3", "water": [{"out": "i2", "proportion": 0.5},
                                     {"out": "i3"}]},
        ],
    }),
}


def _config(sources, network):
    cfg = eos_model_config("we", 5, 4, 3)
    cfg["source"] = copy.deepcopy(sources)
    if network:
        cfg["network"] = copy.deepcopy(network)
    return cfg


def _field_config():
    return network_model_config(5, 4, 3)


def _fluids(sj, st, seed=3):
    import jax.numpy as jnp

    y, region = two_phase_state(sj, seed)
    fj, _, _ = sj.system.derived_state(jnp.asarray(y), jnp.asarray(region),
                                       sj.rock)
    ft, _, _ = st.system.derived_state(torch.as_tensor(y),
                                       torch.as_tensor(region), st.rock)
    return (y, region), fj, ft


def _close(got, want, what):
    got = np_(got).astype(np.float64)
    want = np.asarray(want, np.float64)
    scale = np.abs(want).max() if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12 * scale,
                               err_msg=what)


def _check_flows(sj, st):
    _, fj, ft = _fluids(sj, st)
    cj, ct = {}, {}
    qj, hj = sj.sources.flows(fj, T0, T1, collect=cj)
    qt, ht = st.sources.flows(ft, T0, T1, collect=ct)
    _close(qt, qj, "rate")
    _close(ht, hj, "enthalpy")
    for k, name in enumerate(("qw", "hw", "qs", "hs")):
        _close(ct["separated"][k], cj["separated"][k], f"separated {name}")
    assert set(ct.get("group", {})) == set(cj.get("group", {}))
    for g, nj in cj.get("group", {}).items():
        nt = ct["group"][g]
        for a in ("q", "h", "qw", "hw", "qs", "hs"):
            _close(getattr(nt, a), getattr(nj, a), f"group {g} {a}")
    assert set(ct.get("reinject", {})) == set(cj.get("reinject", {}))
    for r, dj in cj.get("reinject", {}).items():
        assert list(ct["reinject"][r]) == list(dj)
        for k, v in dj.items():
            _close(ct["reinject"][r][k], v, f"reinjector {r} {k}")
    if st.tracers is not None:
        _close(st.sources.tracer_injection(T0, T1),
               sj.sources.tracer_injection(T0, T1), "tracer injection")
    return qt, ct


@pytest.mark.parametrize("case", list(CASES))
def test_flows_match_jax(case):
    """The flows of every case equal the JAX package's. A deliverability
    threshold is read and applied by neither package (ROADMAP C14): the
    port warns that it is ignored."""
    sources, network = CASES[case]
    if case == "threshold":
        with pytest.warns(UserWarning, match="threshold is read but not "
                          "applied"):
            sj, st = sim_pair(_config(sources, network))
    else:
        sj, st = sim_pair(_config(sources, network))
    q, collect = _check_flows(sj, st)
    assert torch.isfinite(q).all()
    if case.startswith("reinjector"):
        assert any(float(v["output_water_rate"]) > 0
                   for v in collect["reinject"].values())


def test_field_flows_match_jax():
    """The production-field network of chip_smoke.py phase 9 at
    5 x 4 x 3: its groups' limits act."""
    sj, st = sim_pair(_field_config())
    _, collect = _check_flows(sj, st)
    net = st.sources
    names = [g.name for g in net.groups]
    field = collect["group"]["field"]
    limit = net.groups[names.index("field")].limiter.total[0]
    assert abs(float(field.q)) == pytest.approx(limit, rel=1e-12)


def test_network_errors_match_jax():
    """A cycle of groups or reinjectors and an unknown node are errors in
    both packages."""
    srcs = _four_producers()
    for net, match in (
        ({"group": [{"name": "a", "in": ["b"]}, {"name": "b", "in": ["a"]}]},
         "cyclic source network group"),
        ({"group": [{"name": "a", "in": ["nowhere"]}]}, "unknown network"),
        ({"reinject": [{"name": "a", "overflow": "b"},
                       {"name": "b", "overflow": "a"}]}, "cyclic reinjector"),
    ):
        for pkg in range(2):
            with pytest.raises(ValueError, match=match):
                sim_pair(_config(srcs, net))[pkg]


def test_jacobian_with_network_matches_jax():
    """jacobian_parts of the phase 9 model (groups, progressive and
    uniform scaling, separators, reinjectors, tracers) against the JAX
    package's, f64, within 1e-10 of each block's largest entry. Group
    scales and reinjected rates are detached in both: a coupling left on
    the tangent chain would leak other cells' tangents into the diagonal
    blocks of the cell-chain jvp."""
    import jax
    import jax.numpy as jnp
    from waiwera_tpu.solver.system import MethodCoeffs as JCoeffs
    from waiwera_tpu_torch.solver.system import MethodCoeffs as TCoeffs

    sj, st = sim_pair(_field_config())
    (y, region), _, _ = _fluids(sj, st, seed=5)
    lhs0, _, _ = sj.lhs_at(sj.y0, sj.region0)
    cj = JCoeffs(c_lhs=jnp.asarray(1.0), dt_eff=jnp.asarray(1.0e4),
                 const=-lhs0)
    ct = TCoeffs(c_lhs=1.0, dt_eff=1.0e4,
                 const=-torch.as_tensor(np.array(lhs0)))
    pj = jax.jit(lambda y_, r_: sj.system.jacobian_parts(
        y_, r_, sj.rock, cj, jnp.asarray(T0), jnp.asarray(T1)))(
            jnp.asarray(y), jnp.asarray(region))
    pt = st.system.jacobian_parts(torch.as_tensor(y), torch.as_tensor(region),
                                  st.rock, ct, T0, T1)
    # f32 tangent chain (the bench's solver): within 2e-4 of each block's
    # largest entry of the exact (f64) parts, as tests/torch_parity.py
    # check_system holds the other models
    pt32 = st.system.jacobian_parts(torch.as_tensor(y),
                                    torch.as_tensor(region), st.rock, ct, T0,
                                    T1, tangent_dtype=torch.float32)
    for parts, atol, what in ((pt, 1e-10, "f64"), (pt32, 2e-4, "f32")):
        for a, b, name in zip(parts, pj, ("diag", "J_lr", "J_rl")):
            a, b = np_(a).astype(np.float64), np.asarray(b)
            scale = np.abs(b).max(axis=0, keepdims=True) + 1e-30
            np.testing.assert_allclose(a / scale, b / scale, rtol=0,
                                       atol=atol, err_msg=f"{what} {name}")
    # the network's sources sit in cells whose diagonal blocks it moves
    rj, *_ = sj.system.residual(jnp.asarray(y), jnp.asarray(region),
                                sj.rock, cj, jnp.asarray(T0), jnp.asarray(T1))
    rt, *_ = st.system.residual(torch.as_tensor(y), torch.as_tensor(region),
                                st.rock, ct, T0, T1)
    np.testing.assert_allclose(np_(rt), np.asarray(rj), rtol=1e-10,
                               atol=1e-10 * np.abs(np.asarray(rj)).max())


def _many_well_sim(ns):
    """ns wells of three kinds (rate table + separator, deliverability
    + limiter, injection + enthalpy table: tests/test_network.py:72) in
    a progressive group with a limiter, feeding a reinjector."""
    from waiwera_tpu_torch.mesh.rect import rectangular_mesh
    from waiwera_tpu_torch.sim.simulation import Simulation

    nx = ny = 16
    sources = []
    for i in range(ns):
        kind = i % 3
        src = {"name": f"w{i}", "cell": i % (nx * ny)}
        if kind == 0:
            src.update(rate=[[0.0, -0.1 - 0.001 * i], [1e6, -0.2]],
                       separator={"pressure": 0.55e6})
        elif kind == 1:
            src.update(deliverability={"productivity": 1e-12,
                                       "pressure": 2.0e5},
                       limiter={"limit": 5.0})
        else:
            src.update(rate=0.05, enthalpy=[[0.0, 500e3], [1e6, 600e3]])
        sources.append(src)
    sources.append({"name": "inj", "cell": 0})
    config = {
        "eos": {"name": "we"},
        "initial": {"primary": [30e5, 150.0], "region": 1},
        "source": sources,
        "network": {
            "group": [{"name": "all", "in": [f"w{i}" for i in range(ns)],
                       "scaling": "progressive", "separator": True,
                       "limiter": {"total": 1.0}}],
            "reinject": [{"name": "r", "in": "all",
                          "water": [{"out": "inj"}]}],
        },
    }
    mesh = rectangular_mesh([50.0] * nx, [50.0] * ny, [20.0])
    return Simulation(config, mesh=mesh, device="cpu")


def test_flows_op_count_constant():
    """flows dispatches the same number of torch operations for 10 and
    for 200 sources (the port's counterpart of
    tests/test_network.py:120): no Python loop over sources, the group's
    progressive scaling included, runs inside the residual."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n += 1
            return func(*args, **(kwargs or {}))

    counts = {}
    for ns in (10, 200):
        sim = _many_well_sim(ns)
        fluid, _ = sim.initial_fluid()
        sim.sources.flows(fluid, 0.0, 100.0)  # tables copied once
        with Count() as c:
            q, _ = sim.sources.flows(fluid, 0.0, 100.0)
        counts[ns] = c.n
        assert q.shape == (ns + 1,) and torch.isfinite(q).all()
    assert counts[10] == counts[200], counts
