"""Interpolation tables, relative permeability and capillary pressure of
waiwera_tpu_torch against waiwera_tpu in f64: InterpolationTable
(linear, step, pchip; integral, average, inverse; from_json), the seven
relative-permeability models and the four capillarity models of both
packages' from_json, on grids that hold the table ends, the knots and
points beyond them. Values within rtol 1e-12 (the same operations in
the same order), and the forward-mode derivatives, which the AD
Jacobian takes through these curves, within rtol 1e-10."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import np_

RTOL = 1e-12

# knots out of order (the tables sort them) and a flat segment
DATA = [[0.0, 1.0, -2.0], [0.7, 3.5, 0.0], [0.2, 2.0, 1.0],
        [0.45, 2.0, 4.0], [1.0, 0.5, 4.5]]


def _tables(interpolation, averaging="integrate", data=DATA):
    from waiwera_tpu.utils import interpolation as ji
    from waiwera_tpu_torch.utils import interpolation as ti

    spec = {"interpolation": interpolation, "averaging": averaging}
    return ji.from_json(data, spec), ti.from_json(data, spec)


def _grid():
    """The knots, the table ends, midpoints and points beyond the ends."""
    knots = np.array(sorted(r[0] for r in DATA))
    mids = 0.5 * (knots[1:] + knots[:-1])
    rng = np.random.default_rng(11)
    return np.concatenate([knots, mids, [-0.3, 1.4],
                           rng.uniform(-0.2, 1.2, 24)])


def _close(got, want, rtol=RTOL):
    got, want = np_(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == np.float64
    np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-300)


@pytest.mark.parametrize("interpolation", ["linear", "step", "pchip"])
def test_table_evaluation(interpolation):
    tj, tt = _tables(interpolation)
    x = _grid()
    _close(tt(torch.as_tensor(x)), tj(jnp.asarray(x)))
    _close(tt.component(torch.as_tensor(x), 1),
           tj.component(jnp.asarray(x), 1))
    # 0-d and 2-d evaluation points
    _close(tt(torch.tensor(0.3, dtype=torch.float64)), tj(0.3))
    x2 = x[:24].reshape(4, 6)
    _close(tt(torch.as_tensor(x2)), tj(jnp.asarray(x2)))
    if interpolation != "step":
        # derivatives between the knots
        xm = np.array([0.1, 0.3, 0.5, 0.9])
        _, dj = jax.jvp(tj, (jnp.asarray(xm),), (jnp.ones(4),))
        _, dt = torch.func.jvp(tt, (torch.as_tensor(xm),),
                               (torch.ones(4, dtype=torch.float64),))
        _close(dt, dj, rtol=1e-10)


@pytest.mark.parametrize("interpolation", ["linear", "step", "pchip"])
@pytest.mark.parametrize("averaging", ["integrate", "endpoint"])
def test_table_integral_and_average(interpolation, averaging):
    tj, tt = _tables(interpolation, averaging)
    rng = np.random.default_rng(12)
    a = np.concatenate([_grid(), rng.uniform(-0.5, 1.5, 8)])
    b = a + np.concatenate([np.zeros(4), rng.uniform(0.0, 0.8, len(a) - 4)])
    lo, hi = np.minimum(a, b), np.maximum(a, b)
    _close(tt.integral(torch.as_tensor(lo), torch.as_tensor(hi)),
           tj.integral(jnp.asarray(lo), jnp.asarray(hi)))
    # the average either way round, zero-length intervals included
    for u, v in ((a, b), (b, a)):
        _close(tt.average(torch.as_tensor(u), torch.as_tensor(v)),
               tj.average(jnp.asarray(u), jnp.asarray(v)))


def test_table_inverse_and_single_row():
    from waiwera_tpu.utils.interpolation import InterpolationTable as JT
    from waiwera_tpu_torch.utils.interpolation import InterpolationTable \
        as TT

    # increasing column 1 and decreasing column 0
    data = [[0.0, 5.0, 1.0], [1.0, 3.0, 2.0], [2.5, 2.0, 4.0],
            [4.0, 0.5, 4.5]]
    tj, tt = JT(data), TT(data)
    for index, yi in ((0, np.array([6.0, 5.0, 4.0, 2.0, 1.0, 0.5, 0.0])),
                      (1, np.array([0.0, 1.0, 1.5, 3.0, 4.0, 4.5, 9.0]))):
        _close(tt.inverse(torch.as_tensor(yi), index),
               tj.inverse(jnp.asarray(yi), index))
    one_j, one_t = JT([[2.0, 7.0]]), TT([[2.0, 7.0]])
    x = np.array([0.0, 2.0, 5.0])
    _close(one_t(torch.as_tensor(x)), one_j(jnp.asarray(x)))
    _close(one_t.average(torch.as_tensor(x), torch.as_tensor(x + 1.0)),
           one_j.average(jnp.asarray(x), jnp.asarray(x + 1.0)))


def test_tables_follow_dtype_and_device():
    _, tt = _tables("pchip")
    x = torch.linspace(-0.1, 1.1, 9, dtype=torch.float32)
    y = tt(x)
    assert y.dtype == torch.float32 and y.device == x.device
    np.testing.assert_allclose(
        np_(y), np_(tt(x.to(torch.float64))), rtol=2e-6, atol=1e-6)


RELPERM = {
    "fully_mobile": {"type": "fully mobile"},
    "linear": {"type": "linear", "liquid": [0.2, 0.8],
               "vapour": [0.1, 0.6]},
    "linear_step": {"type": "linear", "liquid": [0.5, 0.5],
                    "vapour": [0.3, 0.3]},
    "pickens": {"type": "pickens", "power": 2.5},
    "corey": {"type": "corey", "slr": 0.3, "ssr": 0.1},
    "grant": {"type": "grant"},
    "van_genuchten": {"type": "van_genuchten", "lambda": 0.5,
                      "slr": 0.1},
    "van_genuchten_sum": {"type": "van_genuchten", "sum_unity": False,
                          "slr": 0.05, "ssr": 0.2},
    "table": {"type": "table", "interpolation": "pchip",
              "liquid": [[0.0, 0.0], [0.3, 0.05], [1.0, 1.0]],
              "vapour": [[0.0, 0.0], [0.6, 0.7], [1.0, 1.0]]},
}


def _saturations():
    """Saturations at 0 and 1, at each model's limits and in between."""
    rng = np.random.default_rng(13)
    edges = [0.0, 1.0, 0.05, 0.1, 0.2, 0.3, 0.5, 0.6, 0.7, 0.8, 0.9, 0.95]
    return np.concatenate([edges, rng.uniform(0.0, 1.0, 40)])


@pytest.mark.parametrize("name", list(RELPERM))
def test_relative_permeability(name):
    from waiwera_tpu.physics import relperm as jrp
    from waiwera_tpu_torch.physics import relperm as trp

    mj, mt = jrp.from_json(RELPERM[name]), trp.from_json(RELPERM[name])
    assert type(mt).__name__ == type(mj).__name__
    sl = _saturations()
    _close(mt(torch.as_tensor(sl)), mj(jnp.asarray(sl)))
    # derivatives away from the kinks
    rng = np.random.default_rng(14)
    s = rng.uniform(0.31, 0.79, 16)
    _, dj = jax.jvp(mj, (jnp.asarray(s),), (jnp.ones(16),))
    _, dt = torch.func.jvp(mt, (torch.as_tensor(s),),
                           (torch.ones(16, dtype=torch.float64),))
    _close(dt, dj, rtol=1e-10)


CAPILLARITY = {
    "zero": {"type": "zero"},
    "linear": {"type": "linear", "saturation_limits": [0.2, 0.9],
               "pressure": 2.0e4},
    "linear_step": {"type": "linear", "saturation_limits": [0.4, 0.4]},
    "van_genuchten": {"type": "van_genuchten", "P0": 1.0e4,
                      "lambda": 0.45, "slr": 1e-3},
    "van_genuchten_pmax": {"type": "van-genuchten", "P0": 2.0e4,
                           "lambda": 0.3, "slr": 0.1, "sls": 0.95,
                           "Pmax": 1.0e5},
    "table": {"type": "table", "interpolation": "linear",
              "pressure": [[0.0, -3.0e4], [0.4, -1.0e4], [1.0, 0.0]]},
}


@pytest.mark.parametrize("name", list(CAPILLARITY))
def test_capillary_pressure(name):
    from waiwera_tpu.physics import capillarity as jcp
    from waiwera_tpu_torch.physics import capillarity as tcp

    mj, mt = jcp.from_json(CAPILLARITY[name]), tcp.from_json(
        CAPILLARITY[name])
    assert type(mt).__name__ == type(mj).__name__
    sl = np.concatenate([_saturations(), [0.9995, 0.999, 1.2, -0.1]])
    t = np.full_like(sl, 150.0)
    _close(mt(torch.as_tensor(sl), torch.as_tensor(t)),
           mj(jnp.asarray(sl), jnp.asarray(t)))
    s = np.random.default_rng(15).uniform(0.45, 0.85, 16)
    tt = torch.full((16,), 150.0, dtype=torch.float64)
    _, dj = jax.jvp(lambda v: mj(v, jnp.full(16, 150.0)), (jnp.asarray(s),),
                    (jnp.ones(16),))
    _, dt = torch.func.jvp(lambda v: mt(v, tt), (torch.as_tensor(s),),
                           (torch.ones(16, dtype=torch.float64),))
    _close(dt, dj, rtol=1e-10)


@pytest.mark.parametrize("module, spec", [
    ("relperm", {"type": "brooks_corey"}),
    ("capillarity", {"type": "leverett"}),
])
def test_unknown_curve_raises(module, spec):
    from waiwera_tpu_torch.physics import capillarity, relperm

    mod = {"relperm": relperm, "capillarity": capillarity}[module]
    with pytest.raises(ValueError, match="unknown"):
        mod.from_json(spec)
