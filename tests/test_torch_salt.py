"""Salt (NaCl) and CO2 thermodynamics of waiwera_tpu_torch against
waiwera_tpu in f64 on the same inputs (rtol 1e-10), on IAPWS-97 and on
IFC-67, plus the golden values of tests/test_salt.py
(salt_thermodynamics_test.F90) and tests/test_ncg.py
(ncg_co2_thermodynamics_test.F90). The finite-difference Newton loops
(brine saturation temperature, two-phase solubility) are held with their
forward-mode derivatives, which the AD Jacobian takes through every
iteration (rtol 1e-8), and compute in f64 for an f32 input."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import np_

RTOL = 1e-10
N = 48


def _thermo(name):
    from waiwera_tpu import thermo as jthermo
    from waiwera_tpu_torch import thermo as tthermo

    return jthermo.from_name(name), tthermo.from_name(name)


@pytest.fixture(params=["ifc67", "iapws"])
def thermos(request):
    return _thermo(request.param)


def _check(oj, ot, rtol=RTOL):
    if not isinstance(oj, tuple):
        oj, ot = (oj,), (ot,)
    for a, b in zip(oj, ot):
        a, b = np.asarray(a), np_(b)
        assert a.shape == b.shape
        if a.dtype == bool:
            np.testing.assert_array_equal(b, a)
        else:
            assert b.dtype == np.float64
            np.testing.assert_allclose(b, a, rtol=rtol, atol=1e-300)


def _j(*a):
    return [jnp.asarray(v) for v in a]


def _t(*a):
    return [torch.as_tensor(np.array(v)) for v in a]


def test_halite_and_brine_saturation(thermos):
    from waiwera_tpu.thermo import salt as js
    from waiwera_tpu_torch.thermo import salt as ts

    thj, tht = thermos
    rng = np.random.default_rng(40)
    t = np.concatenate([rng.uniform(-5.0, 360.0, N), [0.0, 100.0]])
    p = 10.0 ** rng.uniform(4.0, 7.5, len(t))
    xs = rng.uniform(0.0, 0.3, len(t))
    _check(js.halite_solubility(*_j(t)), ts.halite_solubility(*_t(t)))
    _check(js.halite_properties(*_j(p, t)), ts.halite_properties(*_t(p, t)))
    _check(js.salt_mole_fraction(*_j(xs)), ts.salt_mole_fraction(*_t(xs)))
    _check(js.brine_saturation_pressure(thj, *_j(t, xs)),
           ts.brine_saturation_pressure(tht, *_t(t, xs)))
    pin = 10.0 ** rng.uniform(3.5, 7.3, N)
    xin = rng.uniform(0.0, 0.3, N)
    _check(js.brine_saturation_temperature(thj, *_j(pin, xin)),
           ts.brine_saturation_temperature(tht, *_t(pin, xin)))
    # the two-phase solubility up to 12 MPa: above it the Newton steps
    # reach temperatures where the saturation curve is clamped, the
    # finite-difference slope is round-off and the iterates (in both
    # packages) are round-off too
    p2 = 10.0 ** rng.uniform(3.5, np.log10(1.2e7), N)
    _check(js.halite_solubility_two_phase(thj, *_j(p2)),
           ts.halite_solubility_two_phase(tht, *_t(p2)))


def test_fd_newton_derivatives(thermos):
    """d/dP of the brine saturation temperature and of the two-phase
    solubility through every Newton iteration, and their f32 inputs."""
    from waiwera_tpu.thermo import salt as js
    from waiwera_tpu_torch.thermo import salt as ts

    thj, tht = thermos
    rng = np.random.default_rng(41)
    p = 10.0 ** rng.uniform(4.5, 7.0, 16)
    xs = rng.uniform(0.0, 0.25, 16)
    one_j, one_t = jnp.ones(16), torch.ones(16, dtype=torch.float64)
    for fj, ft in (
            (lambda v: js.brine_saturation_temperature(thj, v,
                                                       jnp.asarray(xs))[0],
             lambda v: ts.brine_saturation_temperature(
                 tht, v, torch.as_tensor(xs))[0]),
            (lambda v: js.halite_solubility_two_phase(thj, v)[0],
             lambda v: ts.halite_solubility_two_phase(tht, v)[0])):
        _, dj = jax.jvp(fj, (jnp.asarray(p),), (one_j,))
        _, dt = torch.func.jvp(ft, (torch.as_tensor(p),), (one_t,))
        np.testing.assert_allclose(np_(dt), np.asarray(dj), rtol=1e-8)
        # an f32 input is solved in f64 and returned in f32
        out32 = ft(torch.as_tensor(p, dtype=torch.float32))
        assert out32.dtype == torch.float32
        np.testing.assert_allclose(np_(out32), np_(ft(torch.as_tensor(p))),
                                   rtol=1e-6)


def test_brine_properties_and_viscosity(thermos):
    from waiwera_tpu.thermo import salt as js
    from waiwera_tpu_torch.thermo import salt as ts

    thj, tht = thermos
    rng = np.random.default_rng(42)
    # liquid states, and low-pressure hot ones that take the
    # extrapolation branch (T*_V above the saturation temperature)
    p = np.concatenate([10.0 ** rng.uniform(5.0, 7.5, N),
                        rng.uniform(1e5, 5e5, 8)])
    t = np.concatenate([rng.uniform(10.0, 300.0, N),
                        rng.uniform(130.0, 170.0, 8)])
    xs = rng.uniform(0.0, 0.3, len(p))
    _check(js.brine_properties(thj, *_j(p, t, xs)),
           ts.brine_properties(tht, *_t(p, t, xs)))
    _check(js.brine_viscosity(thj, *_j(t, p, xs)),
           ts.brine_viscosity(tht, *_t(t, p, xs)))


def test_co2_and_air_against_jax():
    from waiwera_tpu.thermo import ncg as jn
    from waiwera_tpu_torch.thermo import ncg as tn

    rng = np.random.default_rng(43)
    t = rng.uniform(5.0, 320.0, N)
    pg = np.concatenate([[0.0, 1e5, 1e7, 1.5e7, 3e7, 3.1e7],
                         10.0 ** rng.uniform(3.0, 7.4, N - 6)])
    xs = rng.uniform(0.0, 0.3, N)
    xg = rng.uniform(0.0, 0.9, N)
    wv = rng.uniform(1e-5, 3e-4, N)
    for name in ("co2", "air"):
        gj, gt = jn.from_name(name), tn.from_name(name)
        assert gt.name == gj.name
        assert gt.molecular_weight == gj.molecular_weight
        _check(gj.properties(*_j(pg, t)), gt.properties(*_t(pg, t)))
        for m in ("henrys_constant", "henrys_derivative", "energy_solution"):
            _check(getattr(gj, m)(*_j(t)), getattr(gt, m)(*_t(t)))
        for m in ("henrys_constant_salt", "henrys_derivative_salt",
                  "energy_solution_salt"):
            _check(getattr(gj, m)(*_j(t, xs)), getattr(gt, m)(*_t(t, xs)))
        for phase in (0, 1):
            _check(gj.mixture_viscosity(*_j(wv, t, pg, xg), phase),
                   gt.mixture_viscosity(*_t(wv, t, pg, xg), phase))
    _check(jn.CO2NCG().gas_viscosity(*_j(pg, t)),
           tn.CO2NCG().gas_viscosity(*_t(pg, t)))
    with pytest.raises(ValueError, match="unknown NCG"):
        tn.from_name("h2s")


# golden values of tests/test_salt.py (salt_thermodynamics_test.F90)

def test_golden_salt():
    from waiwera_tpu_torch.thermo import salt as ts

    _, th = _thermo("ifc67")
    f64 = lambda v: torch.tensor(v, dtype=torch.float64)  # noqa: E731
    sol, _ = ts.halite_solubility(f64([20.0, 100.0, 200.0, 300.0, 400.0]))
    np.testing.assert_allclose(
        np_(sol), [0.26420860, 0.28062682, 0.31730904, 0.37747855,
                   0.47145444], rtol=1e-7)
    assert bool(ts.halite_solubility(f64([-1.0]))[1][0])
    t = f64([20.0, 100.0, 200.0, 300.0, 350.0])
    ps, _ = th.saturation_pressure(t)
    d, u = ts.halite_properties(ps, t)
    np.testing.assert_allclose(
        np_(d), [2.16544208e3, 2.14485199e3, 2.11751462e3, 2.08882457e3,
                 2.07423883e3], rtol=1e-8)
    np.testing.assert_allclose(
        np_(u), [-5.44002467e5, -4.73170767e5, -3.83011549e5,
                 -2.90739752e5, -2.43776955e5], rtol=1e-8)
    cases = [(20.0, 0.0, 2.33656155e3), (100.0, 0.0, 1.01325262e5),
             (350.0, 0.0, 1.65351241e7), (20.0, 0.1, 2.18332495e3),
             (200.0, 0.1, 1.45229349e6), (100.0, 0.2, 8.55888487e4),
             (300.0, 0.2, 7.26807523e6), (20.0, 0.3, 1.57322067e3),
             (350.0, 0.3, 1.24826404e7)]
    tc, xc, pc = (f64([c[k] for c in cases]) for k in range(3))
    ps, err = ts.brine_saturation_pressure(th, tc, xc)
    assert not np_(err).any()
    np.testing.assert_allclose(np_(ps), np_(pc), rtol=1e-8)
    tb, terr = ts.brine_saturation_temperature(th, ps, xc)
    assert not np_(terr).any()
    np.testing.assert_allclose(np_(tb), np_(tc), rtol=1e-7)
    cases = [(20.0, 0.0, 1.00174876e-03), (200.0, 0.0, 1.33827807e-04),
             (100.0, 0.1, 3.47717807e-4), (300.0, 0.2, 1.58754327e-4),
             (350.0, 0.3, 1.98459127e-4)]
    tc, xc, mc = (f64([c[k] for c in cases]) for k in range(3))
    mu, err = ts.brine_viscosity(th, tc, th.saturation_pressure(tc)[0], xc)
    assert not np_(err).any()
    np.testing.assert_allclose(np_(mu), np_(mc), rtol=1e-7)
    # two density / enthalpy points of the reference grid
    # (salt_thermodynamics_test.F90:438-524)
    d, u, err = ts.brine_properties(th, f64([1.0e5, 100.0e5]),
                                    f64([10.0, 300.0]), f64([0.0, 0.25]))
    assert not np_(err).any()
    np.testing.assert_allclose(np_(d), [0.99979351e3, 0.97012926e3],
                               rtol=1e-6)
    np.testing.assert_allclose(np_(u) + np.array([1.0e5, 100.0e5]) / np_(d),
                               [0.42090543e5, 0.10749918e7], rtol=2e-6)


# golden values of tests/test_ncg.py (ncg_co2_thermodynamics_test.F90)

def test_golden_co2():
    from waiwera_tpu_torch.thermo.ncg import CO2NCG

    gas = CO2NCG()
    f64 = lambda v: torch.tensor(v, dtype=torch.float64)  # noqa: E731
    np.testing.assert_allclose(
        np_(gas.henrys_constant(f64([20.0, 100.0, 240.0, 300.0]))),
        [1.44811504032e8, 5.50571700000e8, 5.21847810624e8,
         3.71913900000e8], rtol=1e-10)
    np.testing.assert_allclose(float(gas.energy_solution(f64(20.0))),
                               -495750.87299689, rtol=1e-9)
    data = np.array([
        [0.0, 20.0, 17140.18077231938, 0.0],
        [100000.0, 20.0, 16142.247883091828, 1.8142044368713437],
        [4000000.0, 100.0, 64355.3813832885, 62.608990505735434],
        [9000000.0, 100.0, 20379.357776952613, 184.7959892299282],
        [100000.0, 240.0, 223439.99865083068, 1.0324489144812645],
        [9000000.0, 300.0, 270338.58607276645, 87.3627658128452],
    ])
    d, h, err = gas.properties(f64(data[:, 0]), f64(data[:, 1]))
    np.testing.assert_allclose(np_(h), data[:, 2], rtol=1e-9)
    np.testing.assert_allclose(np_(d), data[:, 3], rtol=1e-9, atol=1e-12)
    assert not np_(err).any()
    v, err = gas.gas_viscosity(f64([1e5, 1e6, 31e6]), f64([50.0] * 3))
    np.testing.assert_array_equal(np_(err), [False, False, True])
    assert 1e-5 < float(v[0]) < 2e-5
