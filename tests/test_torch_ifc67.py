"""IFC-67 thermodynamics of waiwera_tpu_torch against waiwera_tpu in f64
on the same inputs (rtol 1e-10, as tests/test_torch_thermo.py: only
libm round-off differs), plus the golden values of tests/test_ifc67.py
(the reference's IFC67_test.F90). The saturation temperature's Newton
steps take nested forward-mode derivatives; its derivative under an
outer jvp is held against jax.jvp."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import np_
from waiwera_tpu.thermo import ifc67 as jx
from waiwera_tpu_torch.thermo import ifc67 as tx

RTOL = 1e-10
N = 64
TC_K = 273.15


def _both(fn_jax, fn_torch, *args):
    oj = fn_jax(*(jnp.asarray(a) for a in args))
    ot = fn_torch(*(torch.as_tensor(np.array(a)) for a in args))
    if not isinstance(oj, tuple):
        oj, ot = (oj,), (ot,)
    return [np.asarray(a) for a in oj], [np_(b) for b in ot]


def _check(oj, ot, rtol=RTOL):
    for a, b in zip(oj, ot):
        assert a.shape == b.shape
        if a.dtype == bool:
            np.testing.assert_array_equal(b, a)
        else:
            assert b.dtype == np.float64
            np.testing.assert_allclose(b, a, rtol=rtol, atol=0)


@pytest.fixture
def rng():
    return np.random.default_rng(30)


def test_saturation_line(rng):
    t = np.concatenate([rng.uniform(-5.0, 380.0, N), [1.0, tx.TCRITICAL]])
    _check(*_both(jx.saturation_pressure, tx.saturation_pressure, t))
    p = np.concatenate([10.0 ** rng.uniform(2.5, 7.5, N), [610.0, 3.0e7]])
    _check(*_both(jx.saturation_temperature, tx.saturation_temperature, p))
    # d Tsat / dP through the 12 Newton steps (nested jvp inside)
    pin = 10.0 ** rng.uniform(4.0, 7.2, 16)
    _, dj = jax.jvp(lambda v: jx.saturation_temperature(v)[0],
                    (jnp.asarray(pin),), (jnp.ones(16),))
    _, dt = torch.func.jvp(lambda v: tx.saturation_temperature(v)[0],
                           (torch.as_tensor(pin),),
                           (torch.ones(16, dtype=torch.float64),))
    np.testing.assert_allclose(np_(dt), np.asarray(dj), rtol=1e-9)


def test_regions_1_2(rng):
    t = rng.uniform(1.0, 360.0, N)
    p = 10.0 ** rng.uniform(4.0, 8.1, N)
    _check(*_both(jx.region1_properties, tx.region1_properties, p, t))
    t2 = rng.uniform(1.0, 820.0, N)
    p2 = 10.0 ** rng.uniform(2.0, 7.5, N)
    _check(*_both(jx.region2_properties, tx.region2_properties, p2, t2))


def test_viscosity(rng):
    t = rng.uniform(5.0, 370.0, N)
    p = 10.0 ** rng.uniform(4.0, 7.5, N)
    d = rng.uniform(0.1, 600.0, N)
    _check(*_both(jx.viscosity_liquid, tx.viscosity_liquid, t, p))
    _check(*_both(jx.viscosity_steam, tx.viscosity_steam, t, d))
    thj, tht = jx.IFC67(), tx.IFC67()
    d2 = np.concatenate([d, rng.uniform(700.0, 1000.0, 8)])
    t2 = np.concatenate([t, rng.uniform(5.0, 300.0, 8)])
    _check(*_both(thj.viscosity, tht.viscosity, t2, d2))
    for phase in (0, 1):
        _check(*_both(
            lambda a, b, c: thj.phase_viscosity(phase, a, b, c),
            lambda a, b, c: tht.phase_viscosity(phase, a, b, c), t, p, d))


def test_backend_and_names():
    from waiwera_tpu_torch import thermo

    for name in ("ifc67", "IFC-67", " ifc-67 "):
        assert isinstance(thermo.from_name(name), tx.IFC67)
    th = tx.IFC67()
    assert th.tcritical == tx.TCRITICAL and th.pcritical == tx.PCRITICAL
    assert tx.IFC67(extrapolate=True).region1_max_temperature == 360.0
    region = torch.tensor([1, 2, 4, 3], dtype=torch.int32)
    phases = th.phase_composition(region, torch.zeros(4), torch.zeros(4))
    assert phases.dtype == torch.int32
    np.testing.assert_array_equal(np_(phases), [0b01, 0b10, 0b11, 0])
    with pytest.raises(NotImplementedError):
        th.supercritical_properties(torch.zeros(1), torch.zeros(1))


# golden values of tests/test_ifc67.py (IFC67_test.F90)

def test_golden_region1():
    p = np.array([3e6, 80e6, 3e6])
    t = np.array([300.0, 300.0, 500.0]) - TC_K
    d, e, err = tx.region1_properties(torch.as_tensor(p), torch.as_tensor(t))
    np.testing.assert_allclose(
        np_(d), [997.95721560998174, 1029.7256888266911, 831.84196191567298],
        rtol=1e-10)
    np.testing.assert_allclose(
        np_(e), [112247.43313085975, 106310.47344628950, 971985.91117384087],
        rtol=1e-10)
    assert not np_(err).any()
    _, _, err = tx.region1_properties(torch.tensor([20e6, 101e6]),
                                      torch.tensor([360.0, 60.0]))
    assert np_(err).all()


def test_golden_region2():
    p = np.array([0.0035e6, 0.0035e6, 30e6])
    t = np.array([300.0, 700.0, 700.0]) - TC_K
    d, e, err = tx.region2_properties(torch.as_tensor(p), torch.as_tensor(t))
    np.testing.assert_allclose(
        np_(d), [2.5316826343790743e-2, 1.0834441421293962e-2,
                 183.90041953968711], rtol=1e-10)
    np.testing.assert_allclose(
        np_(e), [2412405.0932077002, 3012229.4965919587, 2474981.3799304822],
        rtol=1e-10)
    assert not np_(err).any()
    _, _, err = tx.region2_properties(torch.tensor([20e6, 101e6]),
                                      torch.tensor([801.0, 60.0]))
    assert np_(err).all()


def test_golden_saturation_and_viscosity():
    t = torch.tensor([300.0, 500.0, 600.0], dtype=torch.float64) - TC_K
    p = np.array([0.35323426e4, 0.263961572e7, 0.123493902e8])
    ps, err = tx.saturation_pressure(t)
    np.testing.assert_allclose(np_(ps), p, rtol=3e-8)
    assert not np_(err).any()
    ts, err = tx.saturation_temperature(torch.as_tensor(p))
    np.testing.assert_allclose(np_(ts), np_(t), atol=1e-6)
    assert not np_(err).any()
    assert np_(tx.saturation_pressure(torch.tensor([380.0]))[1]).all()
    assert np_(tx.saturation_temperature(torch.tensor([30e6]))[1]).all()
    v1 = tx.viscosity_liquid(
        torch.tensor([298.15, 373.15], dtype=torch.float64) - TC_K,
        torch.tensor([1977563.58349, 99834578.2816], dtype=torch.float64))
    np.testing.assert_allclose(np_(v1), [8.903129e-4, 2.988268e-4],
                               rtol=1e-6)
    v2 = tx.viscosity_steam(
        torch.tensor([873.15, 873.15], dtype=torch.float64) - TC_K,
        torch.tensor([1.0, 100.0], dtype=torch.float64))
    np.testing.assert_allclose(np_(v2), [3.249537e-5, 3.667671e-5],
                               rtol=1e-6)
