"""The smaller parts of the JAX package's interface that the port offers
too, each against the JAX package on the same numpy inputs on the CPU:
IAPWS97's supercritical_properties, viscosity, boundary23_pressure and
boundary23_temperature; Thermodynamics.region_properties, which raises
in both; NCG.partial_pressure_of; FluidState.phase_present;
Mesh.interior_cell_mask; and BSRMatrix.matvec, whose row sums run in
storage order (ops/segment.py). The formulas are the same, so only libm
round-off differs: rtol 1e-10 for the thermodynamics (as
tests/test_torch_thermo.py), 1e-13 for the gas law and the product."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_bsr_precond import laplacian_pair
from torch_parity import np_

RTOL = 1e-10
N = 64


@pytest.fixture
def rng():
    return np.random.default_rng(8)


def _close(ot, oj, rtol=RTOL):
    ot = ot if isinstance(ot, tuple) else (ot,)
    oj = oj if isinstance(oj, tuple) else (oj,)
    assert len(ot) == len(oj)
    for b, a in zip(ot, oj):
        a, b = np.asarray(a), np_(b)
        assert a.shape == b.shape
        if a.dtype == bool:
            np.testing.assert_array_equal(b, a)
        else:
            np.testing.assert_allclose(b, a, rtol=rtol, atol=0)


@pytest.mark.parametrize("method", ["supercritical_properties", "viscosity",
                                    "boundary23_pressure",
                                    "boundary23_temperature"])
def test_iapws97_methods_match_jax(method, rng):
    from waiwera_tpu.thermo.iapws97 import IAPWS97 as JIAPWS
    from waiwera_tpu_torch.thermo.iapws97 import IAPWS97 as TIAPWS

    args = {
        "supercritical_properties": (rng.uniform(100.0, 600.0, N),
                                     rng.uniform(350.0, 800.0, N)),
        "viscosity": (rng.uniform(1.0, 800.0, N),
                      rng.uniform(0.1, 1000.0, N)),
        "boundary23_pressure": (rng.uniform(350.0, 590.0, N),),
        "boundary23_temperature": (10.0 ** rng.uniform(7.2, 8.0, N),),
    }[method]
    oj = getattr(JIAPWS(), method)(*(jnp.asarray(a) for a in args))
    ot = getattr(TIAPWS(), method)(*(torch.as_tensor(a) for a in args))
    _close(ot, oj)
    # the static methods answer on the class too
    if method != "supercritical_properties":
        _close(getattr(TIAPWS, method)(*(torch.as_tensor(a) for a in args)),
               oj)


def test_region_properties_raises_in_both():
    from waiwera_tpu.thermo.base import Thermodynamics as JThermo
    from waiwera_tpu_torch.thermo.base import Thermodynamics as TThermo

    p, t = np.full(3, 1.0e6), np.full(3, 100.0)
    with pytest.raises(NotImplementedError):
        JThermo().region_properties(jnp.ones(3), jnp.asarray(p),
                                    jnp.asarray(t))
    with pytest.raises(NotImplementedError):
        TThermo().region_properties(torch.ones(3), torch.as_tensor(p),
                                    torch.as_tensor(t))


@pytest.mark.parametrize("gas", ["air", "co2"])
def test_partial_pressure_of_matches_jax(gas, rng):
    from waiwera_tpu.thermo import ncg as jncg
    from waiwera_tpu_torch.thermo import ncg as tncg

    t = rng.uniform(10.0, 300.0, N)
    rho = rng.uniform(0.5, 1000.0, N)
    xg = rng.uniform(0.0, 0.5, N)
    oj = jncg.from_name(gas).partial_pressure_of(
        jnp.asarray(t), jnp.asarray(rho), jnp.asarray(xg))
    ot = tncg.from_name(gas).partial_pressure_of(
        torch.as_tensor(t), torch.as_tensor(rho), torch.as_tensor(xg))
    _close(ot, oj, rtol=1e-13)


@pytest.mark.parametrize("num_phases", [2, 3])
def test_phase_present_matches_jax(num_phases):
    from waiwera_tpu.physics.state import empty_fluid as jempty
    from waiwera_tpu_torch.physics.state import empty_fluid as tempty

    comp = np.arange(2 ** num_phases, dtype=np.int32)
    fj = jempty(len(comp), num_phases, 2)._replace(
        phase_composition=jnp.asarray(comp))
    ft = tempty(len(comp), num_phases, 2)._replace(
        phase_composition=torch.as_tensor(comp))
    present = ft.phase_present()
    assert present.dtype == torch.bool
    assert present.shape == (len(comp), num_phases)
    _close(present, fj.phase_present())


def test_interior_cell_mask_matches_jax():
    from waiwera_tpu.mesh.core import add_boundaries as jadd
    from waiwera_tpu.mesh.rect import rectangular_mesh as jrect
    from waiwera_tpu_torch.mesh.core import add_boundaries as tadd
    from waiwera_tpu_torch.mesh.rect import rectangular_mesh as trect

    widths = ([10.0] * 3, [20.0] * 2, [5.0] * 4)
    spec = [{"primary": [1.0e5, 20.0], "region": 1,
             "faces": {"cells": [20, 21, 22], "normal": [0.0, 0.0, 1.0]}}]
    mj = jrect(*widths)
    mt = trect(*widths)
    jadd(mj, spec, 2)
    tadd(mt, spec, 2)
    mask = mt.interior_cell_mask
    assert mask.dtype == bool and mask.sum() == 24 and len(mask) == 27
    np.testing.assert_array_equal(mask, np.asarray(mj.interior_cell_mask))


@pytest.mark.parametrize("b", [1, 3])
def test_bsr_matvec_matches_jax(b):
    n = 9
    mj, mt = laplacian_pair(n, b, seed=b)
    x = np.random.default_rng(b).standard_normal((n, b))
    y = mt.matvec(torch.as_tensor(x))
    _close(y, mj.matvec(jnp.asarray(x)), rtol=1e-13)
    # the storage-order sum is index_add's on the CPU, bit for bit
    s = mt.structure
    prod = torch.einsum("kij,kj->ki", mt.data,
                        torch.as_tensor(x)[torch.as_tensor(s.indices)])
    ref = torch.zeros(n, b, dtype=torch.float64).index_add_(
        0, torch.as_tensor(s.rows), prod)
    assert torch.equal(y, ref)


def test_newton_params_fields_match_jax():
    """NewtonParams has the JAX package's fields and defaults, pc_sweeps
    included."""
    from waiwera_tpu.solver.newton import NewtonParams as JParams
    from waiwera_tpu_torch.solver.newton import NewtonParams as TParams

    assert TParams._fields == JParams._fields
    assert TParams._field_defaults == JParams._field_defaults
    assert TParams(pc_sweeps=1).pc_sweeps == 1


@pytest.mark.parametrize("sweeps", [1, 3])
def test_asm_sweeps_match_jax_band_dilu(sweeps):
    """linear_operator_from_parts(..., "asm", sweeps=) on the f64
    Jacobian of tests/test_solver.py's _rect_system(5, 4, 3) equals the
    JAX package's band DILU with the same sweeps at f64 round-off; one
    sweep differs from three."""
    from torch_parity import rect_system_pair

    sj, st = rect_system_pair(5, 4, 3)
    from waiwera_tpu.solver.system import MethodCoeffs as JCoeffs

    lhs0, _, _ = sj.lhs_at(sj.y0, sj.region0)
    cj = JCoeffs(c_lhs=jnp.asarray(1.0), dt_eff=jnp.asarray(1e4),
                 const=-lhs0)
    parts = [np.array(p) for p in sj.system.jacobian_parts(
        sj.y0, sj.region0, sj.rock, cj, jnp.asarray(0.0), jnp.asarray(1e4))]
    _, pj = sj.system.linear_operator_from_parts(
        [jnp.asarray(p) for p in parts], "asm", sweeps=sweeps)
    pt_parts = [torch.as_tensor(p) for p in parts]
    _, pt = st.system.linear_operator_from_parts(pt_parts, "asm",
                                                 sweeps=sweeps)
    n = st.mesh.num_cells
    r = np.random.default_rng(4).standard_normal((n, 2))
    zj = np.asarray(pj(jnp.asarray(r)))
    zt = np_(pt(torch.as_tensor(r)))
    np.testing.assert_allclose(zt, zj, rtol=1e-12,
                               atol=1e-12 * np.abs(zj).max())
    _, p3 = st.system.linear_operator_from_parts(pt_parts, "asm")
    assert (np_(p3(torch.as_tensor(r))) == zt).all() == (sweeps == 3)
