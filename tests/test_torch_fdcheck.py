"""The finite-difference check of the AD Jacobian (solver/fdcheck.py)
against the JAX package's, on the cases of tests/test_solver.py:1008
(a 16-cell column under "we" and "wge" with a fixed-rate and a
deliverability source): the same probes (numpy RandomState), the same
J v (rtol 1e-10) and central differences (within 1e-6 of their largest
entry) along them, and errors both below the JAX test's 1e-5. The error
itself is the central differences' round-off, ~1e-8 in both packages,
whose residuals differ in their last bits: the two errors agree within
1e-7, not to a relative tolerance. Then the check through
System.make_matvec on a banded box, where the matvec is the band SpMV."""

import numpy as np
import pytest

from torch_parity import np_


def _config(eos_name, primary):
    return {
        "eos": {"name": eos_name},
        "initial": {"primary": primary, "region": 1},
        "source": [
            {"cell": 15, "rate": -0.01},
            {"cell": 3, "deliverability": {"productivity": 1e-12,
                                           "pressure": 1.0e5}},
        ],
    }


@pytest.mark.parametrize("eos_name, primary", [
    ("we", [5.0e6, 180.0]),
    ("wge", [5.0e6, 180.0, 1.0e5]),
])
def test_jacobian_fd_error_matches_jax(eos_name, primary):
    import jax.numpy as jnp
    from waiwera_tpu.mesh.rect import column_mesh as jcolumn
    from waiwera_tpu.sim.simulation import Simulation as JSim
    from waiwera_tpu.solver.fdcheck import jacobian_fd_error as jfd
    from waiwera_tpu.solver.system import MethodCoeffs as JCoeffs
    from waiwera_tpu_torch.mesh.rect import column_mesh as tcolumn
    from waiwera_tpu_torch.sim.simulation import Simulation as TSim
    from waiwera_tpu_torch.solver.fdcheck import jacobian_fd_error as tfd
    from waiwera_tpu_torch.solver.system import MethodCoeffs as TCoeffs

    sj = JSim(_config(eos_name, primary), mesh=jcolumn([10.0] * 16))
    st = TSim(_config(eos_name, primary), mesh=tcolumn([10.0] * 16),
              device="cpu")
    dt = 1.0e4
    lj, _, _ = sj.lhs_at(sj.y0, sj.region0)
    lt, _, _ = st.lhs_at(st.y0, st.region0)
    cj = JCoeffs(c_lhs=jnp.asarray(1.0), dt_eff=jnp.asarray(dt), const=-lj)
    ct = TCoeffs(c_lhs=1.0, dt_eff=dt, const=-lt)

    def t0(sim):
        return jnp.asarray(0.0) if sim is sj else 0.0

    et = tfd(st.system, st.y0, st.region0, st.rock, ct, 0.0, dt)
    ej = jfd(sj.system, sj.y0, sj.region0, sj.rock, cj, jnp.asarray(0.0),
             jnp.asarray(dt))
    assert et < 1e-5 and ej < 1e-5, (et, ej)
    assert abs(et - ej) < 1e-7, (et, ej)

    # the ingredients along fdcheck's first probe
    import torch

    rng = np.random.RandomState(0)
    v = rng.standard_normal(tuple(st.y0.shape))
    v *= np_(st.system.interior_mask)[:, None]
    h = 1e-6
    out = []
    for sim, coeffs, t1, arr, to_np in (
            (sj, cj, jnp.asarray(dt), jnp.asarray, np.asarray),
            (st, ct, dt, torch.as_tensor, np_)):
        mat = sim.system.residual_and_jacobian(sim.y0, sim.region0,
                                               sim.rock, coeffs, t0(sim),
                                               t1)[4]
        jv = sim.system.make_matvec(mat)(arr(v))
        rp = sim.system.residual(sim.y0 + h * arr(v), sim.region0, sim.rock,
                                 coeffs, t0(sim), t1)[0]
        rm = sim.system.residual(sim.y0 - h * arr(v), sim.region0, sim.rock,
                                 coeffs, t0(sim), t1)[0]
        out.append((to_np(jv), (to_np(rp) - to_np(rm)) / (2.0 * h)))
    (jvj, fdj), (jvt, fdt) = out
    np.testing.assert_allclose(jvt, jvj, rtol=1e-10,
                               atol=1e-10 * np.abs(jvj).max())
    np.testing.assert_allclose(fdt, fdj, rtol=0,
                               atol=1e-6 * np.abs(fdj).max())


def test_jacobian_fd_error_band_route():
    """The check on the flagship's 5 x 4 x 3 box (banded, with a top
    boundary): make_matvec takes the band layout and agrees with the ELL
    matvec of the same matrix; the error is small."""
    import torch
    from torch_parity import torch_coeffs, torch_sim
    from waiwera_tpu_torch.ops import ell
    from waiwera_tpu_torch.solver.fdcheck import jacobian_fd_error

    sim = torch_sim(5, 4, 3)
    system = sim.system
    assert system.dia is not None
    coeffs, _ = torch_coeffs(sim, 1.0e4)
    err = jacobian_fd_error(system, sim.y0, sim.region0, sim.rock, coeffs,
                            0.0, 1.0e4)
    assert err < 1e-5
    mat = system.residual_and_jacobian(sim.y0, sim.region0, sim.rock,
                                       coeffs, 0.0, 1.0e4)[4]
    v = torch.as_tensor(np.random.default_rng(2).standard_normal(
        tuple(sim.y0.shape)))
    band = system.make_matvec(mat)(v)
    plain = ell.to_ell(mat, system.ell_tables).matvec(v)
    torch.testing.assert_close(band, plain, rtol=1e-12,
                               atol=1e-12 * float(plain.abs().max()))
