"""The Jacobian's cell-chain kernel for the water, air and energy EOS
(csrc/wge_cell_jvp.cu, ops/wge_cell.py).

On the CPU:
- the kernel's coefficient tables, viscosity terms and column offsets
  against the Python modules and ops/wge_cell.py's LAYOUT, bit for bit;
- the route rule: wge (air) and wae on IAPWS-97 with fully mobile and
  zero curves on a CUDA device take the kernel; wce, we, w, wse, wsge,
  IFC-67, Corey, van Genuchten and every CPU tensor take the plain chain;
- the kernel route's Python around the kernel (the output views, the
  source term's tangents by the chain rule, the assembly) with the
  launch replaced by the plain chain's values: jacobian_parts equal bit
  for bit to the plain route's, one launch counted per Jacobian;
- the plain chain (System.cell_jvp) whose primal is derived_state's.

On the card (marked cuda; skip without a CUDA device): the kernel
against the plain chain on a state with cells in regions 1, 2 and 4,
cells within 0.1 deg C of saturation, the 20 deg C, 1 bar ghosts and a
few out-of-range cells. In f32 each field's largest error against the
plain chain in f64 is at most twice the plain f32 chain's; in f64 the
kernel matches the plain f64 chain to 1e-12 of each field's largest
magnitude (sums in another order); the error flags and phase
compositions are equal. jacobian_parts on the kernel route is held to
the plain route the same way, and the flagship's tries as replayed CUDA
graphs are bitwise equal to the same tries eagerly, with one launch per
Newton iteration in each. The machine with the card has no JAX; run
these there with
`python -m pytest --noconftest -m cuda tests/test_torch_wge_cell.py`.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from waiwera_tpu_torch import eos as eos_mod
from waiwera_tpu_torch import thermo as thermo_mod
from waiwera_tpu_torch.ops import wge_cell
from waiwera_tpu_torch.physics import capillarity as cp_mod
from waiwera_tpu_torch.physics import relperm as relperm_mod
from waiwera_tpu_torch.solver.system import MethodCoeffs
from waiwera_tpu_torch.thermo import iapws97, ncg

SOURCE = (Path(wge_cell.__file__).resolve().parent.parent / "csrc"
          / "wge_cell_jvp.cu").read_text()


def _constant_table(name):
    m = re.search(r"__constant__ double " + name + r"\[(\d+)\] = \{([^}]*)\}",
                  SOURCE)
    assert m, name
    vals = [float(v) for v in m.group(2).replace("\n", " ").split(",")
            if v.strip()]
    assert len(vals) == int(m.group(1))
    return np.array(vals)


@pytest.mark.parametrize("name, table", [
    ("R1_GAMPI_N", iapws97._R1_GAMPI[0]), ("R1_GAMPI_I", iapws97._R1_GAMPI[1]),
    ("R1_GAMPI_J", iapws97._R1_GAMPI[2]), ("R1_GAMT_N", iapws97._R1_GAMT[0]),
    ("R1_GAMT_I", iapws97._R1_GAMT[1]), ("R1_GAMT_J", iapws97._R1_GAMT[2]),
    ("R2_GAMT0_N", iapws97._R2_GAMT0[0]), ("R2_GAMT0_J", iapws97._R2_GAMT0[1]),
    ("R2_GAMPI_N", iapws97._R2_GAMPI[0]), ("R2_GAMPI_I", iapws97._R2_GAMPI[1]),
    ("R2_GAMPI_J", iapws97._R2_GAMPI[2]), ("R2_GAMT_N", iapws97._R2_GAMT[0]),
    ("R2_GAMT_I", iapws97._R2_GAMT[1]), ("R2_GAMT_J", iapws97._R2_GAMT[2]),
    ("SAT_N", iapws97._SAT_N), ("VISC_H0", iapws97._VISC_H0),
    ("VISC_H1", iapws97._VISC_H1),
    ("AIR_ENTHALPY", ncg.AirNCG._ENTHALPY),
    ("AIR_HENRY", ncg.AirNCG._HENRY),
    ("AIR_HENRY_DERIV", np.stack(ncg.AirNCG()._henry_deriv)),
    ("AIR_WEIGHT", np.array(ncg.AirNCG._WEIGHT)),
    ("AIR_HENRY_P0", np.array(ncg.AirNCG._HENRY_P0)),
])
def test_kernel_tables_are_the_modules(name, table):
    np.testing.assert_array_equal(_constant_table(name),
                                  np.asarray(table, np.float64).ravel())


def test_kernel_viscosity_terms_and_layout():
    terms = [tuple(map(int, t)) for t in
             re.findall(r"VISC_TERM\((\d+), (\d+), (\d+)\)", SOURCE)]
    assert terms == [(k, int(i), int(j)) for k, (i, j) in enumerate(
        zip(iapws97._VISC_I, iapws97._VISC_J))]
    enum = dict((k, int(v)) for k, v in
                re.findall(r"\b(F_[A-Z_]+|[A-Z]+_COLUMNS) = (\d+)", SOURCE))
    col = 0
    for name, shape in wge_cell.LAYOUT:
        assert enum[f"F_{name.upper()}"] == col, name
        col += int(np.prod(shape))
    assert enum["F_BALANCES"] == col == wge_cell.PRIMAL_COLUMNS
    assert enum["PRIMAL_COLUMNS"] == wge_cell.PRIMAL_COLUMNS
    assert enum["TANGENT_COLUMNS"] == wge_cell.TANGENT_COLUMNS == col + 3
    # the layout's fields are FluidState's floating fields in order
    from waiwera_tpu_torch.physics.state import INT_FIELDS, FluidState
    assert [k for k, _ in wge_cell.LAYOUT[:-1]] == [
        k for k in FluidState._fields if k not in INT_FIELDS]


def _eos(name, thermo="iapws", relperm=None, capillarity=None, gas=None):
    cfg = {"eos": {"name": name, **({"gas": gas} if gas else {})}}
    return eos_mod.from_json(cfg, thermo_mod.from_name(thermo),
                             relperm_mod.from_json(relperm),
                             cp_mod.from_json(capillarity))


@pytest.mark.parametrize("kw, covered", [
    (dict(name="wge"), True),
    (dict(name="wae"), True),
    (dict(name="wge", gas="air"), True),
    (dict(name="wge", relperm={"type": "fully_mobile"},
          capillarity={"type": "zero"}), True),
    (dict(name="wge", gas="co2"), False),
    (dict(name="wce"), False),
    (dict(name="we"), False),
    (dict(name="w"), False),
    (dict(name="wse"), False),
    (dict(name="wsge"), False),
    (dict(name="wae", thermo="ifc67"), False),
    (dict(name="wae", relperm={"type": "corey"}), False),
    (dict(name="wae", relperm={"type": "linear"}), False),
    (dict(name="wae", capillarity={"type": "van_genuchten"}), False),
])
def test_route_rule(kw, covered):
    e = _eos(**kw)
    assert wge_cell.route(e, torch.device("cuda")) is covered
    assert wge_cell.route(e, "cuda:0") is covered
    assert wge_cell.route(e, "cpu") is False


def test_cpu_systems_take_the_plain_chain():
    from chip_smoke import build_sim, eos_model_config
    from waiwera_tpu_torch.sim.simulation import Simulation

    sim = build_sim(4, 3, 2, "cpu")
    assert wge_cell.route(sim.eos, "cuda")
    assert sim.system.cell_kernel is False
    assert sim.system._cell_params is None
    we = Simulation(eos_model_config("we", 4, 3, 2), device="cpu")
    assert we.system.cell_kernel is False


def _state(sim, seed=3):
    """Scaled primaries and regions (f64 and int32 tensors on the
    simulation's device): interior cells in regions 1, 2 and 4 at random
    (a fifth of the single-phase cells within 0.1 deg C of saturation),
    the ghosts as they are, and two out-of-range cells (a liquid above
    350 deg C, a two-phase cell below the saturation line's lowest
    pressure)."""
    rng = np.random.default_rng(seed)
    ghost = sim.mesh_dev.is_ghost.cpu().numpy()
    primary = sim.eos.unscale(sim.y0, sim.region0).cpu().numpy().copy()
    region = sim.region0.cpu().numpy().astype(np.int32)
    idx = np.flatnonzero(~ghost)
    region[idx] = rng.choice([1, 2, 4], len(idx))
    p = rng.uniform(2.0e5, 8.0e6, len(idx))
    pg = p * rng.uniform(0.0, 0.05, len(idx))
    pg[::7] = 0.0
    tsat = iapws97.saturation_temperature(torch.as_tensor(p - pg))[0].numpy()
    near = rng.uniform(0.0, 1.0, len(idx)) < 0.2
    gap = np.where(near, rng.uniform(0.005, 0.1, len(idx)),
                   rng.uniform(1.0, 60.0, len(idx)))
    r = region[idx]
    second = np.where(r == 1, np.maximum(tsat - gap, 5.0),
                      np.where(r == 2, tsat + gap,
                               rng.uniform(1e-3, 1.0 - 1e-3, len(idx))))
    primary[idx] = np.stack([p, second, pg], axis=-1)
    primary[idx[0]] = [2.0e7, 355.0, 1.0e5]
    region[idx[0]] = 1
    primary[idx[1]] = [500.0, 0.5, 0.0]
    region[idx[1]] = 4
    dev = sim.y0.device
    region_t = torch.as_tensor(region, device=dev)
    y = sim.eos.scale(torch.as_tensor(primary, device=dev), region_t)
    return y, region_t


def _fields(fluid, cond, d_fluid, d_cond, dL):
    names = [k for k, _ in wge_cell.LAYOUT[:-1]]
    out = dict(zip(names, fluid.float_fields()))
    out["conductivity"] = cond
    out.update({f"d_{k}": v for k, v in zip(names, d_fluid)})
    out["d_conductivity"] = d_cond
    out["dL"] = dL
    return out


def test_kernel_route_around_the_launch(monkeypatch):
    """The kernel route on the CPU with the launch replaced by the plain
    chain's values written into the kernel's output views: the views,
    the source tangents by the chain rule and the assembly give the plain
    route's parts bit for bit."""
    from chip_smoke import build_sim

    sim = build_sim(5, 4, 3, "cpu")
    system = sim.system
    y, region = _state(sim)
    coeffs = MethodCoeffs(c_lhs=1.0, dt_eff=1.0e5,
                          const=torch.zeros_like(y))

    def plain_launch(params, y64, region32, rock, is_ghost, primal, tangent,
                     phases, err):
        assert params is system._cell_params
        dtype = primal.dtype
        fluid, cond, d_fluid, d_cond, dL, _ = system.cell_jvp(
            y64.to(dtype), region32, sim.rock.to(dtype), 0.0, 1.0e5)
        out = wge_cell.views(primal, tangent, phases)
        for got, want in zip(
                out.floats + (out.cond,) + out.d_fluid + (out.d_cond, out.dL),
                fluid.float_fields() + (cond,) + tuple(d_fluid)
                + (d_cond, dL)):
            got.copy_(want)
        phases.copy_(fluid.phase_composition)

    for dtype in (torch.float32, torch.float64):
        want = system.jacobian_parts(y, region, sim.rock, coeffs, 0.0, 1.0e5,
                                     tangent_dtype=dtype)
        monkeypatch.setattr(wge_cell, "_launch", plain_launch)
        monkeypatch.setattr(system, "cell_kernel", True)
        monkeypatch.setattr(system, "_cell_params",
                            wge_cell.wge_params(sim.eos))
        before = wge_cell.wge_cell_jvp_launches.count
        got = system.jacobian_parts(y, region, sim.rock, coeffs, 0.0, 1.0e5,
                                    tangent_dtype=dtype)
        assert wge_cell.wge_cell_jvp_launches.count == before + 1
        monkeypatch.undo()
        for g, w in zip(got, want):
            assert g.dtype == dtype
            assert torch.equal(g, w)


def test_kernel_wrapper_refuses_cpu_tensors():
    from chip_smoke import build_sim

    sim = build_sim(3, 2, 2, "cpu")
    with pytest.raises(ValueError, match="CUDA"):
        wge_cell.cell_jvp(wge_cell.wge_params(sim.eos), sim.y0,
                          sim.region0, sim.rock, sim.mesh_dev.is_ghost,
                          torch.float32)
    with pytest.raises(TypeError):
        wge_cell.cell_jvp(wge_cell.wge_params(sim.eos), sim.y0,
                          sim.region0, sim.rock, sim.mesh_dev.is_ghost,
                          torch.float16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_plain_cell_chain_primal_is_derived_state(dtype):
    from chip_smoke import build_sim

    sim = build_sim(5, 4, 3, "cpu")
    y, region = _state(sim)
    rock = sim.rock.to(dtype)
    fluid, cond, d_fluid, d_cond, dL, dq = sim.system.cell_jvp(
        y.to(dtype), region, rock, 0.0, 1.0e5)
    f, c, _ = sim.system.derived_state(y.to(dtype), region, rock)
    for a, b in zip(fluid, f):
        assert torch.equal(a, b)
    assert torch.equal(cond, c)
    n = y.shape[0]
    assert dL.shape == dq.shape == (3, n, 3)
    assert d_cond.shape == (3, n)
    assert torch.all(dL[:, sim.mesh_dev.is_ghost] == 0)
    # the pressure's tangents are its scale (1e6) under seed 0, zero else
    assert torch.all(d_fluid[0][0] == 1.0e6)
    assert torch.all(d_fluid[0][1:] == 0)


# -- on the card -------------------------------------------------------

def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")


def _rel_err(got, truth):
    """Largest error over the field's largest magnitude."""
    got = got.double()
    scale = truth.abs().max().clamp_min(1e-300)
    return float((got - truth).abs().max() / scale)


@pytest.fixture(scope="module")
def card_sim():
    _need_cuda()
    from chip_smoke import build_sim

    return build_sim(16, 12, 10, "cuda")


@pytest.mark.cuda
def test_cuda_kernel_f32_error_at_most_twice_the_plain_chains(card_sim):
    sim = card_sim
    system = sim.system
    assert system.cell_kernel
    y, region = _state(sim)
    truth = _fields(*system.cell_jvp(y, region, sim.rock, 0.0, 1.0e5)[:5])
    rock32 = sim.rock.to(torch.float32)
    plain = system.cell_jvp(y.float(), region, rock32, 0.0, 1.0e5)
    plain_f = _fields(*plain[:5])
    err = torch.empty(y.shape[0], dtype=torch.bool, device=y.device)
    out = wge_cell.cell_jvp(system._cell_params, y, region, sim.rock,
                            sim.mesh_dev.is_ghost, torch.float32, err=err)
    torch.cuda.synchronize()
    got = _fields(out.fluid(region), out.cond, out.d_fluid, out.d_cond,
                  out.dL)
    report = {k: (_rel_err(got[k], truth[k]), _rel_err(plain_f[k], truth[k]))
              for k in truth}
    bad = {k: v for k, v in report.items() if not v[0] <= 2.0 * v[1]}
    assert not bad, bad
    assert torch.equal(out.phase_composition, plain[0].phase_composition)
    _, _, err_plain = system.derived_state(y.float(), region, rock32)
    assert torch.equal(err, err_plain)
    assert bool(err_plain.any()) and not bool(err_plain.all())


@pytest.mark.cuda
def test_cuda_kernel_f64_matches_the_plain_chain(card_sim):
    sim = card_sim
    system = sim.system
    y, region = _state(sim, seed=5)
    plain = system.cell_jvp(y, region, sim.rock, 0.0, 1.0e5)
    want = _fields(*plain[:5])
    err = torch.empty(y.shape[0], dtype=torch.bool, device=y.device)
    out = wge_cell.cell_jvp(system._cell_params, y, region, sim.rock,
                            sim.mesh_dev.is_ghost, torch.float64, err=err)
    got = _fields(out.fluid(region), out.cond, out.d_fluid, out.d_cond,
                  out.dL)
    for k in want:
        scale = float(want[k].abs().max())
        torch.testing.assert_close(got[k], want[k], rtol=1e-12,
                                   atol=1e-12 * scale, msg=k)
    assert torch.equal(out.phase_composition, plain[0].phase_composition)
    assert torch.equal(err, system.derived_state(y, region, sim.rock)[2])


@pytest.mark.cuda
def test_cuda_jacobian_parts_kernel_route_against_plain(card_sim,
                                                        monkeypatch):
    sim = card_sim
    system = sim.system
    y, region = _state(sim, seed=11)
    coeffs = MethodCoeffs(c_lhs=1.0, dt_eff=1.0e5,
                          const=torch.zeros_like(y))

    def parts(dtype, kernel):
        monkeypatch.setattr(system, "cell_kernel", kernel)
        before = wge_cell.wge_cell_jvp_launches.count
        out = system.jacobian_parts(y, region, sim.rock, coeffs, 0.0, 1.0e5,
                                    tangent_dtype=dtype)
        assert wge_cell.wge_cell_jvp_launches.count == before + int(kernel)
        return out

    truth = parts(torch.float64, False)
    for g, p, t in zip(parts(torch.float32, True),
                       parts(torch.float32, False), truth):
        assert _rel_err(g, t) <= 2.0 * _rel_err(p, t)
    for g, t in zip(parts(torch.float64, True), truth):
        torch.testing.assert_close(g, t, rtol=1e-12,
                                   atol=1e-12 * float(t.abs().max()))


@pytest.mark.cuda
def test_cuda_graph_tries_bitwise_equal_eager():
    _need_cuda()
    from chip_smoke import build_sim, make_step, run_steps

    runs = []
    for eager in (False, True):
        sim = build_sim(12, 8, 6, "cuda")
        step = make_step(sim, eager=eager)
        before = wge_cell.wge_cell_jvp_launches.count
        tries = run_steps(sim, step, dts=(1.0e5, 2.0e4, 2.0e4))
        launches = wge_cell.wge_cell_jvp_launches.count - before
        assert launches == sum(int(r.iterations) for _, r, _ in tries)
        runs.append(tries)
    assert runs[0][0][1].host_syncs is not None
    for (_, g, _), (_, e, _) in zip(*runs):
        assert (g.converged, g.failed, g.iterations) == (
            e.converged, e.failed, e.iterations)
        assert torch.equal(g.y, e.y)
        assert torch.equal(g.region, e.region)
