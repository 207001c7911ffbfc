"""The equations of state w, we, wce, wse and wsge / wsae / wsce of
waiwera_tpu_torch against waiwera_tpu in f64, in the shape of
tests/test_torch_eos_wge.py: properties over every region of each EOS
(with Corey relative permeability and van Genuchten capillarity, the
salt EOS with a permeability modifier), scale/unscale, transitions that
cross each region boundary in both directions (for the salt EOS also
halite precipitation and dissolution), check_primary_variables,
primary_from_output_fields and primary_variables. Values within rtol
1e-10 (1e-8 where a transition's root find ran), regions and flags
equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import np_

RTOL = 1e-10
K = 12  # cells per region

# EOS name -> (thermodynamics, extra eos keys)
CASES = {
    "w": ("iapws", {"temperature": 35.0}),
    "we": ("iapws", {}),
    "wce": ("iapws", {}),
    "wse": ("ifc67", {"permeability_modifier": {"type": "power",
                                                "exponent": 2.0}}),
    "wse_vp": ("iapws", {"permeability_modifier": {"type": "verma-pruess"}}),
    "wsge": ("iapws", {"gas": "co2"}),
    "wsae": ("ifc67", {}),
    "wsce": ("iapws", {}),
}
CURVES = {"relative_permeability": {"type": "corey", "slr": 0.2,
                                    "ssr": 0.05},
          "capillary_pressure": {"type": "van_genuchten", "P0": 2.0e4,
                                 "lambda": 0.4, "slr": 1e-3}}


def _eos_name(case):
    return case.split("_")[0]


def _pair(case):
    from waiwera_tpu import eos as jeos
    from waiwera_tpu import thermo as jthermo
    from waiwera_tpu.physics import capillarity as jcp
    from waiwera_tpu.physics import relperm as jrp
    from waiwera_tpu_torch import eos as teos
    from waiwera_tpu_torch import thermo as tthermo
    from waiwera_tpu_torch.physics import capillarity as tcp
    from waiwera_tpu_torch.physics import relperm as trp

    thermo, extra = CASES[case]
    cfg = {"eos": dict(extra, name=_eos_name(case))}
    rp, cp = CURVES["relative_permeability"], CURVES["capillary_pressure"]
    ej = jeos.from_json(cfg, jthermo.from_name(thermo), jrp.from_json(rp),
                        jcp.from_json(cp))
    et = teos.from_json(cfg, tthermo.from_name(thermo), trp.from_json(rp),
                        tcp.from_json(cp))
    return ej, et


@pytest.fixture(scope="module", params=list(CASES))
def pair(request):
    return request.param, _pair(request.param)


def _regions(name):
    return {"w": (1, 2), "we": (1, 2, 4), "wce": (1, 2, 4)}.get(
        name, (1, 2, 4, 5, 6, 8))


def _states(name, rng):
    """(primary, region): K cells in each region of the EOS, with the
    primaries its regions take (eos_*.F90 primary variables)."""
    prim, reg = [], []
    for r in _regions(name):
        if r in (1, 5):  # liquid: P, T
            p = rng.uniform(2e6, 2e7, K)
            x = rng.uniform(20.0, 300.0, K)
        elif r in (2, 6):  # vapour: P, T
            p = rng.uniform(2e4, 5e5, K)
            x = rng.uniform(160.0, 340.0, K)
        else:  # two-phase: P, S_v
            p = rng.uniform(2e5, 5e6, K)
            x = rng.uniform(0.05, 0.6, K)
        if name == "w":
            p = rng.uniform(2e5, 2e7, K) if r == 1 else rng.uniform(
                5e2, 3e3, K)
            cols = [p]
        else:
            cols = [p, x]
        if name in ("wse", "wsge", "wsae", "wsce"):
            # salt mass fraction, or solid saturation where halite is
            # (region 2 holds a solid saturation too)
            salt = (rng.uniform(0.01, 0.3, K) if r in (2, 5, 6, 8)
                    else rng.uniform(0.0, 0.2, K))
            if r == 4:
                salt[4:6] = 0.0  # fresh water: dries out to region 2
            cols.append(salt)
        if name in ("wce", "wsge", "wsae", "wsce"):
            cols.append(rng.uniform(0.0, 0.2, K) * p)
        prim.append(np.stack(cols, axis=1))
        reg.append(np.full(K, r, np.int32))
    return np.concatenate(prim), np.concatenate(reg)


def _compare_fluids(fj, ft, rtol=RTOL):
    for field in fj._fields:
        a, b = np.asarray(getattr(fj, field)), np_(getattr(ft, field))
        assert a.shape == b.shape, field
        if a.dtype.kind in "iub":
            np.testing.assert_array_equal(b, a, err_msg=field)
        else:
            assert b.dtype == np.float64, field
            np.testing.assert_allclose(b, a, rtol=rtol, atol=1e-300,
                                       err_msg=field)


def _rock(n):
    from waiwera_tpu.physics.state import default_rock

    return default_rock(n)


def test_properties_scaling_and_restart(pair):
    """Properties, scale/unscale, conductivity, primary_variables and
    primary_from_output_fields, over every region."""
    from waiwera_tpu_torch.physics.state import default_rock

    case, (ej, et) = pair
    name = _eos_name(case)
    primary, region = _states(name, np.random.default_rng(3))
    n = len(region)
    assert et.num_primary_variables == primary.shape[1]
    for attr in ("name", "num_phases", "num_mobile_phases", "num_components",
                 "phase_names", "component_names", "isothermal",
                 "required_output_fluid_fields", "default_region"):
        assert getattr(et, attr) == getattr(ej, attr), attr
    np.testing.assert_array_equal(et.default_primary, ej.default_primary)
    np.testing.assert_array_equal(et.primary_scale, ej.primary_scale)
    fj, errj = ej.properties(jnp.asarray(primary), jnp.asarray(region),
                             _rock(n))
    ft, errt = et.properties(torch.as_tensor(primary),
                             torch.as_tensor(region), default_rock(n))
    _compare_fluids(fj, ft)
    np.testing.assert_array_equal(np_(errt), np.asarray(errj))

    sj = ej.scale(jnp.asarray(primary), jnp.asarray(region))
    st = et.scale(torch.as_tensor(primary), torch.as_tensor(region))
    np.testing.assert_allclose(np_(st), np.asarray(sj), rtol=RTOL)
    ut = et.unscale(st, torch.as_tensor(region))
    np.testing.assert_allclose(np_(ut), np.asarray(ej.unscale(
        sj, jnp.asarray(region))), rtol=RTOL)
    np.testing.assert_allclose(np_(ut), primary, rtol=1e-14)

    if not et.isothermal:
        np.testing.assert_allclose(
            np_(et.conductivity(default_rock(n), ft)),
            np.asarray(ej.conductivity(_rock(n), fj)), rtol=RTOL)

    # primaries back from the fluid state, and from the output fields
    np.testing.assert_allclose(np_(et.primary_variables(ft)),
                               np.asarray(ej.primary_variables(fj)),
                               rtol=RTOL)
    every = {
        "pressure": ft.pressure, "temperature": ft.temperature,
        "region": ft.region, "vapour_saturation": ft.saturation[:, -1],
        "liquid_salt_mass_fraction": ft.mass_fraction[:, 0, -1],
        "gas_partial_pressure": ft.partial_pressure[:, -1],
    }
    if et.num_phases == 3:
        every["vapour_saturation"] = ft.saturation[:, 1]
        every["solid_saturation"] = ft.saturation[:, 2]
        every["liquid_salt_mass_fraction"] = ft.mass_fraction[:, 0, 1]
    fields = {f: np_(every[f]) for f in et.required_output_fluid_fields}
    pj, rj = ej.primary_from_output_fields(fields)
    pt, rt = et.primary_from_output_fields(fields)
    np.testing.assert_array_equal(rt, rj)
    np.testing.assert_array_equal(pt, pj)
    np.testing.assert_array_equal(rt, region)


def _salt_transitions(ej, old, region, rng):
    """New primaries for the salt EOS that cross every boundary: the
    saturation line from each single-phase region (with and without
    halite), out of each two-phase region both ways, halite
    precipitation from regions 1, 2 and 4 and dissolution in 5, 6 and
    8."""
    from waiwera_tpu.thermo import salt as js

    th = ej.thermo
    new = old.copy()
    pg = old[:, 3] if old.shape[1] > 3 else np.zeros(len(old))
    h = K // 2
    for r in (1, 2, 4, 5, 6, 8):
        idx = np.flatnonzero(region == r)
        a, b = idx[:h], idx[h:]
        if r in (1, 5):
            # below the brine saturation pressure -> two-phase
            xs = (np.asarray(js.halite_solubility(jnp.asarray(old[a, 1]))[0])
                  if r == 5 else old[a, 2])
            ps, _ = js.brine_saturation_pressure(
                th, jnp.asarray(old[a, 1]), jnp.asarray(xs))
            new[a, 0] = 0.6 * np.asarray(ps) + pg[a]
        elif r in (2, 6):
            ps, _ = th.saturation_pressure(jnp.asarray(old[a, 1]))
            new[a, 0] = 1.6 * np.asarray(ps) + pg[a]
        else:
            new[a[: h // 2], 1] = -rng.uniform(0.01, 0.3, h // 2)
            new[a[h // 2:], 1] = 1.0 + rng.uniform(0.01, 0.3, h - h // 2)
        # the other half: halite in or out
        if r == 1:
            new[b, 2] = rng.uniform(0.5, 0.7, len(b))  # precipitates
        elif r == 4:
            new[b, 2] = rng.uniform(0.36, 0.45, len(b))
        elif r == 2:
            new[b, 2] = rng.uniform(0.01, 0.1, len(b))
        else:
            new[b, 2] = -rng.uniform(0.01, 0.1, len(b))  # dissolves
    return new


def _transition_cases(case, ej, rng):
    name = _eos_name(case)
    old, region = _states(name, rng)
    th = ej.thermo
    t_old = old[:, 1].copy() if old.shape[1] > 1 else np.full(len(old), 35.)
    two = np.isin(region, (4, 8))
    pw = old[:, 0] - (old[:, 3] if old.shape[1] > 3 else
                      (old[:, 2] if name == "wce" else 0.0))
    t_old[two] = np.asarray(th.saturation_temperature(jnp.asarray(
        pw[two]))[0])
    if name in ("wse", "wsge", "wsae", "wsce"):
        new = _salt_transitions(ej, old, region, rng)
    else:
        new = old.copy()
        if name != "w":
            pg = old[:, 2] if name == "wce" else 0.0
            h = K // 2
            i1 = np.flatnonzero(region == 1)[:h]
            ps, _ = th.saturation_pressure(jnp.asarray(old[i1, 1]))
            new[i1, 0] = 0.5 * np.asarray(ps) + (pg[i1] if name == "wce"
                                                  else 0.0)
            i2 = np.flatnonzero(region == 2)[:h]
            ps, _ = th.saturation_pressure(jnp.asarray(old[i2, 1]))
            new[i2, 0] = 1.5 * np.asarray(ps) + (pg[i2] if name == "wce"
                                                  else 0.0)
            i4 = np.flatnonzero(region == 4)
            new[i4[:h], 1] = -rng.uniform(0.01, 0.3, h)
            new[i4[h:], 1] = 1.0 + rng.uniform(0.01, 0.3, K - h)
    new[:, 0] *= 1.0 + rng.uniform(-0.01, 0.01, len(new))
    return old, new, region, t_old


EXPECTED = {
    "w": set(),
    "we": {(1, 4), (2, 4), (4, 1), (4, 2)},
    "wce": {(1, 4), (2, 4), (4, 1), (4, 2)},
    # salty vapour precipitates: region 4 -> 6 as well as 4 -> 2
    "salt": {(1, 4), (2, 4), (4, 1), (4, 2), (4, 6), (5, 8), (6, 8),
             (8, 5), (8, 6), (1, 5), (2, 6), (4, 8), (5, 1), (6, 2),
             (8, 4)},
}


def test_transition(pair):
    case, (ej, et) = pair
    name = _eos_name(case)
    old, new, region, t_old = _transition_cases(
        case, ej, np.random.default_rng(5))
    oj = ej.transition(jnp.asarray(old), jnp.asarray(new),
                       jnp.asarray(region), jnp.asarray(t_old))
    ot = et.transition(torch.as_tensor(old), torch.as_tensor(new),
                       torch.as_tensor(region), torch.as_tensor(t_old))
    prim_j, reg_j, tr_j, err_j = (np.asarray(a) for a in oj)
    prim_t, reg_t, tr_t, err_t = (np_(a) for a in ot)
    changed = set(zip(region[tr_j].tolist(), reg_j[tr_j].tolist()))
    want = EXPECTED.get(name, EXPECTED["salt"])
    assert want <= changed, sorted(want - changed)
    np.testing.assert_array_equal(reg_t, reg_j)
    assert reg_t.dtype == np.int32
    np.testing.assert_array_equal(tr_t, tr_j)
    np.testing.assert_array_equal(err_t, err_j)
    np.testing.assert_allclose(prim_t, prim_j, rtol=1e-8, atol=1e-12)


def test_check_primary_variables(pair):
    case, (ej, et) = pair
    name = _eos_name(case)
    primary, region = _states(name, np.random.default_rng(6))
    n, npv = primary.shape
    primary[0, 0] = -1.0  # bad pressure
    primary[1, 0] = 2e8  # pressure out of range
    if npv > 1:
        primary[2, 1] = 900.0  # temperature out of range
        i4 = np.flatnonzero(region == 4)
        if len(i4):
            primary[i4[0], 1] = 2.5  # saturation out of range
    if name in ("wse", "wsge", "wsae", "wsce"):
        primary[3, 2] = -0.1  # negative salt, region 1: clamped to 0
        primary[4, 2] = 1.5  # salt out of range
        i5 = np.flatnonzero(region == 5)
        primary[i5[0], 2] = -0.1  # negative solid: kept (halite)
    if name in ("wce", "wsge", "wsae", "wsce"):
        primary[5, -1] = -5.0  # negative gas pressure: clamped to 0
        primary[6, -1] = 2.0 * primary[6, 0]  # above the pressure
    pj, errj = ej.check_primary_variables(jnp.asarray(primary),
                                          jnp.asarray(region))
    pt, errt = et.check_primary_variables(torch.as_tensor(primary),
                                          torch.as_tensor(region))
    np.testing.assert_array_equal(np_(errt), np.asarray(errj))
    assert np_(errt)[[0, 1]].all()
    np.testing.assert_allclose(np_(pt), np.asarray(pj), rtol=RTOL, atol=0)


def test_from_json_names():
    """Every EOS name of the JAX package, "we" by default; an unknown
    name raises ValueError."""
    from waiwera_tpu_torch import eos as teos
    from waiwera_tpu_torch import thermo as tthermo
    from waiwera_tpu_torch.physics import capillarity, relperm

    th, rp, cp = (tthermo.from_name("iapws"), relperm.from_json(None),
                  capillarity.from_json(None))
    assert teos.from_json({}, th, rp, cp).name == "we"
    assert teos.from_json({"eos": "WSCE"}, th, rp, cp).gas.name == "CO2"
    gases = {"wge": "air", "wae": "air", "wce": "CO2", "wsge": "air",
             "wsae": "air", "wsce": "CO2"}
    for name in ("w", "we", "wge", "wae", "wce", "wse", "wsge", "wsae",
                 "wsce"):
        e = teos.from_json({"eos": {"name": name}}, th, rp, cp)
        assert e.name == name
        if name in gases:
            assert e.gas.name == gases[name]
    e = teos.from_json({"eos": {"name": "wsge", "gas": "co2"}}, th, rp, cp)
    assert e.gas.name == "CO2"
    with pytest.raises(ValueError, match="unknown EOS"):
        teos.from_json({"eos": {"name": "wx"}}, th, rp, cp)
