"""Configuration handling of waiwera_tpu_torch: every option that an
earlier slice refused (the source network, tracers, rock controls, mesh
files, gmres, lgmres, lu, the nonlinear monitor) builds and matches the
JAX package's, a name neither package knows is an error, and the state
containers match the JAX package's."""

import copy

import numpy as np
import pytest
import torch

from torch_parity import flagship_config, np_


def _sim(cfg, mesh=True):
    from waiwera_tpu_torch.mesh.rect import rectangular_mesh
    from waiwera_tpu_torch.sim.simulation import Simulation

    m = (rectangular_mesh([50.0] * 3, [50.0] * 2, [20.0] * 2,
                          origin=[0.0, 0.0, -40.0]) if mesh else None)
    return Simulation(cfg, mesh=m, device="cpu")


def _with(path, value):
    """The flagship config of a 3 x 2 x 2 box with one entry replaced."""
    cfg = copy.deepcopy(flagship_config(3, 2, 2))
    *keys, last = path
    node = cfg
    for k in keys:
        node = node.setdefault(k, {}) if isinstance(k, str) else node[k]
    node[last] = value
    return cfg


def test_flagship_config_builds():
    sim = _sim(flagship_config(3, 2, 2))
    assert sim.mesh.num_interior_cells == 12
    assert sim.y0.dtype == torch.float64 and sim.region0.dtype == torch.int32


def _jax_sim(cfg):
    from waiwera_tpu.mesh.rect import rectangular_mesh
    from waiwera_tpu.sim.simulation import Simulation

    return Simulation(copy.deepcopy(cfg), mesh=rectangular_mesh(
        [50.0] * 3, [50.0] * 2, [20.0] * 2, origin=[0.0, 0.0, -40.0]))


def _builds_and_matches_jax(cfg):
    """Both packages build the config: the same source flows at the
    initial state over [0, 1e4], groups, tracers (initial and boundary
    values) and rock controls (rock_for)."""
    sj, st = _jax_sim(cfg), _sim(copy.deepcopy(cfg))
    fj, _ = sj.initial_fluid()
    ft, _ = st.initial_fluid()
    qj, hj = sj.sources.flows(fj, 0.0, 1.0e4)
    qt, ht = st.sources.flows(ft, 0.0, 1.0e4)
    np.testing.assert_allclose(np_(qt), np.asarray(qj), rtol=1e-12,
                               atol=1e-15)
    np.testing.assert_allclose(np_(ht), np.asarray(hj), rtol=1e-12)
    assert [g.name for g in st.sources.groups] == [
        g.name for g in sj.sources.groups]
    assert (st.tracers is None) == (sj.tracers is None)
    if st.tracers is not None:
        assert st.tracers.names == sj.tracers.names
        np.testing.assert_array_equal(np_(st.tracer0),
                                      np.asarray(sj.tracer0))
    assert [c[0] for c in st.rock_controls] == [
        c[0] for c in sj.rock_controls]
    for t in (0.0, 2.5e4):
        np.testing.assert_allclose(np_(st.rock_for(t).porosity),
                                   np.asarray(sj.rock_for(t).porosity),
                                   rtol=1e-14)
    return sj, st


# error None: an option that an earlier slice refused and that now builds
# and matches the JAX package
@pytest.mark.parametrize("cfg, error, match", [
    # every EOS, thermodynamics and curve of the JAX package is ported:
    # only a name that neither package knows is an error
    (_with(["eos", "name"], "wxe"), ValueError, "unknown EOS"),
    (_with(["thermodynamics"], "ifc68"), ValueError,
     "unknown thermodynamics"),
    (_with(["rock", "relative_permeability"], {"type": "brooks"}),
     ValueError, "unknown relative permeability"),
    (_with(["rock", "capillary_pressure"], {"type": "leverett"}), ValueError,
     "unknown capillary pressure"),
    (_with(["source", 0, "limiter"], {"total": 5.0}), None, None),
    (_with(["source", 1, "rate"], [[0.0, 1.0], [1e5, 2.0]]), None, None),
    (_with(["tracer"], [{"name": "t"}]), None, None),
    (_with(["rock", "types", 0, "porosity"], [[0.0, 0.1], [1e5, 0.2]]),
     None, None),
    # a restart is read now: a file that is not there is an error of the
    # file, not of the port
    (_with(["initial", "filename"], "no_such_restart.h5"), OSError,
     "no_such_restart.h5"),
    (_with(["source", 0, "separator"], {"pressure": 5.0e5}), None, None),
    (_with(["network"], {"group": [{"name": "g", "in": ["source 0"],
                                    "limiter": {"total": 1e-3}}]}),
     None, None),
    (_with(["boundaries", 0, "tracer"], 1.0), None, None),
], ids=["eos_we", "ifc67", "relperm", "capillarity", "limiter",
        "rate_table", "tracer", "rock_table", "restart", "separator",
        "network", "boundary_tracer"])
def test_config_outside_the_slice_raises(cfg, error, match):
    if error is None:
        _builds_and_matches_jax(cfg)
        return
    with pytest.raises(error, match=match):
        _sim(cfg)


def test_boundary_tracer_values():
    """A boundary's tracer value fills its ghost rows, a list gives one
    value per tracer, and the interior takes initial.tracer."""
    cfg = _with(["boundaries", 0, "tracer"], [1.0e-3, 2.0e-3])
    cfg["tracer"] = [{"name": "a"}, {"name": "b"}]
    cfg["initial"]["tracer"] = [5.0e-4, 0.0]
    _, st = _builds_and_matches_jax(cfg)
    ghost = np_(st.mesh_dev.is_ghost)
    assert ghost.any()
    x = np_(st.tracer0)
    np.testing.assert_array_equal(x[ghost], [[1.0e-3, 2.0e-3]] * ghost.sum())
    np.testing.assert_array_equal(x[~ghost], [[5.0e-4, 0.0]] * (~ghost).sum())


def test_mesh_from_config_raises(tmp_path):
    """A mesh section generates the mesh; a mesh file, gmsh or (by its
    suffix) exodus, is read to the JAX package's mesh; no mesh at all,
    or a mesh type neither package knows, is an error."""
    from chip_smoke import hex_box, write_exodus, write_gmsh
    from waiwera_tpu.sim.simulation import Simulation as JSim

    cfg = flagship_config(3, 2, 2)
    with pytest.raises(ValueError, match="no mesh specified"):
        _sim(cfg, mesh=False)
    verts, conn = hex_box(3, 2, 2, ([50.0] * 3, [50.0] * 2, [20.0] * 2))
    write_gmsh(str(tmp_path / "box.msh"), verts, [("hexahedron", conn)])
    write_exodus(str(tmp_path / "box.exo"), verts, [("hexahedron", conn)])
    for spec in (str(tmp_path / "box.msh"),
                 {"filename": str(tmp_path / "box.exo")}):
        st = _sim(dict(cfg, mesh=spec), mesh=False)
        sj = JSim(copy.deepcopy(dict(cfg, mesh=spec)))
        assert st.mesh.num_interior_cells == 12 and st.mesh.dim == 3
        np.testing.assert_array_equal(st.mesh.face_cells, sj.mesh.face_cells)
        for name in ("cell_volume", "cell_centroid", "face_area",
                     "face_distance", "face_gravity_normal"):
            np.testing.assert_allclose(getattr(st.mesh, name),
                                       getattr(sj.mesh, name), rtol=1e-12,
                                       atol=1e-9, err_msg=name)
        np.testing.assert_array_equal(np_(st.y0), np.asarray(sj.y0))
    with pytest.raises(ValueError, match="cannot build mesh"):
        _sim(dict(cfg, mesh={"type": "voronoi"}), mesh=False)
    sim = _sim(dict(cfg, mesh={"type": "rectangular", "dx": [50.0] * 3,
                               "dy": [50.0] * 2, "dz": [20.0] * 2}),
               mesh=False)
    assert sim.mesh.num_interior_cells == 12 and sim.mesh.dim == 3
    assert sim.tracers is None and sim.rock_controls == []


def _run_one_step(cfg):
    """One step of the config through both packages' Timestepper: the
    port's Timestepper, after checking its state against the JAX
    package's."""
    from waiwera_tpu.sim.timestepper import Timestepper as JTs
    from waiwera_tpu_torch.sim.timestepper import Timestepper

    ts = Timestepper(copy.deepcopy(cfg), _sim(copy.deepcopy(cfg)))
    tj = JTs(copy.deepcopy(cfg), _jax_sim(cfg))
    assert ts.run() and tj.run() and ts.taken == tj.taken == 1
    np.testing.assert_allclose(np_(ts.final_y), np.asarray(tj.final_y),
                               rtol=1e-8, atol=1e-8)
    return ts


# every option here is ported now (gmres, the nonlinear monitor,
# lgmres): one step runs and matches the JAX package
@pytest.mark.parametrize("path, value, check", [
    (["time", "step", "solver", "linear"],
     {"type": "gmres", "options": {"gmres": {"restart": 10}}},
     lambda p: p.linear_method == "gmres" and p.linear_restart == 10),
    (["time", "step", "solver", "nonlinear", "monitor"], True,
     lambda p: p.monitor),
    (["time", "step", "solver", "linear", "type"], "lgmres",
     lambda p: p.linear_method == "lgmres" and p.linear_augment == 2),
], ids=["gmres", "monitor", "lgmres"])
def test_timestepper_options_outside_the_slice_raise(path, value, check,
                                                     capfd):
    cfg = _with(path, value)
    cfg["time"]["step"].update(size=1.0e3, maximum={"number": 1})
    capfd.readouterr()
    ts = _run_one_step(cfg)
    assert check(ts.newton_params)
    assert ts.stats["linear_iterations"] > 0
    monitor = [ln for ln in capfd.readouterr().out.splitlines()
               if ln.startswith("newton it ")]
    # one report before the loop and one per iteration, from each package
    expect = 2 * (1 + ts.stats["newton_iterations"]) if value is True else 0
    assert len(monitor) == expect


@pytest.mark.parametrize("attr", ["tracers", "rock_controls"])
def test_timestepper_refuses_tracers_and_rock_controls(attr):
    """Refused by the slices before the source network; now a simulation
    with tracers (built as the JAX package builds it) gets a tracer step
    function, and one with rock controls runs each try on rock_for's rock
    at the try's end time. The runs themselves are held against the JAX
    package in tests/test_torch_network_run.py and
    tests/test_torch_rock_controls.py."""
    from waiwera_tpu_torch.sim.timestepper import Timestepper

    cfg = (_with(["tracer"], [{"name": "t"}]) if attr == "tracers" else
           _with(["rock", "types", 0, "porosity"], [[0.0, 0.1], [1e5, 0.2]]))
    cfg["time"] = {"step": {"size": 1.0e3, "maximum": {"number": 1}}}
    sj, sim = _builds_and_matches_jax(cfg)
    seen = []
    plain = sim.rock_for
    sim.rock_for = lambda t: seen.append(t) or plain(t)
    ts = Timestepper(copy.deepcopy(cfg), sim)
    assert (ts.tracer_step_fn is not None) == (attr == "tracers")
    assert ts.run() and ts.taken == 1
    if attr == "tracers":
        assert ts.final_tracer.shape == (sim.mesh.num_cells, 1)
        assert ts.stats["tracer_converged"] == [True]
        assert seen == []
    else:
        assert seen == [1.0e3]


def test_timestepper_reads_the_solver_section():
    """Every key of time.step.solver arrives in NewtonParams, the
    monitor included; lgmres's augmentation and bcgsl's degree keep
    their PETSc defaults, which the schema does not set."""
    from waiwera_tpu_torch.sim.timestepper import Timestepper

    cfg = _with(["time", "step", "solver"], {
        "nonlinear": {"maximum": {"iterations": 6}, "monitor": True,
                      "minimum": {"iterations": 2},
                      "tolerance": {"function": {"relative": 1e-6,
                                                 "absolute": 2.0},
                                    "update": {"relative": 1e-9,
                                               "absolute": 3.0}}},
        "linear": {"type": "bcgs", "preconditioner": {"type": "ilu"},
                   "tolerance": {"relative": 1e-7},
                   "maximum": {"iterations": 77},
                   "options": {"gmres": {"restart": 12}},
                   "dtype": "float32", "jacobian_dtype": "float32"},
    })
    p = Timestepper(cfg, _sim(cfg)).newton_params
    assert (p.max_iterations, p.min_iterations) == (6, 2)
    assert (p.function_rtol, p.function_atol) == (1e-6, 2.0)
    assert (p.update_rtol, p.update_atol) == (1e-9, 3.0)
    assert (p.linear_method, p.linear_pc) == ("bcgs", "ilu")
    assert (p.linear_rtol, p.linear_max_iterations) == (1e-7, 77)
    assert p.linear_restart == 12
    assert (p.linear_augment, p.linear_ell, p.monitor) == (2, 2, True)
    assert (p.linear_dtype, p.jacobian_dtype) == ("float32", "float32")


def test_solver_options_outside_the_slice_raise():
    from waiwera_tpu_torch.solver import krylov

    sim = _sim(flagship_config(3, 2, 2))
    # gmres is ported: the identity solves in one cycle
    b = torch.ones(4, 3, dtype=torch.float64)
    res = krylov.solve("gmres", lambda v: v, b)
    assert res.converged and torch.equal(res.x, b)
    # lgmres is ported: the identity solves in one cycle too
    res = krylov.solve("lgmres", lambda v: v, b)
    assert res.converged and torch.equal(res.x, b) and res.iterations == 1
    with pytest.raises(ValueError, match="unknown linear solver"):
        krylov.solve("sor", lambda v: v, torch.ones(4, 3))
    # lu is ported: beside the band SpMV of this box, the dense LU of the
    # initial Jacobian, applied as the JAX package applies it
    import jax.numpy as jnp
    from torch_parity import torch_coeffs

    sj = _jax_sim(flagship_config(3, 2, 2))
    ct, _ = torch_coeffs(sim, 1.0e4)
    parts = sim.system.jacobian_parts(sim.y0, sim.region0, sim.rock, ct,
                                      0.0, 1.0e4)
    pj = tuple(jnp.asarray(np_(p)) for p in parts)
    assert sim.system.dia is not None
    mv, pc = sim.system.linear_operator_from_parts(parts, "lu")
    mvj, pcj = sj.system.linear_operator_from_parts(pj, "lu")
    r = np.random.default_rng(3).standard_normal(tuple(sim.y0.shape))
    want = np.asarray(pcj(jnp.asarray(r)))
    # the same matrix in both packages, but its condition number is ~2e9:
    # two LAPACK factorisations agree to ~cond x eps of the largest entry
    np.testing.assert_allclose(np_(pc(torch.as_tensor(r))), want,
                               rtol=1e-10, atol=1e-8 * np.abs(want).max())
    np.testing.assert_allclose(np_(mv(torch.as_tensor(want))), r, rtol=1e-8,
                               atol=1e-8 * np.abs(r).max())


@pytest.mark.parametrize("method, first", [
    ("beuler", 1.0), ("beuler", 0.0), ("bdf2", 1.0), ("bdf2", 0.0),
    ("directss", 0.0),
], ids=["beuler_first", "beuler", "bdf2_first", "bdf2", "directss"])
def test_method_coeffs_match_jax(method, first):
    """The residual coefficients of every method, on random balances:
    equal to the JAX package's to the last bit but one (the same f64
    operations in the same order)."""
    import jax.numpy as jnp
    from waiwera_tpu.solver.system import method_coeffs as jcoeffs
    from waiwera_tpu_torch.solver.system import method_coeffs as tcoeffs

    rng = np.random.default_rng(7)
    lhs, lhs2 = rng.standard_normal((2, 9, 3)) * 1e3
    dt, dt_last = 1234.5, 777.25
    cj = jcoeffs(method, jnp.asarray(dt), jnp.asarray(dt_last),
                 jnp.asarray(first), jnp.asarray(lhs), jnp.asarray(lhs2))
    ct = tcoeffs(method, dt, dt_last, first, torch.as_tensor(lhs),
                 torch.as_tensor(lhs2))
    assert ct.c_lhs == float(cj.c_lhs) and ct.dt_eff == float(cj.dt_eff)
    np.testing.assert_allclose(np_(ct.const), np.asarray(cj.const),
                               rtol=4e-16, atol=0.0)


def test_empty_fluid_matches_jax():
    from waiwera_tpu.physics.state import empty_fluid as jempty
    from waiwera_tpu_torch.physics.state import empty_fluid as tempty

    fj, ft = jempty(7, 2, 2), tempty(7, 2, 2)
    for name in fj._fields:
        a, b = np.asarray(getattr(fj, name)), np_(getattr(ft, name))
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(b, a, err_msg=name)
