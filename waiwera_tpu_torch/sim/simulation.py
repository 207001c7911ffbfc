"""Flow simulation: couples mesh, EOS, rocks, sources and boundary
conditions into a one-timestep-try function (counterpart of
waiwera_tpu/sim/simulation.py).

Ported subset of the JSON schema (doc/user/setup_*.rst): thermodynamics
"iapws" and "ifc67"; every eos of the JAX package ("w", "we" by default,
"wge"/"wae"/"wce", "wse", "wsge"/"wsae"/"wsce", the gases air and CO2,
the salt EOS's permeability modifiers); every relative-permeability and
capillarity type of the rock section; mesh zones (cell arrays, boxes,
combinations) and MINC; rock types assigned to listed cells, to zones or
to all cells, and MINC fracture/matrix rock types, with permeability and
porosity tables against time (rock controls, rock_for); constant or
per-cell initial primaries, regions and tracers, or a restart from an
HDF5 output file; Dirichlet boundaries with boundary tracer values; the
source network of sim/network.py (controls, separators, limiters,
groups, reinjectors); passive tracers (sim/tracer.py). The mesh is
passed in, read from a gmsh or ExodusII file (mesh.filename), or
generated from the config ("type": "rectangular" or "column"). The
config is read in the JAX package's order, so
that a tracked config (utils/config.py) logs the same defaults.

The simulation runs on the CUDA device unless the caller names another
device; without a CUDA device, Simulation(...) with no device raises.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from waiwera_tpu_torch import eos as eos_mod
from waiwera_tpu_torch import thermo as thermo_mod
from waiwera_tpu_torch.mesh.core import Mesh, add_boundaries, set_gravity
from waiwera_tpu_torch.mesh.device import fluxes_to_host_order, mesh_arrays
from waiwera_tpu_torch.mesh.minc import apply_minc, parse_minc
from waiwera_tpu_torch.physics import capillarity as cp_mod
from waiwera_tpu_torch.physics import relperm as relperm_mod
from waiwera_tpu_torch.physics.state import (
    DEFAULT_HEAT_CONDUCTIVITY,
    DEFAULT_PERMEABILITY,
    DEFAULT_POROSITY,
    DEFAULT_ROCK_DENSITY,
    DEFAULT_SPECIFIC_HEAT,
    FluidState,
    RockState,
)
from waiwera_tpu_torch.sim.network import SourceNetwork
from waiwera_tpu_torch.solver.newton import (
    NewtonParams,
    newton_solve,
    program_covers,
)
from waiwera_tpu_torch.solver.system import (
    System,
    method_coeffs,
    time_tensor,
)
from waiwera_tpu_torch.utils import hdf5
from waiwera_tpu_torch.utils.interpolation import InterpolationTable


def resolve_device(device=None) -> torch.device:
    """The device a simulation runs on: `device` if given, else the
    current CUDA device; without a CUDA device that is an error, not a
    silent fall-back to the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device (torch.cuda.is_available() is false); pass "
            "device='cpu' to run on the CPU"
        )
    return torch.device("cuda", torch.cuda.current_device())


class Simulation:
    def __init__(self, config: dict, mesh: Optional[Mesh] = None,
                 device=None):
        self.config = config
        self.device = resolve_device(device)
        # run covered configurations eagerly on the card too (comparisons)
        self._eager_step = False
        self.title = config.get("title", "")

        thermo_name = config.get("thermodynamics", "iapws")
        if isinstance(thermo_name, dict):
            thermo_name = thermo_name.get("name", "iapws")
        self.thermo = thermo_mod.from_name(thermo_name)
        rock_cfg = config.get("rock", {}) or {}
        self.relative_permeability = relperm_mod.from_json(
            rock_cfg.get("relative_permeability")
        )
        self.capillary_pressure = cp_mod.from_json(
            rock_cfg.get("capillary_pressure")
        )
        self.eos = eos_mod.from_json(
            config, self.thermo, self.relative_permeability,
            self.capillary_pressure,
        )
        npv = self.eos.num_primary_variables

        mesh_given = mesh is not None
        if mesh is None:
            mesh = self._mesh_from_config(config, self.device)
        self.mesh = mesh
        # gravity (flow_simulation.F90:782-847): a scalar g is -g in the
        # last mesh dimension; missing or null is 0 for 2-D meshes and
        # (0, 0, -9.8) for 3-D. An explicitly passed mesh keeps its
        # gravity unless the config sets one.
        if (not mesh_given) or ("gravity" in config):
            set_gravity(mesh, self._resolve_gravity(config, mesh.dim))
        self.zones = self._setup_zones(config, mesh)
        # MINC appends matrix cells; it must precede the boundaries
        mesh_cfg = config.get("mesh")
        minc_cfg = mesh_cfg.get("minc") if isinstance(mesh_cfg, dict) else None
        self.minc_zones = []
        if minc_cfg:
            self.minc_zones = parse_minc(minc_cfg, self.zones)
            apply_minc(mesh, self.minc_zones)
        add_boundaries(mesh, config.get("boundaries", []) or [], npv)
        self.mesh_dev = mesh_arrays(mesh, self.device)
        self.rock = self._setup_rock(rock_cfg, mesh)

        # tracers (tracer.F90 setup_tracers)
        tracer_cfg = config.get("tracer")
        if tracer_cfg:
            from waiwera_tpu_torch.sim.tracer import TracerSet

            self.tracers = TracerSet(tracer_cfg, self.eos)
        else:
            self.tracers = None

        src_cfg = config.get("source", []) or []
        if isinstance(src_cfg, dict):
            src_cfg = [src_cfg]
        self.sources = (
            SourceNetwork(
                src_cfg, config.get("network", {}) or {}, mesh, self.eos,
                self.thermo,
                tracer_names=self.tracers.names if self.tracers else (),
                device=self.device, zones=self.zones,
            )
            if src_cfg
            else None
        )
        self.system = System(self.eos, self.mesh_dev, self.sources)
        self.y0, self.region0 = self._setup_initial(config, mesh)
        if self.tracers is not None:
            self.tracer0 = self._setup_initial_tracer(config, mesh)
        if self.sources is not None:
            fluid0, _ = self.initial_fluid()
            self.sources.finalize(fluid0)

    # ------------------------------------------------------------------

    @staticmethod
    def _mesh_from_config(config, device=None) -> Mesh:
        """The mesh of config["mesh"]: a file name (ExodusII by its
        suffix .exo, .e, .ex2 or .g, gmsh otherwise, with radial and
        thickness), or generated: "type": "column" (dz, area) or
        "rectangular" (dx, dy, dz, radial, thickness). Gravity is set by
        the caller, once the dimension is known. A file's geometry is
        computed on `device` where it is a CUDA device (mesh/geometry.py),
        with numpy on the host otherwise."""
        if device is not None and torch.device(device).type != "cuda":
            device = None
        mesh_cfg = config.get("mesh")
        if mesh_cfg is None:
            raise ValueError("no mesh specified")
        if isinstance(mesh_cfg, str):
            mesh_cfg = {"filename": mesh_cfg}
        radial = bool(mesh_cfg.get("radial", False))
        thickness = float(mesh_cfg.get("thickness", 1.0))
        if "filename" in mesh_cfg:
            fname = mesh_cfg["filename"]
            if fname.lower().endswith((".exo", ".e", ".ex2", ".g")):
                from waiwera_tpu_torch.mesh.exodus import read_exodus

                return read_exodus(fname, radial=radial, thickness=thickness,
                                   device=device)
            from waiwera_tpu_torch.mesh.gmsh import read_gmsh

            return read_gmsh(fname, radial=radial, thickness=thickness,
                             device=device)
        if mesh_cfg.get("type") == "column":
            from waiwera_tpu_torch.mesh.rect import column_mesh

            return column_mesh(mesh_cfg["dz"],
                               area=mesh_cfg.get("area", 1.0))
        if mesh_cfg.get("type") == "rectangular":
            from waiwera_tpu_torch.mesh.rect import rectangular_mesh

            return rectangular_mesh(
                mesh_cfg.get("dx"), mesh_cfg.get("dy"), mesh_cfg.get("dz"),
                radial=radial, thickness=thickness,
            )
        raise ValueError(f"cannot build mesh from: {mesh_cfg!r}")

    @staticmethod
    def _resolve_gravity(config, dim: int):
        """Gravity vector: a vector as given; a scalar magnitude, or the
        default (9.8 m/s2 in 3-D, 0 in 2-D), down the last mesh
        dimension."""
        g = config.get("gravity", None)
        out = np.zeros(3)
        if g is None:
            out[dim - 1] = -(0.0 if dim == 2 else 9.8)
        elif isinstance(g, (int, float)):
            out[dim - 1] = -float(g)
        else:
            arr = np.asarray(g, dtype=np.float64)
            out[: len(arr)] = arr
        return out

    @staticmethod
    def _setup_zones(config, mesh: Mesh) -> dict:
        """Zone name -> interior cell indices (zone.F90:37-80: cell
        arrays, coordinate boxes, combinations of other zones)."""
        mesh_cfg = config.get("mesh")
        zcfg = (mesh_cfg.get("zones", {}) if isinstance(mesh_cfg, dict)
                else {}) or {}
        n = mesh.num_interior_cells
        centroid = mesh.cell_centroid[:n]
        zones = {}
        pending = dict(zcfg)
        while pending:
            progressed = False
            for name, spec in list(pending.items()):
                if not isinstance(spec, dict):
                    spec = {"cells": spec}
                ztype = spec.get("type")
                if ztype is None:
                    ztype = ("array" if "cells" in spec else
                             "combine" if ("+" in spec or "-" in spec)
                             else "box")
                if ztype == "array":
                    cells = np.asarray(spec.get("cells", []), np.int64)
                elif ztype == "combine":
                    def names_of(v):
                        return [] if v is None else [
                            z for z in np.atleast_1d(v) if z is not None]

                    plus = names_of(spec.get("+"))
                    minus = names_of(spec.get("-"))
                    if not all(z in zones for z in plus + minus):
                        continue
                    # '-' only starts from every cell (zone.F90 combine)
                    sel = np.zeros(n, bool) if (plus or "+" in spec) \
                        else np.ones(n, bool)
                    for z in plus:
                        sel[zones[z]] = True
                    for z in minus:
                        sel[zones[z]] = False
                    cells = np.flatnonzero(sel)
                else:  # box
                    sel = np.ones(n, bool)
                    for k, ax in enumerate("xyz"[: mesh.dim]):
                        if spec.get(ax) is not None:
                            lo, hi = spec[ax]
                            sel &= (centroid[:, k] >= lo) & (
                                centroid[:, k] <= hi)
                    cells = np.flatnonzero(sel)
                zones[name] = cells
                del pending[name]
                progressed = True
            if not progressed:
                raise ValueError("cyclic or undefined zone references")
        return zones

    def _zone_cells(self, names) -> np.ndarray:
        sel = np.zeros(self.mesh.num_interior_cells, bool)
        for nm in np.atleast_1d(names):
            if nm not in self.zones:
                raise ValueError(f"unknown zone {nm!r}")
            sel[self.zones[nm]] = True
        return np.flatnonzero(sel)

    def _f64(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.float64), device=self.device)

    @staticmethod
    def _is_table_spec(v) -> bool:
        """A rank-2 "permeability" or "porosity" is a table of values
        against time driving a rock control (rock_setup.F90:304-312)."""
        if not isinstance(v, (list, tuple, np.ndarray)):
            return False
        a = np.asarray(v, dtype=object)
        return a.ndim >= 2 or (
            len(v) > 0 and isinstance(v[0], (list, tuple, np.ndarray))
        )

    def _setup_rock(self, rock_cfg, mesh: Mesh) -> RockState:
        n = mesh.num_cells
        perm = np.full((n, 3), DEFAULT_PERMEABILITY)
        wetk = np.full(n, DEFAULT_HEAT_CONDUCTIVITY)
        dryk = np.full(n, DEFAULT_HEAT_CONDUCTIVITY)
        poro = np.full(n, DEFAULT_POROSITY)
        dens = np.full(n, DEFAULT_ROCK_DENSITY)
        sph = np.full(n, DEFAULT_SPECIFIC_HEAT)
        # time-dependent rock property controls (kind, cells, table)
        # (flow_simulation.F90:62,2050-2094, rock_control.F90)
        self.rock_controls = []
        for rt in rock_cfg.get("types", []) or []:
            if "zones" in rt:
                cells = self._zone_cells(rt["zones"])
            elif "cells" in rt:
                cells = np.asarray(rt["cells"], dtype=np.int64)
            else:
                cells = np.arange(mesh.num_interior_cells)
            interp = str(rt.get("interpolation", "linear")).lower()
            k_spec = rt.get("permeability", DEFAULT_PERMEABILITY)
            if self._is_table_spec(k_spec):
                self.rock_controls.append((
                    "permeability", np.asarray(cells, np.int64),
                    InterpolationTable(k_spec, interpolation=interp)))
                k_spec = DEFAULT_PERMEABILITY
            k = np.atleast_1d(np.asarray(k_spec, dtype=np.float64))
            if len(k) < 3:
                k = np.concatenate([k, np.full(3 - len(k), k[-1])])
            perm[cells] = k
            p_spec = rt.get("porosity", DEFAULT_POROSITY)
            if self._is_table_spec(p_spec):
                self.rock_controls.append((
                    "porosity", np.asarray(cells, np.int64),
                    InterpolationTable(p_spec, interpolation=interp)))
            else:
                poro[cells] = p_spec
            wetk[cells] = rt.get("wet_conductivity", DEFAULT_HEAT_CONDUCTIVITY)
            dryk[cells] = rt.get("dry_conductivity", DEFAULT_HEAT_CONDUCTIVITY)
            dens[cells] = rt.get("density", DEFAULT_ROCK_DENSITY)
            sph[cells] = rt.get("specific_heat", DEFAULT_SPECIFIC_HEAT)
        # MINC fracture and matrix rock types by name
        by_name = {rt.get("name", ""): rt
                   for rt in rock_cfg.get("types", []) or []}
        for cells, name in getattr(mesh, "minc_rock", []):
            rt = by_name.get(name)
            if rt is None:
                raise ValueError(f"unknown MINC rock type {name!r}")
            k = np.atleast_1d(np.asarray(
                rt.get("permeability", DEFAULT_PERMEABILITY), np.float64))
            if len(k) < 3:
                k = np.concatenate([k, np.full(3 - len(k), k[-1])])
            perm[cells] = k
            wetk[cells] = rt.get("wet_conductivity", DEFAULT_HEAT_CONDUCTIVITY)
            dryk[cells] = rt.get("dry_conductivity", DEFAULT_HEAT_CONDUCTIVITY)
            poro[cells] = rt.get("porosity", DEFAULT_POROSITY)
            dens[cells] = rt.get("density", DEFAULT_ROCK_DENSITY)
            sph[cells] = rt.get("specific_heat", DEFAULT_SPECIFIC_HEAT)
        # ghost cells take the attached interior cell's rock, so that
        # harmonic face averages see interior properties
        ghosts, interiors = [], []
        for b in mesh.boundaries:
            interior = mesh.face_cells[b.faces, 0]
            for a in (perm, wetk, dryk, poro, dens, sph):
                a[b.cells] = a[interior]
            ghosts.append(np.asarray(b.cells, np.int64))
            interiors.append(np.asarray(interior, np.int64))
        self._rock_ghost_map = tuple(
            torch.as_tensor(np.concatenate(a) if a else np.zeros(0, np.int64),
                            device=self.device)
            for a in (ghosts, interiors))
        self._rock_controls_dev = [
            (kind, torch.as_tensor(cells, device=self.device), table)
            for kind, cells, table in self.rock_controls
        ]
        return RockState(
            permeability=self._f64(perm),
            wet_conductivity=self._f64(wetk),
            dry_conductivity=self._f64(dryk),
            porosity=self._f64(poro),
            density=self._f64(dens),
            specific_heat=self._f64(sph),
        )

    def rock_for(self, t: float) -> RockState:
        """Rock properties at time t with the table-driven rock controls
        applied (the pre-try-timestep hook, flow_simulation.F90:2050-2094):
        new tensors on the simulation's device, the ghost cells following
        their interior cells; self.rock itself where there are no
        controls."""
        if not self.rock_controls:
            return self.rock
        perm = self.rock.permeability.clone()
        poro = self.rock.porosity.clone()
        t_dev = poro.new_full((), float(t))
        for kind, cells, table in self._rock_controls_dev:
            val = table(t_dev)  # [dim]
            if kind == "permeability":
                if val.shape[0] < 3:
                    val = torch.cat([val, val[-1:].expand(3 - val.shape[0])])
                perm[cells] = val
            else:
                poro[cells] = val[0]
        g, i = self._rock_ghost_map
        perm[g] = perm[i]
        poro[g] = poro[i]
        return self.rock._replace(permeability=perm, porosity=poro)

    def _setup_initial(self, config, mesh: Mesh):
        """Initial scaled primaries and regions (initial.F90: constant
        or per-cell arrays, or a restart from an HDF5 output file) with
        boundary values in the ghost rows."""
        n = mesh.num_cells
        ic = config.get("initial", {}) or {}
        primary = np.tile(self.eos.default_primary, (n, 1))
        region = np.full(n, self.eos.default_region, dtype=np.int32)
        if "filename" in ic and ic["filename"]:
            p, r = self._initial_from_file(ic)
            primary[: len(p)] = p
            region[: len(r)] = r
        if "primary" in ic:
            p = np.asarray(ic["primary"], dtype=np.float64)
            if p.ndim == 1:
                primary[: mesh.num_interior_cells] = p
            else:
                primary[: len(p)] = p
        if "region" in ic:
            r = np.asarray(ic["region"], dtype=np.int32)
            if r.ndim == 0:
                region[: mesh.num_interior_cells] = r
            else:
                region[: len(r)] = r
        # MINC matrix cells inherit their fracture cell's initial state
        # (initial.F90:976+)
        lvl = getattr(mesh, "minc_level", None)
        if lvl is not None and (lvl > 0).any():
            matrix = np.flatnonzero(lvl > 0)
            parent = mesh.minc_parent[matrix]
            primary[matrix] = primary[parent]
            region[matrix] = region[parent]
        for b in mesh.boundaries:
            primary[b.cells] = b.primary
            region[b.cells] = b.region
        region_t = torch.as_tensor(region, device=self.device)
        return self.eos.scale(self._f64(primary), region_t), region_t

    def _initial_from_file(self, ic):
        """Restart from an HDF5 output file (initial.F90:421-679): the
        EOS's required output fluid fields at the given time index
        (default -1, the last), put into natural cell order through the
        file's cell_index. The fluid state is a pure function of
        (primary, region), so this 'minimal' restart continues the run
        exactly. Read through utils/hdf5.py (no h5py)."""
        index = ic.get("index", -1)
        index = -1 if index is None else int(index)
        with hdf5.File(ic["filename"], "r") as f:
            cf = f["cell_fields"]
            order = np.asarray(f["cell_index"][:, 0], np.int64)
            inv = np.argsort(order)
            fields = {}
            for name in self.eos.required_output_fluid_fields:
                ds = f"fluid_{name}" if f"fluid_{name}" in cf else name
                fields[name] = np.asarray(cf[ds][index])[inv]
            self._restart_tracer_fields = {}
            if self.tracers is not None:
                for nm in self.tracers.names:
                    ds = f"tracer_{nm}"
                    if ds in cf:
                        self._restart_tracer_fields[nm] = np.asarray(
                            cf[ds][index])[inv]
        return self.eos.primary_from_output_fields(fields)

    def _setup_initial_tracer(self, config, mesh: Mesh) -> torch.Tensor:
        """[N, nt] initial tracer mass fractions (initial.tracer: one
        value, one per tracer or per cell; a restart file's tracer
        fields), with the boundary values in the ghost rows."""
        nt = self.tracers.num_tracers
        ni = mesh.num_interior_cells
        x = np.zeros((mesh.num_cells, nt))
        ic = config.get("initial", {}) or {}
        tr = ic.get("tracer")
        if tr is not None:
            arr = np.asarray(tr, dtype=np.float64)
            if arr.ndim == 0:
                x[:ni] = float(arr)
            elif arr.ndim == 1 and arr.shape[0] == nt:
                x[:ni] = arr
            else:
                x[:ni] = arr.reshape(ni, -1)
        for nm, vals in getattr(self, "_restart_tracer_fields", {}).items():
            x[:ni, self.tracers.names.index(nm)] = vals
        for b in mesh.boundaries:
            if b.tracer is not None:
                bt = b.tracer
                if bt.shape[0] != nt:
                    bt = np.full(nt, bt[0])
                x[b.cells] = bt
        return self._f64(x)

    # ------------------------------------------------------------------

    def initial_fluid(self):
        """Fluid state at the initial solution (fluid_init,
        flow_simulation.F90:2171)."""
        return self.eos.properties(
            self.eos.unscale(self.y0, self.region0), self.region0, self.rock
        )

    def make_step_fn(self, newton_params: NewtonParams,
                     method: str = "beuler", eager: Optional[bool] = None):
        """The one-timestep-try function.

        step(y, region, temperature, lhs_last, lhs_last2, t_last, dt,
        dt_last, first, rock_in=None, fluid_last=None, fluxes_last=None)
        returns (NewtonResult without its carried state, fluid, lhs,
        fluxes) at the final iterate. Times may be Python floats or 0-d
        tensors. fluid_last/fluxes_last: the previous accepted step's
        fluid state and face fluxes at (y, region), which let the
        initial residual skip the f64 EOS chain (not used when rock_in
        replaces the rock). On the card a configuration that
        step_program_mode covers runs as replayed CUDA graphs; eager
        (default: this simulation's _eager_step, false) runs it eagerly,
        the counterpart of jax.disable_jit for comparisons."""
        if eager is None:
            eager = self._eager_step
        return step_function(self.system, self.rock, newton_params, method,
                             eager=eager)

    def make_tracer_step_fn(self):
        """The auxiliary tracer solve of one accepted try
        (timestepper.F90:458-557 linear set-up, aux solve :2347-2356).

        tracer_step(fluid, fluxes, x_last, al_last, x_last2, al_last2,
        t0, t1, dt, dt_last, first, use_bdf2) -> tracer.TracerResult;
        times are Python numbers or 0-d tensors. The tracer solve sees
        the static rock, as in the JAX package. On the card it runs as
        replayed CUDA graphs (tracer_program_mode) unless this
        simulation's _eager_step is set."""
        network = self.sources
        if network is not None and network.num_sources == 0:
            network = None
        return tracer_step_function(
            self.tracers, self.mesh_dev, self.rock, network,
            self.eos.num_primary_variables, self.tracer0,
            system=self.system, eager=self._eager_step)

    def initial_tracer_state(self):
        """(x0, al0): the initial tracers and their balance coefficients
        at the initial fluid state."""
        from waiwera_tpu_torch.sim import tracer as tracer_mod

        fluid0, _ = self.initial_fluid()
        return self.tracer0, tracer_mod.balance_coefs(self.tracers, fluid0,
                                                      self.rock)

    def lhs_at(self, y, region):
        fluid, _, err = self.system.derived_state(y, region, self.rock)
        return self.system.lhs(fluid, self.rock), fluid, err

    def initial_fluxes(self, y, region):
        """Face fluxes in canonical face order at a state: seeds the
        carried-state path of the step function."""
        fluid, cond, _ = self.system.derived_state(y, region, self.rock)
        return self.system.fluxes(fluid, cond, self.rock)


    def fluxes_at(self, y, region) -> np.ndarray:
        """[F, nflux] face fluxes at a state, on the host in the host
        mesh's face order (for the initial flux output)."""
        return self.flux_to_global(self.initial_fluxes(y, region))

    def flux_to_global(self, fluxes) -> np.ndarray:
        """Canonical (band-sorted) face order -> the host mesh's face
        order and orientation, for /face_fields output."""
        return fluxes_to_host_order(self.mesh_dev, fluxes)

    def dof_statistics(self) -> dict:
        """DOF totals and per-device imbalance (Kumar et al. 1994,
        flow_simulation.F90:2998-3019). One device: no imbalance."""
        dof = (int(self.mesh.num_interior_cells)
               * self.eos.num_primary_variables)
        return {"total": dof, "min": dof, "max": dof, "imbalance": 0.0}


def step_program_mode(system: System, newton_params: NewtonParams) -> str:
    """"graph" where a try runs as replayed CUDA graphs, else "eager",
    from the configuration alone: a CUDA device, a one-rank System, any
    route (band, hybrid or ELL), a linear method of
    newton.GRAPH_METHODS (bcgs, gmres, lgmres, bcgsl) and a
    preconditioner of newton.GRAPH_PCS (every one the port takes: none,
    jacobi, bjacobi, asm, ilu, dilu, sgs, line, cpr, lu)
    (newton.program_covers). A distributed System (ranks) stays
    eager."""
    covered = (system.mesh.is_ghost.device.type == "cuda"
               and program_covers(system, newton_params))
    return "graph" if covered else "eager"


def tracer_program_mode(system: System) -> str:
    """"graph" where the tracer step runs as replayed CUDA graphs (a CUDA
    device and a one-rank System), else "eager"."""
    covered = (system.mesh.is_ghost.device.type == "cuda"
               and not system.distributed)
    return "graph" if covered else "eager"


def system_graphs(system: System):
    """The System's CUDA graph backend: one memory pool per System, which
    its step and tracer programs share."""
    from waiwera_tpu_torch.solver.program import CudaGraphs

    graphs = system.__dict__.get("_graphs")
    if graphs is None:
        graphs = system._graphs = CudaGraphs(system.mesh.is_ghost.device)
    return graphs


def _program_stats(prog) -> dict:
    return {"graph_captures": prog.captures,
            "graph_capture_seconds": prog.capture_seconds,
            "graph_replays": prog.replays}


def step_function(system: System, rock: RockState,
                  newton_params: NewtonParams, method: str,
                  eager: bool = False):
    """The one-timestep-try function of Simulation.make_step_fn over
    `system` (a System, or a rank's LocalSystem) with default rock
    `rock`. It runs as CUDA graphs where step_program_mode says so and
    `eager` is false: the graphs are captured at the first try and kept
    on the System, keyed by the Newton parameters, the method, which of
    the carried state and the rock the try is given and krylov.CHUNK,
    in one memory pool per System. `step.program_mode` says which; `step.stats()`
    counts its captures, their seconds and its replays."""
    from waiwera_tpu_torch.solver import krylov
    from waiwera_tpu_torch.solver.program import Program

    device = system.mesh.is_ghost.device
    mode = "eager" if eager else step_program_mode(system, newton_params)
    programs = system.__dict__.setdefault("_step_programs", {})
    totals = {"graph_captures": 0, "graph_capture_seconds": 0.0,
              "graph_replays": 0}

    def program_for(variant):
        if mode == "eager":
            return Program()
        key = (newton_params, method, variant, krylov.CHUNK)
        prog = programs.get(key)
        if prog is None:
            prog = programs[key] = Program(system_graphs(system))
        return prog

    def step(y, region, temperature, lhs_last, lhs_last2, t_last, dt,
             dt_last, first, rock_in=None, fluid_last=None,
             fluxes_last=None):
        # times as 0-d f64 tensors on the device: a try's values reach
        # the graphs through their staged buffers
        t0 = time_tensor(t_last, device)
        dt = time_tensor(dt, device)
        initial = None
        if rock_in is None and fluid_last is not None \
                and fluxes_last is not None:
            initial = (fluid_last, lhs_last, fluxes_last)
        coeffs = method_coeffs(method, dt, dt_last, first, lhs_last,
                               lhs_last2)
        prog = program_for((rock_in is None, initial is None))
        before = _program_stats(prog)
        y, region, temperature, rock_t, lhs_last, coeffs, t0, t1, initial = \
            prog.stage("try", (
                y, region, temperature, rock if rock_in is None else rock_in,
                lhs_last, coeffs, t0, t0 + dt, initial))
        res = newton_solve(
            system, y, region, temperature, rock_t, coeffs, t0, t1,
            lhs_scale=lhs_last, params=newton_params, initial=initial,
            program=prog,
        )
        for k, v in _program_stats(prog).items():
            totals[k] += v - before[k]
        fluid, lhs_new, fluxes = res.fluid, res.lhs, res.fluxes
        res = res._replace(fluid=None, lhs=None, fluxes=None)
        return res, fluid, lhs_new, fluxes

    def stats() -> dict:
        """This step function's graph captures, their seconds and its
        replays so far."""
        return dict(totals)

    step.program_mode = mode
    step.stats = stats
    return step


def tracer_step_function(tracers, mesh, rock, network, npv: int,
                         ghost_value, system: Optional[System] = None,
                         eager: bool = False, **hooks):
    """The tracer step of Simulation.make_tracer_step_fn over `mesh`
    (a simulation's, or a rank's local mesh) with `network` (or None)
    and Dirichlet values ghost_value; hooks (owned, sync, reduce_sum)
    go to tracer.operator and the GMRES solve.

    tracer_step(fluid, fluxes, x_last, al_last, x_last2, al_last2, t0,
    t1, dt, dt_last, first, use_bdf2) -> tracer.TracerResult. The times
    and `first` may be Python numbers or 0-d tensors: they reach the
    pieces as 0-d f64 tensors staged by the program, the backward-Euler
    or BDF2 coefficients are chosen by torch.where on `first`, and
    use_bdf2 is a constant of the run. The balance coefficients at the
    new fluid state are the first piece; the network's flows, the
    operator and the GMRES start the solve's first piece, each restart
    cycle a piece (krylov.gmres_solve); the ranks' halo exchange of the
    solution the last. On the card, with `system` given
    (a one-rank System, tracer_program_mode) and eager false, the pieces
    are captured as CUDA graphs at the first step and replayed, in the
    System's graph pool, one program per use_bdf2; `tracer_step.
    program_mode` says which and `tracer_step.stats()` counts captures,
    their seconds and replays."""
    from waiwera_tpu_torch.sim import tracer as tracer_mod
    from waiwera_tpu_torch.solver import krylov
    from waiwera_tpu_torch.solver.program import Program

    device = ghost_value.device
    pidx = torch.as_tensor(tracers.phase_index, device=device)
    mode = ("eager" if eager or system is None
            else tracer_program_mode(system))
    programs = ({} if system is None
                else system.__dict__.setdefault("_tracer_programs", {}))
    totals = {"graph_captures": 0, "graph_capture_seconds": 0.0,
              "graph_replays": 0}
    basis_dtype = tracer_mod.gmres_basis_dtype(ghost_value.numel(),
                                               ghost_value.element_size())
    sync = hooks.get("sync")
    solve_kw = {k: hooks[k] for k in ("reduce_sum",) if k in hooks}
    op_kw = {k: hooks[k] for k in ("owned", "sync") if k in hooks}

    def program_for(use_bdf2):
        if mode == "eager":
            return Program()
        prog = programs.get(use_bdf2)
        if prog is None:
            prog = programs[use_bdf2] = Program(system_graphs(system))
        return prog

    def balance(fluid):
        return tracer_mod.balance_coefs(tracers, fluid, rock)

    def setup(fluid, fluxes, x_last, al_last, x_last2, al_last2, t0, t1,
              dt, dt_last, first, al, use_bdf2):
        rate = arrays = frac = inj = None
        if network is not None:
            rate, _ = network.flows(fluid, t0, t1)
            arrays = network.arrays
            frac = fluid.phase_flow_fractions()[arrays.cell][:, pidx]
            inj = network.tracer_injection(t0, t1, like=rate)
        c_al, dt_eff, b_hist = torch.ones_like(dt), dt, al_last * x_last
        if use_bdf2:
            r = dt / dt_last
            be = first > 0.5
            c_al = torch.where(be, c_al, 1.0 + 2.0 * r)
            dt_eff = torch.where(be, dt, dt * (r + 1.0))
            b_hist = torch.where(be, b_hist,
                                 (r + 1.0) ** 2 * al_last * x_last
                                 - r * r * al_last2 * x_last2)
        return tracer_mod.operator(
            tracers, mesh, fluid, rock, fluxes, npv, al, c_al, dt_eff,
            b_hist, arrays, rate, frac, inj, ghost_value, **op_kw)

    def tracer_step(fluid, fluxes, x_last, al_last, x_last2, al_last2,
                    t0, t1, dt, dt_last, first, use_bdf2):
        prog = program_for(bool(use_bdf2))
        before = _program_stats(prog)
        times = tuple(time_tensor(v, device)
                      for v in (t0, t1, dt, dt_last, first))
        args = prog.stage("tracer", (fluid, fluxes, x_last, al_last,
                                     x_last2, al_last2) + times)
        al = prog.run("tracer.balance", balance, args[0])
        res = krylov.gmres_solve(
            prog, setup, *args, al, bool(use_bdf2), rtol=tracer_mod.RTOL,
            max_restarts=krylov.max_restarts(
                tracer_mod.MAX_ITERATIONS, tracer_mod.GMRES_RESTART),
            restart=tracer_mod.GMRES_RESTART, basis_dtype=basis_dtype,
            name="tracer.gmres", **solve_kw)
        x = res.x if sync is None else prog.run("tracer.sync", sync, res.x)
        x, al = prog.hand_out((x, al))
        for k, v in _program_stats(prog).items():
            totals[k] += v - before[k]
        return tracer_mod.TracerResult(
            x=x, al=al, converged=res.converged, iterations=res.iterations,
            host_syncs=res.host_syncs, matvecs=res.matvecs)

    def stats() -> dict:
        """This tracer step's graph captures, their seconds and its
        replays so far."""
        return dict(totals)

    tracer_step.program_mode = mode
    tracer_step.stats = stats
    return tracer_step


def timestepper_state_from_numpy(y, region, device=None):
    """The state a Timestepper starts from, (y [N, npv] f64, region [N]
    int32) on `device` (resolve_device: the CUDA device unless told
    otherwise), from numpy arrays (e.g. the JAX package's final_y and
    final_region): assign it to a simulation's y0 and region0.
    Everything else the run carries (balances, fluid, fluxes) is
    recomputed from these."""
    device = resolve_device(device)
    return (
        torch.as_tensor(np.array(y, np.float64), device=device),
        torch.as_tensor(np.array(region, np.int32), device=device),
    )


def state_from_numpy(y, region, temperature, lhs, fluid, fluxes,
                     device=None):
    """A step state from numpy arrays (e.g. the JAX package's outputs):
    y [N, npv], region [N], temperature [N], lhs [N, npv], fluid a
    mapping of FluidState field name -> array, fluxes [F, nf] in
    canonical face order. Returns (y, region, temperature, lhs, fluid,
    fluxes) as tensors on `device` (resolve_device: the CUDA device
    unless told otherwise): f64, with int32 regions and integer fluid
    fields."""
    device = resolve_device(device)

    def f64(a):
        return torch.as_tensor(np.array(a, np.float64), device=device)

    def i32(a):
        return torch.as_tensor(np.array(a, np.int32), device=device)

    from waiwera_tpu_torch.physics.state import INT_FIELDS

    fluid_t = FluidState(**{
        k: (i32 if k in INT_FIELDS else f64)(fluid[k])
        for k in FluidState._fields
    })
    return (f64(y), i32(region), f64(temperature), f64(lhs), fluid_t,
            f64(fluxes))
