"""HDF5 simulation output (counterpart of waiwera_tpu/sim/output.py; the
same groups, dataset names, shapes and dtypes, so a file of either
package restarts the other).

Mirrors the reference's output layout (hdf5io.F90, checked against the
CREDO reader used by the benchmark suite): groups /cell_fields,
/source_fields with [ntime, n] datasets named like fluid_pressure,
fluid_temperature, ...; a time dataset [ntime, 1]; and cell_index
giving the natural cell ordering. This file doubles as the restart
checkpoint (initial.F90:421-679), tracer fields included.

h5py is imported where the file is opened, not with this module: a
machine without h5py imports the package and fails only here. Each
written field crosses from the device to the host once.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from waiwera_tpu_torch.physics.state import FluidState


def _np(a) -> np.ndarray:
    """numpy array of a tensor (one transfer to the host) or array."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def flux_fields(simulation) -> list:
    """[(name, column)] of the requested /face_fields flux fields:
    opt-in, empty by default (flow_simulation.F90:504,
    setup_output.rst "flux")."""
    cfg = (simulation.config.get("output", {}) or {}).get("fields", {}) or {}
    want = cfg.get("flux", [])
    want = [want] if isinstance(want, str) else list(want or [])
    eos = simulation.eos
    names = list(eos.component_names)
    if not eos.isothermal:
        names.append("energy")
    names += list(eos.phase_names[: eos.num_mobile_phases])
    return [(nm, k) for k, nm in enumerate(names) if nm in want]


class HDF5Output:
    def __init__(self, filename: str, simulation, fields=None):
        import h5py

        self.sim = simulation
        self.filename = filename
        self.file = h5py.File(filename, "w")
        self.n = simulation.mesh.num_interior_cells
        self.cell_group = self.file.create_group("cell_fields")
        self.time_ds = self.file.create_dataset(
            "time", shape=(0, 1), maxshape=(None, 1), dtype="f8"
        )
        self.file.create_dataset(
            "cell_index",
            data=np.arange(self.n, dtype=np.int64)[:, None],
        )
        cfg = (simulation.config.get("output", {}) or {}).get(
            "fields", {}
        ) or {}
        aslist = lambda v: [v] if isinstance(v, str) else list(v or [])
        if fields is None:
            extra = aslist(cfg.get("fluid", [])) if isinstance(cfg, dict) else []
            fields = list(simulation.eos.default_output_fluid_fields)
            # required fields always included; extras appended
            for f in extra:
                if f not in fields:
                    fields.append(f)
        self.fields = fields
        self._cell_ds = {}
        self.source_group = None
        if simulation.sources:
            self.source_group = self.file.create_group("source_fields")
            self._src_ds = {}
            self._write_source_constants(aslist(cfg.get(
                "source",
                ["natural_cell_index", "component", "rate", "enthalpy"],
            )))
        self.flux_fields = flux_fields(simulation)
        self.face_group = None
        if self.flux_fields:
            self.face_group = self.file.create_group("face_fields")
            self._face_ds = {}
            self._write_face_constants(aslist(cfg.get(
                "face_geometry", ["area", "distance"]
            )))
        self._write_geometry(aslist(cfg.get(
            "cell_geometry", ["centroid", "volume"]
        )))
        self._write_minc()

    def _write_source_constants(self, src_fields):
        """Constant per-source integer datasets, written once
        (flow_simulation.F90:2795-2924: source_index,
        natural_cell_index, component as IS views)."""
        net = self.sim.sources
        ns = net.num_sources
        col = lambda a: np.asarray(_np(a), np.int64)[:, None]
        if "source_index" in src_fields:
            self.source_group.create_dataset(
                "source_source_index", data=col(np.arange(ns))
            )
        if "natural_cell_index" in src_fields:
            self.source_group.create_dataset(
                "source_natural_cell_index", data=col(net.arrays.cell)
            )
        if "component" in src_fields:
            comp = np.where(
                np.asarray(net._base_rate) >= 0.0,
                _np(net.arrays.injection_component),
                _np(net.arrays.production_component),
            )
            self.source_group.create_dataset(
                "source_component", data=col(comp)
            )

    def _write_geometry(self, geom_fields):
        """Cell geometry datasets (flow_simulation.F90:2580-2621)."""
        mesh = self.sim.mesh
        n = self.n
        if "centroid" in geom_fields:
            self.file.create_dataset(
                "cell_geometry_centroid",
                data=np.asarray(mesh.cell_centroid)[:n],
            )
        if "volume" in geom_fields:
            self.file.create_dataset(
                "cell_geometry_volume",
                data=np.asarray(mesh.cell_volume)[:n, None],
            )

    def _write_face_constants(self, face_geom):
        """Face natural cell indices + geometry, written once when flux
        output is on (flow_simulation.F90:2711-2791,2580-2621)."""
        mesh = self.sim.mesh
        fc = np.asarray(mesh.face_cells, np.int64)
        ghost = np.asarray(mesh.is_ghost, bool)
        # boundary ghost cells have no natural index; reference writes
        # -(1-based boundary condition index); we record -1 per ghost
        bidx = getattr(mesh, "cell_boundary_index", None)
        idx = np.arange(len(ghost), dtype=np.int64)
        if bidx is not None:
            nat = np.where(ghost, -(np.asarray(bidx, np.int64) + 1), idx)
        else:
            nat = np.where(ghost, -1, idx)
        self.file.create_dataset("face_cell_1", data=nat[fc[:, 0], None])
        self.file.create_dataset("face_cell_2", data=nat[fc[:, 1], None])
        if "area" in face_geom:
            self.file.create_dataset(
                "face_geometry_area",
                data=np.asarray(mesh.face_area)[:, None],
            )
        if "distance" in face_geom:
            self.file.create_dataset(
                "face_geometry_distance",
                data=np.asarray(mesh.face_distance),
            )

    def _write_minc(self):
        """MINC level + parent natural index (/minc group,
        flow_simulation.F90:2625-2691)."""
        mesh = self.sim.mesh
        level = getattr(mesh, "minc_level", None)
        if level is None or not np.any(np.asarray(level) > 0):
            return
        g = self.file.create_group("minc")
        n = self.n
        g.create_dataset(
            "level", data=np.asarray(level, np.int64)[:n, None]
        )
        g.create_dataset(
            "parent",
            data=np.asarray(mesh.minc_parent, np.int64)[:n, None],
        )

    def _cell_dataset(self, name):
        if name not in self._cell_ds:
            self._cell_ds[name] = self.cell_group.create_dataset(
                name,
                shape=(0, self.n),
                maxshape=(None, self.n),
                dtype="f8",
            )
        return self._cell_ds[name]

    def _field_values(self, fluid: FluidState, name: str) -> np.ndarray:
        """One output field of the interior cells: sliced where it lies,
        then brought to the host."""
        n = self.n
        if name == "pressure":
            return _np(fluid.pressure[:n])
        if name == "temperature":
            return _np(fluid.temperature[:n])
        if name == "region":
            return _np(fluid.region[:n]).astype(np.float64)
        if name == "vapour_saturation":
            return _np(fluid.saturation[:n, 1])
        if name == "liquid_saturation":
            return _np(fluid.saturation[:n, 0])
        if name == "solid_saturation":
            return _np(fluid.saturation[:n, 2])
        if name == "gas_partial_pressure":
            return _np(fluid.partial_pressure[:n, -1])
        if name == "water_partial_pressure":
            return _np(fluid.partial_pressure[:n, 0])
        if name.startswith("liquid_"):
            return self._phase_field(fluid, 0, name[len("liquid_"):])
        if name.startswith("vapour_"):
            return self._phase_field(fluid, 1, name[len("vapour_"):])
        raise ValueError(f"unknown output field {name!r}")

    def _component_index(self, comp: str) -> int:
        names = [c.lower() for c in self.sim.eos.component_names]
        comp = comp.lower()
        if comp in names:
            return names.index(comp)
        if comp in ("gas", "ncg"):
            return len(names) - 1
        raise ValueError(f"unknown component {comp!r}")

    def _phase_field(self, fluid, p, attr):
        if attr.endswith("_mass_fraction"):
            comp = self._component_index(attr[: -len("_mass_fraction")])
            return _np(fluid.mass_fraction[: self.n, p, comp])
        if attr == "specific_enthalpy" or attr == "enthalpy":
            return _np(fluid.specific_enthalpy[: self.n, p])
        return _np(getattr(fluid, attr)[: self.n, p])

    def write(self, index: int, time: float, fluid: FluidState,
              source_data: Optional[dict] = None, tracer=None,
              fluxes=None):
        nt = self.time_ds.shape[0]
        self.time_ds.resize((nt + 1, 1))
        self.time_ds[nt, 0] = time
        for name in self.fields:
            ds = self._cell_dataset("fluid_" + name)
            ds.resize((nt + 1, self.n))
            ds[nt] = self._field_values(fluid, name)
        if tracer is not None and self.sim.tracers is not None:
            x = _np(tracer[: self.n])
            for k, nm in enumerate(self.sim.tracers.names):
                ds = self._cell_dataset(f"tracer_{nm}")
                ds.resize((nt + 1, self.n))
                ds[nt] = x[:, k]
        if fluxes is not None and self.face_group is not None:
            fx = _np(fluxes)
            for nm, k in self.flux_fields:
                name = "flux_" + nm
                if name not in self._face_ds:
                    nf = fx.shape[0]
                    self._face_ds[name] = self.face_group.create_dataset(
                        name, shape=(0, nf), maxshape=(None, nf),
                        dtype="f8",
                    )
                ds = self._face_ds[name]
                ds.resize((ds.shape[0] + 1, ds.shape[1]))
                ds[-1] = fx[:, k]
        if source_data and self.source_group is not None:
            for key, values in source_data.items():
                values = _np(values).reshape(-1)
                # keys arrive fully qualified (source_*, network_*);
                # bare keys are legacy source fields
                name = (
                    key
                    if key.startswith(("source_", "network_"))
                    else "source_" + key
                )
                if name not in self._src_ds:
                    ns = len(values)
                    self._src_ds[name] = self.source_group.create_dataset(
                        name, shape=(0, ns), maxshape=(None, ns), dtype="f8"
                    )
                ds = self._src_ds[name]
                ds.resize((ds.shape[0] + 1, ds.shape[1]))
                ds[-1] = values
        self.file.flush()

    def close(self):
        self.file.close()
