"""The plain reference of a Waiwera "wge" (water, air, energy) model on
a rectangular mesh, in PyTorch: the fluid in each cell, the mass and
energy balances, the flows through faces and from sources, and the
backward-Euler residual. Written from Waiwera's formulation (Croucher
et al. 2020; its cell, face, source and EOS modules): per cell the
component masses and energy per unit volume, per face Darcy flow of
each phase with upstream mobility, saturation-weighted density and
harmonic permeability, heat conduction with a harmonic conductivity,
and deliverability or fixed-rate sources.

It reads the JSON model itself and takes from the program only the
states it judges (the scaled primary variables and the region of each
interior cell, the program's state format). It covers what the
benchmark's configurations use and refuses the rest: a "rectangular"
3-D mesh, eos "wge" or "wae" with air, rock types without tables, the
default (fully mobile) relative permeability and zero capillary
pressure, Dirichlet boundaries on the box's faces, injection at a
given rate and enthalpy, and deliverability production.
"""

from __future__ import annotations

import numpy as np
import torch

from perfbench.reference import thermo

# Waiwera's defaults (rock.F90, source_control.F90, eos_wge.F90)
ROCK_DEFAULTS = {"permeability": 1.0e-13, "porosity": 0.1,
                 "wet_conductivity": 2.5, "dry_conductivity": 2.5,
                 "density": 2200.0, "specific_heat": 1000.0}
DEFAULT_INJECTION_ENTHALPY = 83.9e3
DEFAULT_PRODUCTIVITY = 1.0e-11
DEFAULT_REFERENCE_PRESSURE = 1.0e5
# primary variable scales: pressure, temperature (regions 1 and 2) or
# vapour saturation (region 4); the air partial pressure is scaled by
# the pressure
P_SCALE, T_SCALE = 1.0e6, 1.0e2


class Unsupported(ValueError):
    """The model uses what this reference does not cover."""


def _refuse_keys(d: dict, allowed, where):
    extra = set(d) - set(allowed)
    if extra:
        raise Unsupported(f"{where}: {sorted(extra)}")


class Fluid(dict):
    """Per-cell fluid: tensors keyed by name (phases liquid, vapour;
    components water, air)."""

    __getattr__ = dict.__getitem__


class WGEBox:
    """One wge model on its rectangular mesh, on one device, in one
    floating dtype."""

    def __init__(self, model: dict, device="cpu", dtype=torch.float64):
        self.device = torch.device(device)
        self.dtype = dtype
        _refuse_keys(model, ("title", "mesh", "eos", "initial", "rock",
                             "boundaries", "source", "time", "output",
                             "gravity"), "model")
        eos = model.get("eos", {})
        eos = {"name": eos} if isinstance(eos, str) else dict(eos)
        if eos.get("name") not in ("wge", "wae") or \
                eos.get("gas", "air") != "air" or set(eos) - {"name", "gas"}:
            raise Unsupported(f"eos {eos}")
        self._mesh(model["mesh"], model.get("gravity"))
        self._rock(model.get("rock", {}))
        self._boundaries(model.get("boundaries", []) or [])
        self._sources(model.get("source", []) or [])
        init = model["initial"]
        _refuse_keys(init, ("primary", "region"), "initial")
        self.initial = (np.asarray(init["primary"], np.float64),
                        int(init.get("region", 1)))

    # -- set-up from the JSON model --------------------------------------

    def _t(self, a):
        return torch.as_tensor(np.asarray(a), dtype=self.dtype,
                               device=self.device)

    def _i(self, a):
        return torch.as_tensor(np.asarray(a), dtype=torch.int64,
                               device=self.device)

    def _mesh(self, mesh, gravity):
        _refuse_keys(mesh, ("type", "dx", "dy", "dz"), "mesh")
        if mesh.get("type") != "rectangular" or "dz" not in mesh:
            raise Unsupported("only 3-D rectangular meshes")
        w = [np.asarray(mesh[k], np.float64) for k in ("dx", "dy", "dz")]
        nx, ny, nz = (len(a) for a in w)
        self.shape = (nx, ny, nz)
        self.n = nx * ny * nz
        k, j, i = np.meshgrid(np.arange(nz), np.arange(ny), np.arange(nx),
                              indexing="ij")
        i, j, k = i.ravel(), j.ravel(), k.ravel()
        self._ijk = (i, j, k)
        vol = w[0][i] * w[1][j] * w[2][k]
        if gravity is None:
            g = np.array([0.0, 0.0, -9.8])
        elif isinstance(gravity, (int, float)):
            g = np.array([0.0, 0.0, -float(gravity)])
        else:
            g = np.zeros(3)
            g[:len(gravity)] = gravity
        self.gravity = g
        # interior faces, the lower-index cell first and the normal from
        # it to the other: the x, y and z faces
        left, right, area, d1, d2, gn, axis = [], [], [], [], [], [], []
        idx = np.arange(self.n).reshape(nz, ny, nx)
        for ax, sl in ((0, np.s_[:, :, :-1]), (1, np.s_[:, :-1, :]),
                       (2, np.s_[:-1, :, :])):
            a = idx[sl].ravel()
            b = a + (1, nx, nx * ny)[ax]
            left.append(a)
            right.append(b)
            other = [w[m][(i, j, k)[m][a]] for m in range(3) if m != ax]
            area.append(other[0] * other[1])
            d1.append(0.5 * w[ax][(i, j, k)[ax][a]])
            d2.append(0.5 * w[ax][(i, j, k)[ax][b]])
            gn.append(np.full(len(a), g[ax]))
            axis.append(np.full(len(a), ax))
        self._faces = [np.concatenate(x) for x in
                       (left, right, area, d1, d2, gn, axis)]
        self.volume = self._t(vol)
        self._widths = w

    def _rock(self, rock):
        _refuse_keys(rock, ("types",), "rock")
        props = {k: np.full(self.n, v) for k, v in ROCK_DEFAULTS.items()}
        perm = np.full((self.n, 3), ROCK_DEFAULTS["permeability"])
        for rt in rock.get("types", []) or []:
            _refuse_keys(rt, ("name", "cells", *ROCK_DEFAULTS), "rock type")
            cells = (np.asarray(rt["cells"], np.int64) if "cells" in rt
                     else np.arange(self.n))
            for k in ROCK_DEFAULTS:
                if k not in rt:
                    continue
                v = rt[k]
                if isinstance(v, dict):
                    raise Unsupported(f"rock {k} table")
                if k == "permeability":
                    v = np.atleast_1d(np.asarray(v, np.float64))
                    perm[cells] = np.concatenate(
                        [v, np.full(3 - len(v), v[-1])])
                else:
                    props[k][cells] = float(v)
        self.permeability = perm
        self.rock = {k: self._t(v) for k, v in props.items()}

    def _boundaries(self, specs):
        """Dirichlet boundaries: each listed cell's face on the box's
        side its normal points to, to a ghost state."""
        nx, ny, nz = self.shape
        i, j, k = self._ijk
        cells, primary, region, normal_axis, sign = [], [], [], [], []
        for spec in specs:
            _refuse_keys(spec, ("primary", "region", "faces"), "boundary")
            for fg in (spec["faces"] if isinstance(spec["faces"], list)
                       else [spec["faces"]]):
                _refuse_keys(fg, ("cells", "normal"), "boundary faces")
                nrm = np.asarray(fg["normal"], np.float64)
                ax = int(np.argmax(np.abs(nrm)))
                if np.count_nonzero(nrm) != 1:
                    raise Unsupported(f"boundary normal {nrm}")
                s = 1 if nrm[ax] > 0 else -1
                c = np.asarray(fg["cells"], np.int64)
                pos = (i, j, k)[ax][c]
                edge = (nx, ny, nz)[ax] - 1 if s > 0 else 0
                if np.any(pos != edge):
                    raise Unsupported("boundary cell not on that side")
                cells.append(c)
                primary.append(np.tile(spec["primary"], (len(c), 1)))
                region.append(np.full(len(c), int(spec.get("region", 1))))
                normal_axis.append(np.full(len(c), ax))
                sign.append(np.full(len(c), s))
        if not cells:
            self.ghost_cells = np.zeros(0, np.int64)
            self.ghost_primary = np.zeros((0, 3))
            self.ghost_region = np.zeros(0, np.int64)
            return
        self.ghost_cells = np.concatenate(cells)
        self.ghost_primary = np.concatenate(primary).astype(np.float64)
        self.ghost_region = np.concatenate(region)
        ax = np.concatenate(normal_axis)
        s = np.concatenate(sign)
        c = self.ghost_cells
        w = self._widths
        ng = len(c)
        ghost = self.n + np.arange(ng)
        area = np.empty(ng)
        d1 = np.empty(ng)
        for a in range(3):
            m = ax == a
            other = [w[b][self._ijk[b][c[m]]] for b in range(3) if b != a]
            area[m] = other[0] * other[1]
            d1[m] = 0.5 * w[a][self._ijk[a][c[m]]]
        gn = s * self.gravity[ax]
        f = self._faces
        self._faces = [np.concatenate([f[0], c]), np.concatenate([f[1], ghost]),
                       np.concatenate([f[2], area]), np.concatenate([f[3], d1]),
                       np.concatenate([f[4], np.zeros(ng)]),
                       np.concatenate([f[5], gn]), np.concatenate([f[6], ax])]

    def _sources(self, specs):
        cells, rate, enth, deliv, pi, pref, direction = ([] for _ in range(7))
        for s in specs:
            _refuse_keys(s, ("name", "cell", "rate", "enthalpy",
                             "deliverability", "direction"), "source")
            cells.append(int(s["cell"]))
            d = s.get("deliverability")
            deliv.append(d is not None)
            if d is not None:
                _refuse_keys(d, ("productivity", "pressure"),
                             "deliverability")
                if isinstance(d.get("productivity"), dict) or \
                        isinstance(d.get("pressure"), dict):
                    raise Unsupported("deliverability tables")
            d = d or {}
            pi.append(float(d.get("productivity", DEFAULT_PRODUCTIVITY)))
            pref.append(float(d.get("pressure", DEFAULT_REFERENCE_PRESSURE)))
            if isinstance(s.get("rate", 0.0), (dict, list)) or \
                    isinstance(s.get("enthalpy", 0.0), (dict, list)):
                raise Unsupported("source tables")
            rate.append(float(s.get("rate", 0.0)))
            enth.append(float(s.get("enthalpy", DEFAULT_INJECTION_ENTHALPY)))
            direction.append({"production": -1, "injection": 1}.get(
                s.get("direction", "both"), 0))
        self.source_cells = np.asarray(cells, np.int64)
        self._src = {"rate": self._t(rate), "enthalpy": self._t(enth),
                     "deliv": self._i(deliv).bool(), "pi": self._t(pi),
                     "pref": self._t(pref), "direction": self._i(direction)}

    # -- state -----------------------------------------------------------

    def primary(self, y, region):
        """Physical primary variables [P, T or S_v, P_air] from the
        program's scaled ones."""
        y = y.to(self.dtype)
        p = y[:, 0] * P_SCALE
        x = torch.where(region == 4, y[:, 1], y[:, 1] * T_SCALE)
        return torch.stack([p, x, y[:, 2] * p], dim=1)

    def scaled(self, primary, region):
        p = primary[:, 0]
        x = torch.where(region == 4, primary[:, 1], primary[:, 1] / T_SCALE)
        return torch.stack([p / P_SCALE, x, primary[:, 2] / p], dim=1)

    def initial_state(self):
        """The initial scaled state and region of the interior cells."""
        prim, reg = self.initial
        region = torch.full((self.n,), reg, dtype=torch.int64,
                            device=self.device)
        primary = self._t(np.tile(prim, (self.n, 1)))
        return self.scaled(primary, region), region

    def fluid(self, primary, region):
        """The fluid of each cell from its primary variables and region;
        `bad` marks cells out of the formulation's range."""
        region = region.to(torch.int64)
        p, x, pg = primary[:, 0], primary[:, 1], primary[:, 2]
        pw = p - pg
        two = region == 4
        tsat, sat_bad = thermo.saturation_temperature(
            torch.clamp(pw, thermo.P_SAT_MIN, thermo.P_CRIT))
        t = torch.where(two, tsat, x)
        sv = torch.where(two, x, (region == 2).to(p.dtype))
        present = torch.stack([(region == 1) | two, (region == 2) | two], 1)
        bad = ~((region == 1) | (region == 2) | two)
        bad = bad | (two & ((pw < thermo.P_SAT_MIN) | (pw > thermo.P_CRIT)))

        gd = thermo.air_density(pg, t)
        gh = thermo.air_enthalpy(t)
        henry, dlnh = thermo.air_henry(t)
        esol = thermo.air_solution_energy(t, dlnh)
        # liquid: water at the total pressure, with dissolved air
        dl, ul = thermo.water_liquid(torch.clamp(p, 0.0, 100e6),
                                     torch.clamp(t, 0.0, 350.0))
        bad_l = (t > 350.0) | (p > 100e6)
        xl = thermo.air_mass_fraction_liquid(pg, henry)
        hl = (ul + p / dl) * (1.0 - xl) + (gh + esol) * xl
        vl = thermo.water_viscosity(t, dl)
        # vapour: steam at the water partial pressure, mixed with air
        dv, uv = thermo.water_vapour(torch.clamp(pw, 1e-3, 100e6),
                                     torch.clamp(t, 0.0, 800.0))
        bad_v = (t > 800.0) | (pw > 100e6)
        rv = dv + gd
        xv = torch.where(rv > 1e-30, gd / torch.where(rv > 0, rv, 1.0), 0.0)
        hv = (uv + pw / dv) * (1.0 - xv) + gh * xv
        vv = thermo.air_vapour_viscosity(thermo.water_viscosity(t, dv), t, xv)
        bad = bad | (present[:, 0] & bad_l) | (present[:, 1] & bad_v)

        def phases(liq, vap):
            return torch.where(present, torch.stack([liq, vap], 1), 0.0)

        rho = phases(dl, rv)
        h = phases(hl, hv)
        visc = phases(vl, vv)
        u = torch.where(present, h - p[:, None] / torch.where(
            rho > 0, rho, 1.0), 0.0)
        sat = torch.stack([1.0 - sv, sv], 1)
        xair = phases(xl, xv)
        mass_frac = torch.stack([1.0 - xair, xair], 2)  # [n, phase, comp]
        mass_frac = torch.where(present[:, :, None], mass_frac, 0.0)
        # fully mobile relative permeability: 1 in each phase present
        mob = torch.where(present, rho / torch.where(visc > 0, visc, 1.0),
                          0.0)
        return Fluid(p=p, t=t, pg=pg, pw=pw, region=region, present=present,
                     sat=sat, rho=rho, u=u, h=h, visc=visc, mass_frac=mass_frac,
                     mob=mob, bad=bad)

    def ghost_fluid(self):
        region = self._i(self.ghost_region)
        return self.fluid(self._t(self.ghost_primary), region)

    # -- balances and flows ----------------------------------------------

    def balances(self, fl):
        """[n, 3] water, air and energy per unit volume."""
        phi = self.rock["porosity"]
        w = fl.sat * fl.rho
        mass = phi[:, None] * torch.einsum("np,npc->nc", w, fl.mass_frac)
        energy = phi * torch.sum(w * fl.u, 1) + (1.0 - phi) * (
            self.rock["density"] * self.rock["specific_heat"] * fl.t)
        return torch.cat([mass, energy[:, None]], 1)

    def conductivity(self, fl, wet, dry):
        sl = torch.clamp(fl.sat[:, 0], 0.0, 1.0)
        return dry + torch.sqrt(sl) * (wet - dry)

    def face_flows(self, fl):
        """[F, 3] water, air and energy flows (per unit area) through
        each face from its first cell to its second."""
        gf = self.ghost_fluid()
        both = Fluid({k: torch.cat([fl[k], gf[k]]) for k in fl})
        left, right, _, d1, d2, gn, axis = self._faces
        a, b = self._i(left), self._i(right)
        d1, d2, gn = self._t(d1), self._t(d2), self._t(gn)
        d12 = d1 + d2
        perm = self._t(self.permeability)
        ng = len(self.ghost_cells)
        perm = torch.cat([perm, torch.full((ng, 3), ROCK_DEFAULTS[
            "permeability"], dtype=self.dtype, device=self.device)])
        ax = self._i(axis)
        k = _harmonic(perm[a, ax], perm[b, ax], d1, d2)
        flow = torch.zeros((len(left), 3), dtype=self.dtype,
                           device=self.device)
        for ph in range(2):
            sa, sb = both.sat[a, ph], both.sat[b, ph]
            ra, rb = both.rho[a, ph], both.rho[b, ph]
            ssum = sa + sb
            rho_f = torch.where(ssum > 0, (sa * ra + sb * rb)
                                / torch.where(ssum > 0, ssum, 1.0), 0.0)
            grad = (both.p[b] - both.p[a]) / d12 - rho_f * gn
            up_a = grad <= 0.0
            up = torch.where(up_a, a, b)
            active = (both.present[a, ph] | both.present[b, ph]) & \
                both.present[up, ph]
            q = torch.where(active, -k * both.mob[up, ph] * grad, 0.0)
            flow[:, :2] += q[:, None] * both.mass_frac[up, ph, :]
            flow[:, 2] += q * both.h[up, ph]
        wet = torch.cat([self.rock["wet_conductivity"], torch.full(
            (ng,), ROCK_DEFAULTS["wet_conductivity"], dtype=self.dtype,
            device=self.device)])
        dry = torch.cat([self.rock["dry_conductivity"], torch.full(
            (ng,), ROCK_DEFAULTS["dry_conductivity"], dtype=self.dtype,
            device=self.device)])
        kc = self.conductivity(both, wet, dry)
        kf = _harmonic(kc[a], kc[b], d1, d2)
        flow[:, 2] -= kf * (both.t[b] - both.t[a]) / d12
        return flow

    def source_flows(self, fl):
        """(rate, enthalpy, [ns, 3] water, air and energy flows) of each
        source."""
        s = self._src
        c = self._i(self.source_cells)
        mob = fl.mob[c]
        mob_tot = mob.sum(1)
        frac = torch.where(mob_tot[:, None] > 0, mob / torch.where(
            mob_tot > 0, mob_tot, 1.0)[:, None], 0.0)
        h_flow = torch.sum(frac * fl.h[c], 1)
        q = torch.where(s["deliv"], -s["pi"] * mob_tot * (fl.p[c] - s["pref"]),
                        s["rate"])
        q = torch.where((s["direction"] < 0) & (q > 0), 0.0, q)
        q = torch.where((s["direction"] > 0) & (q < 0), 0.0, q)
        inj = q >= 0.0
        h = torch.where(inj, s["enthalpy"], h_flow)
        comp = torch.einsum("sp,spc->sc", frac, fl.mass_frac[c])
        water = torch.where(inj, q, q * comp[:, 0])
        air = torch.where(inj, 0.0, q * comp[:, 1])
        return q, h, torch.stack([water, air, h * q], 1)

    def inflows(self, fl):
        """[n, 3] net inflow per unit volume: faces and sources."""
        left, right, area = self._faces[:3]
        flow = self.face_flows(fl) * self._t(area)[:, None]
        total = torch.zeros((self.n + len(self.ghost_cells), 3),
                            dtype=self.dtype, device=self.device)
        total.index_add_(0, self._i(left), -flow)
        total.index_add_(0, self._i(right), flow)
        total = total[:self.n]
        if len(self.source_cells):
            _, _, q = self.source_flows(fl)
            total.index_add_(0, self._i(self.source_cells), q)
        return total / self.volume[:, None]

    def cell_fields(self, y, region) -> dict:
        """The output cell fields of state (y, region), by dataset
        name."""
        fl = self.fluid(self.primary(y, region), region)
        out = {"fluid_pressure": fl.p, "fluid_temperature": fl.t,
               "fluid_region": fl.region.to(fl.p.dtype),
               "fluid_gas_partial_pressure": fl.pg,
               "fluid_water_partial_pressure": fl.pw,
               "fluid_vapour_saturation": fl.sat[:, 1],
               "fluid_liquid_saturation": fl.sat[:, 0]}
        for ph, name in enumerate(("liquid", "vapour")):
            for key, attr in (("density", "rho"), ("viscosity", "visc"),
                              ("specific_enthalpy", "h"),
                              ("internal_energy", "u")):
                out[f"fluid_{name}_{key}"] = fl[attr][:, ph]
            for c, comp in enumerate(("water", "air")):
                out[f"fluid_{name}_{comp}_mass_fraction"] = \
                    fl.mass_frac[:, ph, c]
        return out

    def source_fields(self, y, region) -> dict:
        """The output source fields of state (y, region), by dataset
        name."""
        fl = self.fluid(self.primary(y, region), region)
        q, h, flows = self.source_flows(fl)
        return {"source_rate": q, "source_enthalpy": h,
                "source_water_flow": flows[:, 0],
                "source_air_flow": flows[:, 1],
                "source_heat_flow": flows[:, 2]}

    def residual(self, y1, region1, y0, region0, dt):
        """Backward Euler: (r, L0) with r = L(y1) - L(y0) - dt R(y1) per
        unit volume, and `bad` where a state is out of range."""
        f0 = self.fluid(self.primary(y0, region0), region0)
        f1 = self.fluid(self.primary(y1, region1), region1)
        L0 = self.balances(f0)
        r = self.balances(f1) - L0 - dt * self.inflows(f1)
        return r, L0, f0.bad | f1.bad


def _harmonic(x1, x2, d1, d2):
    """Distance-weighted harmonic mean of a face's two sides."""
    den = d1 * x2 + d2 * x1
    return torch.where(den != 0, (d1 + d2) * x1 * x2 / torch.where(
        den != 0, den, 1.0), 0.0)


