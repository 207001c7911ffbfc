"""The nonlinear system: residual and AD block Jacobian (counterpart of
waiwera_tpu/solver/system.py).

Residual (timestepper.F90:345-452), generalised over methods:
    r = c_L * L(y) + const - dt_eff * R(y)
with backward Euler: c_L = 1, dt_eff = dt, const = -L_old;
BDF2:  c_L = 1+2r, dt_eff = dt (r+1),
       const = -(r+1)^2 L_old + r^2 L_old2  (r = dt / dt_old);
direct steady state: c_L = 0, dt_eff = -1, const = 0.

The block Jacobian is exact forward-mode AD: because balances and
sources are cell-local and fluxes are face-local in the gathered pair
representation, npv jvps over the cell chain plus 2*npv over the flux
chain give every block directly. Regions are frozen during
differentiation (doc/dev/code/index.md:37-39). Face data moves by
indexed gathers and fixed-order scatter-sums (ops/segment.py) in the
canonical face order.
"""

from __future__ import annotations

from functools import cached_property
from typing import NamedTuple

import numpy as np
import torch

from waiwera_tpu_torch.mesh.device import MeshArrays
from waiwera_tpu_torch.ops import dia, ell
from waiwera_tpu_torch.ops.segment import SegmentSum
from waiwera_tpu_torch.physics import assembly
from waiwera_tpu_torch.physics.state import FluidState, RockState
from waiwera_tpu_torch.sim.sources import source_inflows
from waiwera_tpu_torch.solver import bsr, precond
from waiwera_tpu_torch.solver.smallblocks import (
    apply_blocks_em,
    batch_from_em,
    em_from_batch,
    invert_blocks_em,
)


class MethodCoeffs(NamedTuple):
    c_lhs: float
    dt_eff: float
    const: torch.Tensor  # [N, npv]


def method_coeffs(
    method: str, dt, dt_last, first, lhs_last, lhs_last2
) -> MethodCoeffs:
    """Residual coefficients of the time integration methods
    (timestepper.F90:345-452): backward Euler, variable-step BDF2
    (backward Euler on the run's first step, `first` > 0.5) and direct
    steady state. dt, dt_last and first are Python numbers (or 0-d
    tensors, read on the host); the arithmetic is f64 in the JAX
    package's order."""
    if method == "directss":
        return MethodCoeffs(c_lhs=0.0, dt_eff=-1.0,
                            const=torch.zeros_like(lhs_last))
    dt = float(dt)
    if method == "bdf2" and not float(first) > 0.5:
        r = dt / float(dt_last)
        return MethodCoeffs(
            c_lhs=1.0 + 2.0 * r,
            dt_eff=dt * (r + 1.0),
            const=-((r + 1.0) * (r + 1.0)) * lhs_last + (r * r) * lhs_last2,
        )
    return MethodCoeffs(c_lhs=1.0, dt_eff=dt, const=-lhs_last)


class System:
    """Couples an EOS, mesh and sources into residual and Jacobian
    evaluations on dense tensors."""

    def __init__(self, eos, mesh: MeshArrays, network=None):
        self.eos = eos
        self.mesh = mesh
        self.network = network
        self.npv = eos.num_primary_variables
        self.isothermal = eos.isothermal
        face_cells = mesh.face_cells.cpu().numpy()
        is_ghost = mesh.is_ghost.cpu().numpy()
        self.structure = bsr.build_structure(
            mesh.num_cells, face_cells, self.npv
        )
        self.dia = dia.dia_structure(self.structure, is_ghost)
        device = mesh.is_ghost.device
        # hybrid band + indexed tail (MINC fracture-matrix faces, boundary
        # faces): the bands take faces[:f_live], the tail the rest
        self.hybrid = None
        self.f_live = len(face_cells)
        if self.dia is None:
            split = dia.hybrid_split(face_cells, is_ghost, mesh.num_cells,
                                     self.npv)
            if split is not None:
                self.hybrid, self.f_live = split
        self.bands = self.dia if self.dia is not None else self.hybrid
        self.band_fill = (
            dia.band_fill(self.bands, face_cells[:self.f_live], is_ghost,
                          device=device)
            if self.bands is not None
            else None
        )
        self._mesh_by_dtype = {torch.float64: mesh}
        self.cl = mesh.face_cells[:, 0]
        self.cr = mesh.face_cells[:, 1]
        self._tail_cl = self.cl[self.f_live:]
        self._tail_cr = self.cr[self.f_live:]
        self._tail_sum = (
            SegmentSum(np.concatenate([face_cells[self.f_live:, 0],
                                       face_cells[self.f_live:, 1]]),
                       mesh.num_cells, device)
            if self.hybrid is not None else None
        )

    @cached_property
    def _face_positions(self):
        """(pos_lr, pos_rl) of every face's blocks in the BSR data."""
        lr, rl = bsr.face_block_positions(
            self.structure, self.mesh.face_cells.cpu().numpy()
        )
        device = self.mesh.is_ghost.device
        return (torch.as_tensor(lr, device=device),
                torch.as_tensor(rl, device=device))

    @cached_property
    def ell_tables(self) -> ell.ELLStructure:
        return ell.ell_structure(self.structure,
                                 device=self.mesh.is_ghost.device)

    @cached_property
    def ilu_split(self) -> precond.ILU0Data:
        """The lower/upper split of the BSR DILU, built once on the
        host."""
        return precond.ilu0_split(self.structure,
                                  device=self.mesh.is_ghost.device)

    def mesh_as(self, dtype: torch.dtype) -> MeshArrays:
        """The mesh with floating geometry in dtype (cast once), so an
        f32 tangent chain is not promoted to f64 by f64 geometry."""
        m = self._mesh_by_dtype.get(dtype)
        if m is None:
            m = self.mesh.to(dtype)
            self._mesh_by_dtype[dtype] = m
        return m

    @property
    def interior_mask(self) -> torch.Tensor:
        """Rows that count in norms and move in Newton updates
        (non-ghost)."""
        return ~self.mesh.is_ghost

    # -- state chains -------------------------------------------------

    def derived_state(self, y, region, rock: RockState):
        """Scaled primaries -> (fluid, conductivity, err)."""
        primary = self.eos.unscale(y, region)
        fluid, err = self.eos.properties(primary, region, rock)
        cond = None if self.isothermal else self.eos.conductivity(rock, fluid)
        return fluid, cond, err

    def lhs(self, fluid: FluidState, rock: RockState) -> torch.Tensor:
        """Cell balances, zero in ghost cells."""
        L = assembly.cell_balances(fluid, rock, self.npv)
        return torch.where(self.mesh.is_ghost[:, None], 0.0, L)

    def source_term(self, fluid: FluidState, t0, t1) -> torch.Tensor:
        """Cell inflows from the source network at the current fluid
        state (flow_simulation.F90:1468), traced into the Jacobian."""
        if self.network is None or self.network.num_sources == 0:
            return fluid.pressure.new_zeros((self.mesh.num_cells, self.npv))
        rate, enthalpy = self.network.flows(fluid, t0, t1)
        return source_inflows(
            fluid, self.network.arrays, rate, enthalpy, self.npv,
            self.eos.num_components, self.mesh.num_cells, self.isothermal,
        )

    def _flux_pairs(self, fl, fr, perm_l, perm_r, cdl, cdr, mesh):
        return assembly.face_fluxes_pairs(
            fl, fr, perm_l, perm_r, cdl, cdr, mesh, self.npv,
            self.eos.num_mobile_phases, self.isothermal,
        )

    def fluxes(self, fluid, cond, rock):
        """[F, npv + nmob] face fluxes in canonical face order."""
        mesh = self.mesh
        perm_l, perm_r = assembly.face_permeability_sides(rock, mesh)
        cdl = cdr = None
        if not self.isothermal:
            cdl, cdr = cond[self.cl], cond[self.cr]
        return self._flux_pairs(
            fluid.index(self.cl), fluid.index(self.cr), perm_l, perm_r,
            cdl, cdr, mesh,
        )

    def _inflows(self, fluxes):
        return assembly.cell_inflows(fluxes, self.mesh, self.npv)

    def rhs(self, fluid, cond, rock, t0, t1):
        """Net cell inflows per unit volume = flux divergence +
        sources. Returns (rhs [N, npv], fluxes [F, nf])."""
        fluxes = self.fluxes(fluid, cond, rock)
        inflow = self._inflows(fluxes) + self.source_term(fluid, t0, t1)
        return torch.where(self.mesh.is_ghost[:, None], 0.0, inflow), fluxes

    # -- residual -----------------------------------------------------

    def residual(self, y, region, rock, coeffs: MethodCoeffs, t0, t1):
        """Returns (residual [N, npv], lhs [N, npv], fluxes, err [N])."""
        fluid, cond, err = self.derived_state(y, region, rock)
        L = self.lhs(fluid, rock)
        R, fluxes = self.rhs(fluid, cond, rock, t0, t1)
        r = coeffs.c_lhs * L + coeffs.const - coeffs.dt_eff * R
        return torch.where(self.mesh.is_ghost[:, None], 0.0, r), L, fluxes, err

    def residual_from_state(self, fluid, L, fluxes, coeffs, t0, t1):
        """Residual at a state whose (fluid, balances, face fluxes) are
        already in hand (the previous accepted step's outputs): only
        the time-dependent source inflows are re-evaluated."""
        ghost = self.mesh.is_ghost[:, None]
        inflow = self._inflows(fluxes) + self.source_term(fluid, t0, t1)
        R = torch.where(ghost, 0.0, inflow)
        r = coeffs.c_lhs * L + coeffs.const - coeffs.dt_eff * R
        return torch.where(ghost, 0.0, r)

    # -- block Jacobian -------------------------------------------------

    def jacobian_parts(self, y, region, rock: RockState,
                       coeffs: MethodCoeffs, t0, t1, tangent_dtype=None):
        """Element-major Jacobian block parts (diag2 [b*b, N],
        J[l,r] lr2 [b*b, F], J[r,l] rl2 [b*b, F]), J[i,j][e,v] =
        dr_i[e]/dy_j[v] in row e*npv+v.

        tangent_dtype=torch.float32 evaluates the whole chain (primal and
        tangents) in f32, as the JAX package does by tracing it under
        jax.enable_x64(False): y, rock, geometry and coefficients are
        cast once, and every constant follows its input's dtype. The
        residual itself stays f64 (it is not computed here)."""
        npv = self.npv
        dtype = y.dtype if tangent_dtype is None else tangent_dtype
        y = y.to(dtype)
        rock = rock.to(dtype)
        mesh = self.mesh_as(dtype)
        c_lhs = float(coeffs.c_lhs)
        dt_eff = float(coeffs.dt_eff)
        n = mesh.num_cells
        cl, cr = self.cl, self.cr

        def cond_or_zero(fluid, c):
            return fluid.pressure.new_zeros(n) if c is None else c

        fluid, cond, _ = self.derived_state(y, region, rock)
        cond = cond_or_zero(fluid, cond)

        def cell_chain(yv):
            # cell-local chain: fluid state, conductivity, balances and
            # source inflows (each depends on its own cell only, so one
            # jvp per primary variable gives their diagonal blocks)
            f, c, _ = self.derived_state(yv, region, rock)
            return (f.float_fields(), cond_or_zero(f, c), self.lhs(f, rock),
                    self.source_term(f, t0, t1))

        d_fluid, d_cond, dL, dq = [], [], [], []
        for v in range(npv):
            seed = torch.zeros_like(y)
            seed[:, v] = 1.0
            _, (df, dc, dLv, dqv) = torch.func.jvp(cell_chain, (y,), (seed,))
            d_fluid.append(df)
            d_cond.append(dc)
            dL.append(dLv)
            dq.append(dqv)

        # face fluxes and their side Jacobians: jvps of the pair flux
        # function against the left or the right cell's state
        perm_l, perm_r = assembly.face_permeability_sides(rock, mesh)
        fl, fr = fluid.index(cl), fluid.index(cr)
        cdl, cdr = cond[cl], cond[cr]
        iso = self.isothermal

        def flux_left(fl_floats, c_l):
            return self._flux_pairs(
                fl.with_float_fields(fl_floats), fr, perm_l, perm_r,
                None if iso else c_l, None if iso else cdr, mesh,
            )

        def flux_right(fr_floats, c_r):
            return self._flux_pairs(
                fl, fr.with_float_fields(fr_floats), perm_l, perm_r,
                None if iso else cdl, None if iso else c_r, mesh,
            )

        dflux_l, dflux_r = [], []
        for v in range(npv):
            dfl = tuple(a[cl] for a in d_fluid[v])
            _, t = torch.func.jvp(
                flux_left, (fl.float_fields(), cdl), (dfl, d_cond[v][cl])
            )
            dflux_l.append(t[:, :npv])
            dfr = tuple(a[cr] for a in d_fluid[v])
            _, t = torch.func.jvp(
                flux_right, (fr.float_fields(), cdr), (dfr, d_cond[v][cr])
            )
            dflux_r.append(t[:, :npv])

        # -- assemble blocks, element-major
        area = mesh.face_area
        vol = torch.where(mesh.cell_volume > 0.0, mesh.cell_volume, 1.0)
        av_l = area / vol[cl]  # [F]
        av_r = area / vol[cr]
        ghost_l = mesh.is_ghost[cl]
        ghost_r = mesh.is_ghost[cr]
        either_ghost = ghost_l | ghost_r

        def stack(fn):
            return torch.stack(
                [fn(ii, v) for ii in range(npv) for v in range(npv)]
            )

        # diagonal: cL dL - dt_eff dq + face self-terms
        diag2 = stack(lambda ii, v: c_lhs * dL[v][:, ii] - dt_eff * dq[v][:, ii])
        contrib_l2 = stack(lambda ii, v: torch.where(
            ghost_l, 0.0, dt_eff * av_l * dflux_l[v][:, ii]))
        contrib_r2 = stack(lambda ii, v: torch.where(
            ghost_r, 0.0, -dt_eff * av_r * dflux_r[v][:, ii]))
        diag2 = mesh.face_sum.add(diag2, torch.cat([contrib_l2, contrib_r2],
                                                   1), dim=1)
        # ghost rows: identity
        eye2 = torch.eye(npv, dtype=dtype, device=y.device).reshape(-1, 1)
        diag2 = torch.where(mesh.is_ghost[None, :], eye2, diag2)

        # off-diagonal blocks (zero if either end is a ghost: ghost dofs
        # are fully decoupled)
        lr2 = stack(lambda ii, v: torch.where(
            either_ghost, 0.0, dt_eff * av_l * dflux_r[v][:, ii]))
        rl2 = stack(lambda ii, v: torch.where(
            either_ghost, 0.0, -dt_eff * av_r * dflux_l[v][:, ii]))
        return diag2, lr2, rl2

    def residual_and_jacobian_parts(self, y, region, rock, coeffs, t0, t1,
                                    tangent_dtype=None):
        """(r, L, fluxes, err, (diag2, lr2, rl2)): the f64 residual and the
        Jacobian parts (tangent chain in tangent_dtype, default y's)."""
        r, L, fluxes, err = self.residual(y, region, rock, coeffs, t0, t1)
        parts = self.jacobian_parts(y, region, rock, coeffs, t0, t1,
                                    tangent_dtype=tangent_dtype)
        return r, L, fluxes, err, parts

    def residual_and_jacobian(self, y, region, rock, coeffs, t0, t1,
                              tangent_dtype=None):
        """(r, L, fluxes, err, BSRMatrix)."""
        r, L, fluxes, err, parts = self.residual_and_jacobian_parts(
            y, region, rock, coeffs, t0, t1, tangent_dtype=tangent_dtype
        )
        return r, L, fluxes, err, self.assemble_bsr(parts)

    def assemble_bsr(self, parts) -> bsr.BSRMatrix:
        """Element-major block parts (diag2 [b*b, N], J[l,r] and J[r,l]
        [b*b, F]) accumulated into BSR data."""
        diag2, lr2, rl2 = parts
        pos_lr, pos_rl = self._face_positions
        return bsr.assemble(self.structure, batch_from_em(diag2),
                            batch_from_em(lr2), batch_from_em(rl2),
                            pos_lr, pos_rl)

    # -- linear operator -----------------------------------------------

    def make_matvec(self, mat: bsr.BSRMatrix, dtype=None):
        """SpMV closure of assembled BSR data: the band layout on banded
        meshes (the dia_spmv kernel on the card), ELL otherwise."""
        if self.dia is not None:
            m = dia.to_dia(mat, self.dia, dtype)
            return lambda x: dia.dia_matvec(m, x.to(m.bands.dtype))
        return ell.to_ell(mat, self.ell_tables, dtype).matvec

    def make_linear_operator(self, mat: bsr.BSRMatrix, pc_name: str,
                             dtype=None):
        """(matvec, preconditioner) from assembled BSR data through the
        ELL layout (the JAX package's non-banded route), with every
        preconditioner of precond.make_preconditioner (line and cpr
        fall back to block-Jacobi off a box)."""
        mv = ell.to_ell(mat, self.ell_tables, dtype).matvec
        split = (self.ilu_split if pc_name in ("asm", "ilu", "dilu", "sgs")
                 else None)
        return mv, precond.make_preconditioner(
            pc_name, mat, split=split, sweeps=dia.DILU_SWEEPS, dtype=dtype)

    def linear_operator_from_parts(self, parts, pc_name: str, dtype=None):
        """(matvec, preconditioner) from block parts.

        Banded and hybrid meshes: bands filled by index in the parts'
        dtype (so factorisations see full precision) and applied in
        `dtype`; the hybrid tail faces[f_live:] is added to the band SpMV
        by a fixed-order scatter-sum. pc_name: none, bjacobi/jacobi, line/zline,
        cpr/cprmg, or asm/ilu/dilu/sgs (the band DILU, which on a hybrid
        mesh factors the banded part only). "lu" factors the assembled
        BSR matrix densely beside the band SpMV of a banded mesh. Other
        meshes, and "lu" on a hybrid mesh, take make_linear_operator on
        assembled BSR data, as in the JAX package."""
        if self.bands is None or (pc_name == "lu" and self.dia is None):
            return self.make_linear_operator(self.assemble_bsr(parts),
                                             pc_name, dtype=dtype)
        diag2, lr2, rl2 = parts
        m64 = dia.bands_from_blocks(self.bands, self.band_fill, diag2, lr2,
                                    rl2)
        m = m64 if dtype is None else m64._replace(bands=m64.bands.to(dtype))
        if self.hybrid is None or self._tail_cl.numel() == 0:
            def mv(x):
                return dia.dia_matvec(m, x)
        else:
            lr_t = lr2[:, self.f_live:].to(m.bands.dtype)
            rl_t = rl2[:, self.f_live:].to(m.bands.dtype)
            tcl, tcr = self._tail_cl, self._tail_cr

            def mv(x):
                return self._tail_sum.add(dia.dia_matvec(m, x), torch.cat([
                    apply_blocks_em(lr_t, x[tcr]),
                    apply_blocks_em(rl_t, x[tcl])]))

        def bjacobi():
            return dia.dia_block_jacobi_em(invert_blocks_em(diag2), dtype)

        if pc_name == "none":
            pc = lambda r: r  # noqa: E731
        elif pc_name in ("bjacobi", "jacobi"):
            pc = bjacobi()
        elif pc_name in ("line", "zline"):
            pc = dia.dia_line_pc_em(m64, dtype=dtype) or bjacobi()
        elif pc_name in ("cpr", "cprmg"):
            from waiwera_tpu_torch.ops import mg

            built = mg.pressure_levels(m64, dtype=dtype)
            pc = bjacobi()
            if built is not None:
                levels, dims = built
                pc = mg.cpr_apply(levels, dims, mv, pc, self.mesh.num_cells)
        elif pc_name in ("asm", "ilu", "dilu", "sgs"):
            pc = dia.dia_dilu_em(m64, dtype=dtype)
        elif pc_name == "lu":
            pc = precond.lu(self.assemble_bsr(parts), dtype=dtype)
        else:
            raise ValueError(f"unknown preconditioner: {pc_name!r}")
        return mv, pc
