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
representation, npv tangents of the cell chain plus 2*npv of the flux
chain give every block directly; each chain is one torch.func.jvp
vmapped over its seeds, so its primal runs once per Jacobian (the JAX
package's jax.linearize). For the water, air and energy EOS on the
card the cell chain is one hand-written forward-mode kernel instead
(ops/wge_cell.py). Regions are frozen during
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
from waiwera_tpu_torch.ops import dia, ell, wge_cell
from waiwera_tpu_torch.ops.segment import SegmentSum
from waiwera_tpu_torch.physics import assembly
from waiwera_tpu_torch.physics.state import INT_FIELDS, FluidState, RockState
from waiwera_tpu_torch.sim.sources import source_inflows
from waiwera_tpu_torch.solver import bsr, precond
from waiwera_tpu_torch.solver.smallblocks import (
    apply_blocks_em,
    batch_from_em,
    em_from_batch,
    invert_blocks_em,
)
from waiwera_tpu_torch.utils.interpolation import scalar_like


class MethodCoeffs(NamedTuple):
    c_lhs: torch.Tensor  # 0-d f64 (a Python number is accepted too)
    dt_eff: torch.Tensor  # 0-d f64 (a Python number is accepted too)
    const: torch.Tensor  # [N, npv]


def time_tensor(t, device) -> torch.Tensor:
    """A time as a 0-d f64 tensor on `device`: a tensor is cast there, a
    Python number filled (a fill, not a copy from the host). Times reach
    the step's ops as tensors, so that a captured step replays the
    values of each try, not those of the try it was captured at."""
    if isinstance(t, torch.Tensor):
        return t.to(dtype=torch.float64, device=device)
    return torch.full((), float(t), dtype=torch.float64, device=device)


def _fluid_of(ints, floats) -> FluidState:
    """A FluidState from its integer fields (INT_FIELDS order) and its
    floating fields (field order)."""
    it_i, it_f = iter(ints), iter(floats)
    return FluidState(*(next(it_i) if k in INT_FIELDS else next(it_f)
                        for k in FluidState._fields))


def method_coeffs(
    method: str, dt, dt_last, first, lhs_last, lhs_last2
) -> MethodCoeffs:
    """Residual coefficients of the time integration methods
    (timestepper.F90:345-452): backward Euler, variable-step BDF2
    (backward Euler on the run's first step, `first` > 0.5) and direct
    steady state. dt, dt_last and first are 0-d tensors or Python
    numbers (made 0-d f64 tensors on lhs_last's device); nothing is read
    on the host, and the arithmetic is f64 in the JAX package's order.
    directss is a static branch of the method."""
    if method == "directss":
        return MethodCoeffs(c_lhs=lhs_last.new_zeros(()),
                            dt_eff=lhs_last.new_full((), -1.0),
                            const=torch.zeros_like(lhs_last))
    dev = lhs_last.device
    dt = time_tensor(dt, dev)
    if method == "bdf2":
        r = dt / time_tensor(dt_last, dev)
        first = time_tensor(first, dev) > 0.5
        return MethodCoeffs(
            c_lhs=torch.where(first, 1.0, 1.0 + 2.0 * r),
            dt_eff=torch.where(first, dt, dt * (r + 1.0)),
            const=torch.where(
                first, -lhs_last,
                -((r + 1.0) * (r + 1.0)) * lhs_last + (r * r) * lhs_last2),
        )
    return MethodCoeffs(c_lhs=torch.ones_like(dt), dt_eff=dt,
                        const=-lhs_last)


class System:
    """Couples an EOS, mesh and sources into residual and Jacobian
    evaluations on dense tensors."""

    # one rank's share of a domain-decomposed system (parallel/spmd.py)
    distributed = False

    def __init__(self, eos, mesh: MeshArrays, network=None):
        self.eos = eos
        self.mesh = mesh
        self.network = network
        self.npv = eos.num_primary_variables
        self.isothermal = eos.isothermal
        self.choose_cell_route()
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

    def choose_cell_route(self):
        """The Jacobian's cell chain: the kernel csrc/wge_cell_jvp.cu
        where it covers the EOS and the mesh lies on a CUDA device
        (ops/wge_cell.py route), the plain chain (cell_jvp) otherwise."""
        self.cell_kernel = wge_cell.route(self.eos, self.mesh.is_ghost.device)
        self._cell_params = (wge_cell.wge_params(self.eos)
                             if self.cell_kernel else None)

    @cached_property
    def _bsr_assembly(self) -> bsr.Assembly:
        """bsr.assemble's device tables for this mesh, built once."""
        return bsr.assembly(self.structure,
                            self.mesh.face_cells.cpu().numpy(),
                            device=self.mesh.is_ghost.device)

    @cached_property
    def lu_positions(self) -> torch.Tensor:
        """precond.lu's densifying positions for this mesh, built once."""
        return precond.dense_positions(self.structure,
                                       device=self.mesh.is_ghost.device)

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

    # -- parallel hooks: identities on one device; parallel/spmd.py's
    # LocalSystem overrides them with collectives over the ranks ------

    @property
    def interior_mask(self) -> torch.Tensor:
        """Rows that count in norms and residuals (non-ghost)."""
        return ~self.mesh.is_ghost

    @property
    def update_mask(self) -> torch.Tensor:
        """Rows that move in Newton updates (non-ghost)."""
        return ~self.mesh.is_ghost

    def reduce_sum(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def reduce_max(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def reduce_any(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def sync(self, x: torch.Tensor) -> torch.Tensor:
        """The halo exchange of a cell array."""
        return x

    def to_global_cell(self, cell: torch.Tensor) -> torch.Tensor:
        """Local cell index -> natural (global) cell index."""
        return cell

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

    def cell_jvp(self, y, region, rock: RockState, t0, t1):
        """The cell chain at y and its npv tangents (seed v: y[:, v]), the
        plain version of the kernel route (ops/wge_cell.py): one
        torch.func.jvp of the cell chain vmapped over the npv seeds, in
        the dtype of y and rock. Returns (fluid, cond [N], d_fluid
        (per floating field [npv, N, ...]), d_cond [npv, N], dL [npv, N,
        npv], dq [npv, N, npv])."""
        npv = self.npv
        dtype = y.dtype
        n = self.mesh.num_cells

        def cell_chain(yv):
            # cell-local chain: fluid state, conductivity, balances and
            # source inflows (each depends on its own cell only, so one
            # seed per primary variable gives their diagonal blocks); the
            # fluid's integer fields ride along as aux
            f, c, _ = self.derived_state(yv, region, rock)
            c = f.pressure.new_zeros(n) if c is None else c
            ints = tuple(getattr(f, k) for k in INT_FIELDS)
            return (f.float_fields(), c, self.lhs(f, rock),
                    self.source_term(f, t0, t1)), ints

        seeds = torch.eye(npv, dtype=dtype, device=y.device)[:, None, :] \
            .expand(npv, n, npv)
        (floats, cond, _, _), (d_fluid, d_cond, dL, dq), ints = \
            torch.func.vmap(
                lambda seed: torch.func.jvp(cell_chain, (y,), (seed,),
                                            has_aux=True),
                out_dims=(None, 0, None),
            )(seeds)
        return _fluid_of(ints, floats), cond, d_fluid, d_cond, dL, dq

    def source_jvp(self, fluid: FluidState, d_fluid, t0, t1):
        """[npv, N, npv] tangents of the source inflows at fluid, given the
        tangents of its floating fields ([npv, N, ...] each): the chain
        rule through source_term, whose cost is per source."""
        def inflows(*floats):
            return self.source_term(fluid.with_float_fields(floats), t0, t1)

        primals = fluid.float_fields()
        return torch.func.vmap(
            lambda *t: torch.func.jvp(inflows, primals, t),
            out_dims=(None, 0),
        )(*d_fluid)[1]

    def jacobian_parts(self, y, region, rock: RockState,
                       coeffs: MethodCoeffs, t0, t1, tangent_dtype=None):
        """Element-major Jacobian block parts (diag2 [b*b, N],
        J[l,r] lr2 [b*b, F], J[r,l] rl2 [b*b, F]), J[i,j][e,v] =
        dr_i[e]/dy_j[v] in row e*npv+v.

        Each chain's primal is evaluated once, as jax.linearize does in
        the JAX package: one torch.func.jvp of the cell chain, vmapped
        over the npv seeds (rows of the identity), and one jvp of the
        pair flux function of both sides, vmapped over 2*npv seeds (left
        seeds, then right). The primal does not depend on the batched
        tangent, so vmap runs it unbatched (out_dims=None asserts it).

        tangent_dtype=torch.float32 evaluates the whole chain (primal and
        tangents) in f32, as the JAX package does by tracing it under
        jax.enable_x64(False): y, rock, geometry and coefficients are
        cast once, and every constant follows its input's dtype. The
        residual itself stays f64 (it is not computed here). Nothing is
        read on the host.

        On the kernel route (choose_cell_route) the cell chain and its
        tangents come from csrc/wge_cell_jvp.cu instead, in `dtype` from
        the f64 state, and the source inflows' tangents from source_jvp;
        the face chain and the assembly are the same."""
        npv = self.npv
        dtype = y.dtype if tangent_dtype is None else tangent_dtype
        rock_t = rock.to(dtype)
        if self.cell_kernel:
            # the kernel reads the f64 state and casts it in registers
            cells = wge_cell.cell_jvp(self._cell_params, y, region, rock,
                                      self.mesh.is_ghost, dtype)
            fluid = cells.fluid(region)
            cond, d_fluid, d_cond, dL = (cells.cond, cells.d_fluid,
                                         cells.d_cond, cells.dL)
            dq = self.source_jvp(fluid, d_fluid, t0, t1)
        else:
            fluid, cond, d_fluid, d_cond, dL, dq = self.cell_jvp(
                y.to(dtype), region, rock_t, t0, t1)
        mesh = self.mesh_as(dtype)
        c_lhs = scalar_like(coeffs.c_lhs, rock_t.porosity)
        dt_eff = scalar_like(coeffs.dt_eff, rock_t.porosity)
        cl, cr = self.cl, self.cr

        # face fluxes and their side Jacobians: one jvp of the pair flux
        # function of both sides' states, vmapped over the left cell's
        # seeds and then the right cell's
        perm_l, perm_r = assembly.face_permeability_sides(rock_t, mesh)
        fl, fr = fluid.index(cl), fluid.index(cr)
        iso = self.isothermal

        def flux_pair(fl_floats, fr_floats, c_l, c_r):
            return self._flux_pairs(
                fl.with_float_fields(fl_floats),
                fr.with_float_fields(fr_floats), perm_l, perm_r,
                None if iso else c_l, None if iso else c_r, mesh,
            )[:, :npv]

        def side(t, cells, right):
            # the seeds' tangents at one side's cells, zero under the
            # other side's seeds: [2 npv, F, ...]
            g = t[:, cells]
            z = torch.zeros_like(g)
            return torch.cat([z, g] if right else [g, z])

        fl_t = tuple(side(a, cl, False) for a in d_fluid)
        fr_t = tuple(side(a, cr, True) for a in d_fluid)
        primals = (fl.float_fields(), fr.float_fields(), cond[cl], cond[cr])
        _, dflux = torch.func.vmap(
            lambda tl, tr, cl_t, cr_t: torch.func.jvp(
                flux_pair, primals, (tl, tr, cl_t, cr_t)),
            out_dims=(None, 0),
        )(fl_t, fr_t, side(d_cond, cl, False), side(d_cond, cr, True))
        dflux_l, dflux_r = dflux[:npv], dflux[npv:]

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
        [b*b, F]) summed into BSR data (bsr.assemble)."""
        diag2, lr2, rl2 = parts
        return bsr.assemble(self.structure, self._bsr_assembly,
                            batch_from_em(diag2), batch_from_em(lr2),
                            batch_from_em(rl2))

    # -- linear operator -----------------------------------------------

    def make_matvec(self, mat: bsr.BSRMatrix, dtype=None):
        """SpMV closure of assembled BSR data: the band layout on banded
        meshes (the dia_spmv kernel on the card), ELL otherwise."""
        if self.dia is not None:
            m = dia.to_dia(mat, self.dia, dtype)
            return lambda x: dia.dia_matvec(m, x.to(m.bands.dtype))
        return ell.to_ell(mat, self.ell_tables, dtype).matvec

    def make_linear_operator(self, mat: bsr.BSRMatrix, pc_name: str,
                             dtype=None, sweeps: int = dia.DILU_SWEEPS):
        """(matvec, preconditioner) from assembled BSR data through the
        ELL layout (the JAX package's non-banded route), with every
        preconditioner of precond.make_preconditioner (line and cpr
        fall back to block-Jacobi off a box)."""
        mv = ell.to_ell(mat, self.ell_tables, dtype).matvec
        split = (self.ilu_split if pc_name in ("asm", "ilu", "dilu", "sgs")
                 else None)
        positions = self.lu_positions if pc_name == "lu" else None
        return mv, precond.make_preconditioner(
            pc_name, mat, split=split, sweeps=sweeps, dtype=dtype,
            positions=positions)

    def linear_operator_from_parts(self, parts, pc_name: str, dtype=None,
                                   sweeps: int = dia.DILU_SWEEPS):
        """(matvec, preconditioner) from block parts.

        Banded and hybrid meshes: bands filled by index in the parts'
        dtype (so factorisations see full precision) and applied in
        `dtype`; the hybrid tail faces[f_live:] is added to the band SpMV
        by a fixed-order scatter-sum. pc_name: none, bjacobi/jacobi, line/zline,
        cpr/cprmg, or asm/ilu/dilu/sgs (the band DILU, which on a hybrid
        mesh factors the banded part only). "lu" factors the assembled
        BSR matrix densely beside the band SpMV of a banded mesh. Other
        meshes, and "lu" on a hybrid mesh, take make_linear_operator on
        assembled BSR data, as in the JAX package. sweeps: the DILU's
        fixed-point sweeps per triangular solve."""
        if self.bands is None or (pc_name == "lu" and self.dia is None):
            return self.make_linear_operator(self.assemble_bsr(parts),
                                             pc_name, dtype=dtype,
                                             sweeps=sweeps)
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
            pc = dia.dia_dilu_em(m64, sweeps=sweeps, dtype=dtype)
        elif pc_name == "lu":
            pc = precond.lu(self.assemble_bsr(parts), dtype=dtype,
                            positions=self.lu_positions)
        else:
            raise ValueError(f"unknown preconditioner: {pc_name!r}")
        return mv, pc
