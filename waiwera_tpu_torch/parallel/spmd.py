"""The domain-decomposed timestep over torch.distributed ranks
(counterpart of waiwera_tpu/parallel/spmd.py).

The JAX package runs one program over a device mesh with shard_map;
here every rank is a process of its own (parallel/launch.py) that holds
its block of the partition: owned cells, an overlap-1 halo and the
faces touching its cells, in the PartitionPlan's local layout. The
single-device System/newton_solve/krylov stack runs unchanged on these
arrays: LocalSystem overrides the parallel hooks of System
(interior_mask, update_mask, reduce_*, sync, to_global_cell) with the
collectives of parallel/comm.py.

Mapping to the reference: a rank = an MPI rank; to_local =
DMGlobalToLocal; sync = the PetscSF halo exchange; reduce_* = the
VecNorm / allreduce calls inside SNES and KSP (dm_utils.F90:644,
mpi_utils.F90:37-56).

SpMV routes, as in the JAX package: where every rank's faces give one
face plan (uniform partitions of rectilinear meshes) the owned-owned
couplings go into bands applied by the dia_spmv kernel and the
cross-rank and ghost faces are a thin indexed tail; otherwise the
assembled local BSR matrix goes through bands plus a halo correction
(when the owned-owned couplings have at most MAX_BANDS offsets) or ELL.
Preconditioners act on the local rows: bjacobi exactly, asm/ilu/dilu/
sgs as the local DILU over the halo-extended rows with identity halo
rows, i.e. restricted additive Schwarz (timestepper.F90:1743-1835).

Source networks: each rank gathers the cell state of the sources it
owns, a masked all_reduce replicates the per-source state, and the
small network DAG runs replicated on every rank (source_network.F90:
91-127); each source's rate is applied on its owner only.
"""

from __future__ import annotations

import copy
from types import SimpleNamespace

import numpy as np
import torch

from waiwera_tpu_torch.mesh.device import MeshArrays, face_rows
from waiwera_tpu_torch.ops import dia, ell
from waiwera_tpu_torch.ops.segment import SegmentSum
from waiwera_tpu_torch.parallel.comm import Comm, HaloRoutes
from waiwera_tpu_torch.parallel.partition import build_partition
from waiwera_tpu_torch.sim.sources import gather_cell_state
from waiwera_tpu_torch.solver import bsr, precond
from waiwera_tpu_torch.solver.smallblocks import (
    apply_blocks_em,
    invert_blocks_em,
)
from waiwera_tpu_torch.solver.system import System

_BJACOBI_LIKE = ("bjacobi", "jacobi", "line", "zline", "cpr", "cprmg")


def _take(tree, idx: torch.Tensor, device):
    """Rows idx of a tensor or of a NamedTuple of tensors, on device."""
    if isinstance(tree, torch.Tensor):
        return tree[idx.to(tree.device)].to(device)
    return type(tree)(*(_take(v, idx, device) for v in tree))


class LocalSystem(System):
    """System on one rank's local cells (owned + halo, the plan's
    padded layout), with the parallel hooks as collectives."""

    distributed = True

    def __init__(self, eos, mesh: MeshArrays, network, comm: Comm,
                 owned: torch.Tensor, routes: HaloRoutes,
                 global_cells: torch.Tensor, n_owned_pad: int,
                 face_plan=None, dia_offsets=None):
        # no System.__init__: the banded layouts follow the partition
        self.eos = eos
        self.mesh = mesh
        self.network = network
        self.npv = npv = eos.num_primary_variables
        self.isothermal = eos.isothermal
        self.choose_cell_route()
        self.comm = comm
        self.owned = owned
        self.routes = routes
        self.global_cells = global_cells
        self._mesh_by_dtype = {torch.float64: mesh}
        self.cl = mesh.face_cells[:, 0]
        self.cr = mesh.face_cells[:, 1]
        device = mesh.is_ghost.device
        n = mesh.num_cells
        fc = mesh.face_cells.cpu().numpy()
        ghost = mesh.is_ghost.cpu().numpy()
        self.structure = bsr.build_structure(n, fc, npv)

        # route 1: one face plan on every rank. Halo slots count as
        # ghost, so the bands hold owned-owned couplings only and the
        # band SpMV reads no halo value; the tail (cross-rank, ghost
        # and pad faces) is added after the exchange.
        self.bands = None
        if face_plan is not None:
            self.bands = dia.plan_bands(face_plan, n, npv)
        if self.bands is not None:
            f_live = face_plan.f_live
            halo_like = ghost.copy()
            halo_like[n_owned_pad:] = True
            self.band_fill = dia.band_fill(self.bands, fc[:f_live],
                                           halo_like, device=device)
            self.f_live = f_live
            self._tail_cl = self.cl[f_live:]
            self._tail_cr = self.cr[f_live:]
            self._tail_sum = SegmentSum(
                np.concatenate([fc[f_live:, 0], fc[f_live:, 1]]), n, device)

        # route 2: bands of the assembled BSR matrix over the owned-owned
        # couplings, plus the halo correction (owned rows, halo columns)
        self.dia = None
        if dia_offsets is not None:
            r, c = self.structure.rows, self.structure.indices
            gr, gc = ghost[r], ghost[c]
            inner = (r < n_owned_pad) & (c < n_owned_pad)
            live = ((r == c) | ~(gr | gc)) & inner
            nnzb = len(r)
            idx = np.nonzero(live)[0]
            k = np.searchsorted(np.asarray(dia_offsets), c[idx] - r[idx])
            band_pos = np.full((len(dia_offsets), n), nnzb, np.int64)
            band_pos[k, r[idx]] = idx
            hsel = np.nonzero(~(gr | gc) & (r < n_owned_pad)
                              & (c >= n_owned_pad))[0]
            self.dia = dia.DIAStructure(offsets=tuple(dia_offsets),
                                        num_rows=n, block_size=npv)
            self._band_pos = torch.as_tensor(band_pos, device=device)
            self._halo_pos = torch.as_tensor(hsel, device=device)
            self._halo_cols = torch.as_tensor(c[hsel], device=device)
            self._halo_sum = SegmentSum(r[hsel], n, device)

    # -- parallel hooks ----------------------------------------------

    @property
    def interior_mask(self) -> torch.Tensor:
        return self.owned & ~self.mesh.is_ghost

    @property
    def update_mask(self) -> torch.Tensor:
        # halo copies of remote interior cells update locally (the same
        # per-cell transition on synced inputs as on their owner)
        return ~self.mesh.is_ghost

    def reduce_sum(self, x):
        return self.comm.all_reduce_sum(x)

    def reduce_max(self, x):
        return self.comm.all_reduce_max(x)

    def reduce_any(self, x):
        return self.comm.all_reduce_any(x)

    def to_global_cell(self, cell):
        return self.global_cells[cell]

    def sync(self, x):
        return self.comm.exchange(x, self.routes)

    # -- owned rows only ----------------------------------------------

    def _mask(self, y: torch.Tensor) -> torch.Tensor:
        return torch.where(self.owned[:, None], y, 0.0)

    def residual(self, y, region, rock, coeffs, t0, t1):
        r, L, fluxes, err = super().residual(y, region, rock, coeffs, t0, t1)
        return self._mask(r), L, fluxes, err

    def _fix_parts(self, parts):
        """Halo and pad rows -> identity, so that the local
        preconditioner is well defined (their matvec rows are masked)."""
        diag2, lr2, rl2 = parts
        eye2 = torch.eye(self.npv, dtype=diag2.dtype,
                         device=diag2.device).reshape(-1, 1)
        diag2 = torch.where(self.owned[None, :], diag2, eye2)
        lr2 = torch.where(self.owned[self.cl][None, :], lr2, 0.0)
        rl2 = torch.where(self.owned[self.cr][None, :], rl2, 0.0)
        return diag2, lr2, rl2

    def jacobian_parts(self, y, region, rock, coeffs, t0, t1,
                       tangent_dtype=None):
        return self._fix_parts(super().jacobian_parts(
            y, region, rock, coeffs, t0, t1, tangent_dtype=tangent_dtype))

    # -- linear operators ---------------------------------------------

    def make_matvec(self, mat: bsr.BSRMatrix, dtype=None):
        """Masked SpMV of assembled local BSR data with the halo
        exchange: bands + halo correction (route 2) or ELL."""
        if self.dia is None:
            m = ell.to_ell(mat, self.ell_tables, dtype)
            return lambda x: self._mask(m.matvec(self.sync(x)))
        b = self.npv
        data = torch.cat([mat.data, mat.data.new_zeros((1, b, b))])
        if dtype is not None:
            data = data.to(dtype)
        D, n = self._band_pos.shape
        bands = data[self._band_pos].reshape(D, n, b * b).transpose(1, 2)
        m = dia.DIAMatrix(offsets=self.dia.offsets,
                          bands=bands.contiguous(), block_size=b,
                          num_rows=n)
        hdata = data[self._halo_pos]

        def mv(x):
            x = x.to(m.bands.dtype)
            y = dia.dia_matvec(m, x)
            xs = self.sync(x)
            prod = torch.einsum("kij,kj->ki", hdata, xs[self._halo_cols])
            return self._mask(self._halo_sum.add(y, prod))

        return mv

    def make_linear_operator(self, mat: bsr.BSRMatrix, pc_name: str,
                             dtype=None, sweeps: int = dia.DILU_SWEEPS):
        mv = self.make_matvec(mat, dtype)
        if pc_name in ("none",) + _BJACOBI_LIKE:
            pc = precond.make_preconditioner(
                "none" if pc_name == "none" else "bjacobi", mat, dtype=dtype)
        else:  # asm / ilu / dilu / sgs / lu: the local DILU (RAS)
            pc = precond.dilu(mat, self.ilu_split, sweeps=sweeps,
                              dtype=dtype)
        return mv, pc

    def linear_operator_from_parts(self, parts, pc_name: str, dtype=None,
                                   sweeps: int = dia.DILU_SWEEPS):
        """Route 1 (one face plan on every rank): bands filled from the
        parts, the band SpMV (the dia_spmv kernel on the card) over
        unsynced x, then the indexed tail over the exchanged x. Other
        partitions assemble the local BSR matrix."""
        if self.bands is None or pc_name == "lu":
            return self.make_linear_operator(self.assemble_bsr(parts),
                                             pc_name, dtype=dtype,
                                             sweeps=sweeps)
        diag2, lr2, rl2 = parts
        m64 = dia.bands_from_blocks(self.bands, self.band_fill, diag2, lr2,
                                    rl2)
        m = m64 if dtype is None else m64._replace(bands=m64.bands.to(dtype))
        lr_t = lr2[:, self.f_live:].to(m.bands.dtype)
        rl_t = rl2[:, self.f_live:].to(m.bands.dtype)
        tcl, tcr = self._tail_cl, self._tail_cr

        def mv(x):
            y = dia.dia_matvec(m, x)
            xs = self.sync(x)
            y = self._tail_sum.add(y, torch.cat([
                apply_blocks_em(lr_t, xs[tcr]),
                apply_blocks_em(rl_t, xs[tcl])]))
            return self._mask(y)

        if pc_name == "none":
            pc = lambda r: r  # noqa: E731
        elif pc_name in _BJACOBI_LIKE:
            # line and CPR hierarchies are single-device structures
            pc = dia.dia_block_jacobi_em(invert_blocks_em(diag2), dtype)
        else:  # asm / ilu / dilu / sgs: band DILU with identity halo rows
            pc = dia.dia_dilu_em(m64, sweeps=sweeps, dtype=dtype)
        return mv, pc


class _LocalSources:
    """A rank's view of the replicated source network: source cells as
    local slots, rates kept on the owning rank only, and the per-source
    cell state replicated by a masked all_reduce before the network
    update (each source is owned exactly once, so the masked sum is a
    gather)."""

    def __init__(self, base, cell_local: np.ndarray, owner_mask: np.ndarray,
                 num_cells: int, comm: Comm):
        device = comm.device
        self.base = copy.copy(base)
        self.base.arrays = base.arrays._replace(
            cell=torch.as_tensor(cell_local, device=device),
            cell_sum=SegmentSum(cell_local, num_cells, device),
        )
        self.arrays = self.base.arrays
        self.num_sources = base.num_sources
        self.owner_mask = torch.as_tensor(owner_mask, device=device)
        self.comm = comm

    def flows(self, fluid, t0, t1, collect=None):
        state = gather_cell_state(fluid, self.arrays.cell)
        if self.base.has_network:
            # one all_reduce of all the fields side by side
            mask = self.owner_mask
            flat = [torch.where(mask.reshape((-1,) + (1,) * (a.dim() - 1)),
                                a, 0.0).reshape(len(mask), -1)
                    for a in state]
            summed = self.comm.all_reduce_sum(torch.cat(flat, dim=1))
            parts = torch.split(summed, [f.shape[1] for f in flat], dim=1)
            state = type(state)(*(p.reshape(a.shape)
                                  for p, a in zip(parts, state)))
        rate, enthalpy = self.base.flows_from_state(state, t0, t1,
                                                    collect=collect)
        return torch.where(self.owner_mask, rate, 0.0), enthalpy

    def tracer_injection(self, t0, t1, like=None):
        inj = self.base.tracer_injection(t0, t1, like=like)
        return torch.where(self.owner_mask[:, None], inj, 0.0)


class DistributedSystem:
    """One rank's share of a Simulation: the partition (the same plan on
    every rank), this rank's local mesh, layouts, routes, rock and
    sources on comm.device, local <-> global transfers and the step
    function."""

    def __init__(self, sim, comm: Comm):
        self.sim = sim
        self.comm = comm
        self.plan = plan = build_partition(sim.mesh, comm.size)
        rank, device = comm.rank, comm.device
        mesh = sim.mesh
        eos = sim.eos
        n_local = plan.n_local

        # -- local mesh arrays, faces in the plan's canonical orientation.
        # The plan pads every rank's faces to f_local with zero-area
        # faces at cell 0 (shard_map needs one shape); a rank here keeps
        # its own faces only: a pad face adds exact zeros, and thousands
        # of them on cell 0 would make its fixed-order sums that deep
        nf = int(plan.face_mask[rank].sum())
        fid = plan.face_ids[rank, :nf].astype(np.int64)
        fflip = plan.face_flip[rank, :nf]
        area = np.asarray(mesh.face_area)[fid]
        dist = np.asarray(mesh.face_distance)[fid]
        dist12 = np.asarray(mesh.face_distance12)[fid]
        gnorm = np.asarray(mesh.face_gravity_normal)[fid]
        pdir = np.asarray(mesh.face_permeability_direction, np.int64)[fid]
        dist = np.where(fflip[:, None], dist[:, ::-1], dist)
        gnorm = np.where(fflip, -gnorm, gnorm)
        self.local_cells = lc = plan.local_cells[rank].astype(np.int64)
        is_ghost = np.asarray(mesh.is_ghost, bool)
        fc = plan.face_cells_local[rank, :nf].astype(np.int64)

        def f64(a):
            return torch.as_tensor(np.ascontiguousarray(a),
                                   dtype=torch.float64, device=device)

        face_cells = torch.as_tensor(fc, device=device)
        self.mesh_local = MeshArrays(
            face_cells=face_cells,
            face_area=f64(area),
            face_distance=f64(dist),
            face_distance12=f64(dist12),
            face_gravity_normal=f64(gnorm),
            face_permeability_direction=torch.as_tensor(pdir, device=device),
            cell_volume=f64(np.asarray(mesh.cell_volume)[lc]),
            is_ghost=torch.as_tensor(is_ghost[lc], device=device),
            num_cells=n_local,
            num_interior_cells=n_local,
            face_sum=SegmentSum(np.concatenate([fc[:, 0], fc[:, 1]]),
                                n_local, device),
            face_rows=face_rows(face_cells),
        )

        # -- the SpMV route, decided alike on every rank from the plan's
        # padded faces, as in the JAX package
        ghost_loc = is_ghost[plan.local_cells]  # [D, n_local]
        halo_like = np.zeros(n_local, bool)
        halo_like[plan.n_owned_pad:] = True
        fplans = [dia.face_plan_direct(plan.face_cells_local[d],
                                       ghost_loc[d] | halo_like, n_local)
                  for d in range(comm.size)]
        self.face_plan = None
        if fplans[0] is not None and all(f == fplans[0] for f in fplans[1:]):
            self.face_plan = fplans[0]
        dia_offsets = None
        offs = {0}
        for d in range(comm.size):
            a = plan.face_cells_local[d, :, 0].astype(np.int64)
            b = plan.face_cells_local[d, :, 1].astype(np.int64)
            g = ghost_loc[d]
            sel = ((a < plan.n_owned_pad) & (b < plan.n_owned_pad)
                   & ~(g[a] | g[b]))
            offs.update((b[sel] - a[sel]).tolist())
            offs.update((a[sel] - b[sel]).tolist())
        if len(offs) <= dia.MAX_BANDS:
            dia_offsets = sorted(offs)

        # -- rock, sources, routes
        lc_t = torch.as_tensor(lc)
        self.rock = _take(sim.rock, lc_t, device)
        network = None
        base_net = getattr(sim, "sources", None)
        if base_net is not None and base_net.num_sources > 0:
            src_cells = base_net.arrays.cell.cpu().numpy()
            owner = plan.cell_device[src_cells] == rank
            network = _LocalSources(
                base_net.to(device),
                np.where(owner, plan.cell_slot[src_cells], 0).astype(np.int64),
                owner, n_local, comm)
        self.owned = torch.as_tensor(plan.owned_mask[rank], device=device)
        self.system = LocalSystem(
            eos, self.mesh_local, network, comm, self.owned,
            HaloRoutes(plan, rank, device), torch.as_tensor(lc, device=device),
            plan.n_owned_pad, face_plan=self.face_plan,
            dia_offsets=dia_offsets,
        )

    # -- global <-> local ----------------------------------------------

    def to_local(self, x):
        """This rank's local rows [n_local, ...] of a global [N, ...]
        tensor, numpy array or NamedTuple of tensors, on comm.device."""
        if isinstance(x, np.ndarray):
            x = torch.as_tensor(x)
        return _take(x, torch.as_tensor(self.local_cells), self.comm.device)

    def from_local(self, x):
        """The global [N, ...] tensor (on the CPU, natural cell order) of
        a local array or NamedTuple of arrays: every rank's owned rows,
        all gathered (collective: every rank calls it)."""
        if not isinstance(x, torch.Tensor):
            return type(x)(*(self.from_local(v) for v in x))
        plan = self.plan
        g = self.comm.all_gather(x[: plan.n_owned_pad]).cpu()
        return g[torch.as_tensor(plan.cell_device.astype(np.int64)),
                 torch.as_tensor(plan.cell_slot.astype(np.int64))]

    def make_step_fn(self, newton_params, method: str = "beuler"):
        """Simulation.make_step_fn's step over this rank's local arrays
        (all cell arrays [n_local, ...]; use to_local / from_local)."""
        from waiwera_tpu_torch.sim.simulation import step_function

        return step_function(self.system, self.rock, newton_params, method)


class NullOutput:
    """The output of a rank that writes none (every rank but 0): it
    takes the writes rank 0's file takes, so that every rank makes the
    same collective calls, and drops them."""

    def __init__(self, sim):
        from waiwera_tpu_torch.sim.output import flux_fields

        self.face_group = True if flux_fields(sim) else None

    def write(self, *args, **kwargs):
        pass

    def close(self):
        pass


class DistributedSimulation:
    """Drop-in replacement for Simulation in the Timestepper and the
    CLI: per-cell state is this rank's local [n_local, ...] arrays on
    comm.device, the step and tracer functions run over the ranks, and
    to_global restores natural cell order for output (the AO
    analogue, dm_utils.F90:782-841). Every rank runs the Timestepper;
    to_global and flux_to_global are collective. `sim` is the global
    Simulation, best built on the CPU (device="cpu"): the card then
    holds the local parts only."""

    def __init__(self, sim, comm: Comm):
        self.base = sim
        self.comm = comm
        self.device = comm.device
        self.config = sim.config
        self.eos = sim.eos
        self.mesh = sim.mesh
        self.tracers = sim.tracers
        self.sources = sim.sources
        self.dist = d = DistributedSystem(sim, comm)
        self.system = d.system
        self.rock = d.rock
        self.rock_controls = getattr(sim, "rock_controls", [])
        self.y0 = d.to_local(sim.y0)
        self.region0 = d.to_local(sim.region0)
        # halo and pad rows count as ghost for the error and interior
        # checks: each cell is checked on its owner only
        self.mesh_dev = SimpleNamespace(is_ghost=d.mesh_local.is_ghost
                                        | ~d.owned)

    # -- reductions for the Timestepper's decisions --------------------

    def reduce_max(self, x):
        return self.comm.all_reduce_max(x)

    def reduce_any(self, x):
        return self.comm.all_reduce_any(x)

    # -- the Timestepper interface -----------------------------------

    def make_step_fn(self, newton_params, method="beuler"):
        return self.dist.make_step_fn(newton_params, method)

    def rock_for(self, t: float):
        """Local rock at time t (rock controls), else the static rock."""
        if not self.rock_controls:
            return self.rock
        return self.dist.to_local(self.base.rock_for(t))

    def to_global(self, tree):
        return self.dist.from_local(tree)

    def flux_to_global(self, fluxes) -> np.ndarray:
        """Local face fluxes [rank's faces, nf] -> the host mesh's face order
        and orientation [F, nf] (collective). A face on two ranks
        carries the same value on both; either copy wins."""
        plan = self.dist.plan
        pad = fluxes.new_zeros((plan.face_ids.shape[1] - fluxes.shape[0],)
                               + tuple(fluxes.shape[1:]))
        a = self.comm.all_gather(torch.cat([fluxes, pad])).cpu().numpy()
        out = np.zeros((self.mesh.num_faces,) + a.shape[2:], a.dtype)
        for d in range(plan.num_devices):
            m = plan.face_mask[d]
            sign = np.where(plan.face_flip[d][m], -1.0, 1.0)
            out[plan.face_ids[d][m]] = a[d][m] * sign[
                (...,) + (None,) * (a.ndim - 2)]
        return out

    def fluxes_at(self, y, region) -> np.ndarray:
        return self.flux_to_global(self.initial_fluxes(y, region))

    def dof_statistics(self) -> dict:
        """DOF distribution over the ranks and the Kumar imbalance
        (flow_simulation.F90:2998-3019): owned interior cells times
        unknowns per cell."""
        plan = self.dist.plan
        is_ghost = np.asarray(self.mesh.is_ghost, bool)
        owned_interior = np.array([
            int(np.sum(~is_ghost[plan.local_cells[d][plan.owned_mask[d]]]))
            for d in range(plan.num_devices)
        ])
        npv = self.eos.num_primary_variables
        dmin = int(owned_interior.min()) * npv
        dmax = int(owned_interior.max()) * npv
        return {
            "total": int(owned_interior.sum()) * npv,
            "min": dmin,
            "max": dmax,
            "imbalance": (dmax - dmin) / dmin if dmin else 0.0,
        }

    def lhs_at(self, y, region):
        """Balances, fluid and EOS errors at a local state. Every row is
        a per-cell function of its own state, so the local rows equal
        the global evaluation's."""
        fluid, _, err = self.system.derived_state(y, region, self.rock)
        return self.system.lhs(fluid, self.rock), fluid, err

    def initial_fluxes(self, y, region):
        """Local face fluxes [rank's faces, nf] at a state, in the step
        function's face order."""
        fluid, cond, _ = self.system.derived_state(y, region, self.rock)
        return self.system.fluxes(fluid, cond, self.rock)

    def initial_tracer_state(self):
        x0, al0 = self.base.initial_tracer_state()
        return self.dist.to_local(x0), self.dist.to_local(al0)

    def make_tracer_step_fn(self):
        """The tracer solve over the ranks: local advection and
        diffusion with the halo exchange inside the matvec, reduced
        dots and owned-row masking (the parallel aux KSP gmres+bjacobi,
        timestepper.F90:1840-1851)."""
        from waiwera_tpu_torch.sim.simulation import tracer_step_function

        s = self.system
        return tracer_step_function(
            self.tracers, s.mesh, self.rock, s.network, s.npv,
            self.dist.to_local(self.base.tracer0),
            owned=s.owned, sync=s.sync, reduce_sum=s.reduce_sum,
        )
