"""Helpers of the tests of waiwera_tpu_torch.parallel: one step of a
model over gloo ranks on the CPU (parallel/runs.py step_rank), on one
device, and through waiwera_tpu's DistributedSystem. Nothing here
imports jax at module level: spawned ranks never import it."""

import copy

import numpy as np

DT = 1.0e4


def column_config(n=48):
    return {
        "eos": {"name": "we"},
        "initial": {"primary": [5.0e6, 170.0], "region": 1},
        "source": [
            {"cell": n - 1, "rate": -0.01},
            {"cell": n // 2, "rate": 0.005, "enthalpy": 1.0e6},
        ],
        "boundaries": [{
            "primary": [5.0e6, 170.0], "region": 1,
            "faces": {"cells": [0], "normal": [0.0, 1.0]},
        }],
        "time": {"step": {"size": DT}},
    }


def port_ranks(config, mesh, params_list, d, dt=DT):
    from waiwera_tpu_torch.parallel import launch, runs

    return launch.run(runs.step_rank, ["cpu"] * d, copy.deepcopy(config),
                      mesh, params_list, dt, threads=1, timeout=300)


def port_single(config, mesh, params, dt=DT):
    from waiwera_tpu_torch.sim.simulation import Simulation

    sim = Simulation(copy.deepcopy(config), mesh=mesh, device="cpu")
    lhs0, fluid0, _ = sim.lhs_at(sim.y0, sim.region0)
    res, _, lhs, _ = sim.make_step_fn(params, "beuler")(
        sim.y0, sim.region0, fluid0.temperature, lhs0, lhs0, 0.0, dt, dt,
        1.0)
    return res, lhs


def jax_dist(config, mesh, params, d, dt=DT):
    import jax.numpy as jnp

    from waiwera_tpu.parallel import DistributedSystem
    from waiwera_tpu.sim.simulation import Simulation

    sim = Simulation(copy.deepcopy(config), mesh=mesh)
    lhs0, fluid0, _ = sim.lhs_at(sim.y0, sim.region0)
    args = (sim.y0, sim.region0, fluid0.temperature, lhs0, lhs0)
    scal = tuple(jnp.asarray(v) for v in (0.0, dt, dt, 1.0))
    dist = DistributedSystem(sim, d)
    res, _, lhs, _ = dist.make_step_fn(params, "beuler")(
        *(dist.to_local(a) for a in args), *scal)
    return (res, np.asarray(dist.from_local(res.y)),
            np.asarray(dist.from_local(res.region)),
            np.asarray(dist.from_local(lhs)))


def params(pc, **kw):
    from waiwera_tpu_torch.solver.newton import NewtonParams

    return NewtonParams(max_iterations=8, linear_pc=pc, **kw)


def jparams(pc, **kw):
    from waiwera_tpu.solver.newton import NewtonParams

    return NewtonParams(max_iterations=8, linear_pc=pc, **kw)


def collectives_rank(comm, mesh):
    """On one rank of the partition of `mesh`: the halo exchange of the
    owned cells' global ids, the reductions (all_reduce_sum under
    torch.func.jvp too) and all_gather."""
    import torch

    from waiwera_tpu_torch.parallel.comm import HaloRoutes
    from waiwera_tpu_torch.parallel.partition import build_partition

    plan = build_partition(mesh, comm.size)
    lc = torch.as_tensor(plan.local_cells[comm.rank].astype(np.int64))
    own = torch.as_tensor(plan.owned_mask[comm.rank])
    ids = torch.where(own, lc, -1)[:, None]
    synced = comm.exchange(ids, HaloRoutes(plan, comm.rank, "cpu"))
    x = torch.tensor([float(comm.rank + 1)], dtype=torch.float64)
    p, t = torch.func.jvp(lambda v: comm.all_reduce_sum(v * v), (x,),
                          (torch.ones_like(x),))
    # C18: a rank keeps its own faces, not the plan's zero-area pads on
    # cell 0, so its fixed-order face sums are as deep as its cells'
    # face counts
    from waiwera_tpu_torch.parallel.spmd import DistributedSystem
    from waiwera_tpu_torch.sim.simulation import Simulation

    sim = Simulation({"eos": {"name": "w"},
                      "initial": {"primary": [2.0e5], "region": 1}},
                     mesh=mesh, device="cpu")
    ds = DistributedSystem(sim, comm)
    fc = plan.face_cells_local[comm.rank][plan.face_mask[comm.rank]]
    return {
        "local_faces": int(ds.mesh_local.face_cells.shape[0]),
        "plan_faces": len(fc),
        "face_sum_depth": len(ds.mesh_local.face_sum.slots),
        "max_cell_faces": int(np.bincount(fc.ravel()).max()),
        "synced": synced[:, 0].numpy(),
        "sum_jvp": (float(p), float(t)),
        "max": float(comm.all_reduce_max(x)),
        "any": bool(comm.all_reduce_any(torch.tensor(comm.rank == 1))),
        "gather": comm.all_gather(torch.arange(2) + 10 * comm.rank).numpy(),
        "counts": dict(comm.counts),
    }
