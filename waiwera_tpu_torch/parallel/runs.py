"""Rank functions for runs over several ranks (parallel/launch.py):
one Newton step from a model's initial state, and Timestepper runs.
Each is called as fn(comm, ...) on every rank and returns, on every
rank, the global result in natural cell order as numpy arrays with the
rank's counts (collectives and their seconds, kernel launches, Krylov
matvecs, host syncs, set-up and run seconds). They live in the package because
spawned ranks import their function by reference.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from waiwera_tpu_torch.ops import dia
from waiwera_tpu_torch.parallel.spmd import NullOutput


def _numpy(t):
    return None if t is None else t.detach().cpu().numpy()


def _launches():
    return {"dia_spmv": dia.dia_spmv_launches.count,
            "dia_spmv_f64": dia.dia_spmv_f64_launches.count}


def _reset_launches():
    dia.dia_spmv_launches.count = 0
    dia.dia_spmv_f64_launches.count = 0


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _distributed(comm, config, mesh):
    from waiwera_tpu_torch.parallel.spmd import DistributedSimulation
    from waiwera_tpu_torch.sim.simulation import Simulation

    return DistributedSimulation(
        Simulation(config, mesh=mesh, device="cpu"), comm)


def route(system) -> str:
    """The SpMV route of a rank's LocalSystem: "bands" (one face plan
    on every rank), "dia" (bands of the assembled matrix) or "ell"."""
    if system.bands is not None:
        return "bands"
    return "dia" if system.dia is not None else "ell"


def step_rank(comm, config, mesh, params_list, dt: float):
    """One backward-Euler step of size dt from the initial state over
    the ranks for each NewtonParams of params_list: per solve, (y,
    region, lhs) in natural order and its counts."""
    w0 = time.perf_counter()
    sim = _distributed(comm, config, mesh)
    lhs0, fluid0, _ = sim.lhs_at(sim.y0, sim.region0)
    setup = time.perf_counter() - w0
    out = []
    for params in params_list:
        step = sim.make_step_fn(params, "beuler")
        _reset_launches()
        w0 = time.perf_counter()
        res, _, lhs, _ = step(sim.y0, sim.region0, fluid0.temperature,
                              lhs0, lhs0, 0.0, dt, dt, 1.0)
        _sync(comm.device)
        out.append({
            "y": _numpy(sim.to_global(res.y)),
            "region": _numpy(sim.to_global(res.region)),
            "lhs": _numpy(sim.to_global(lhs)),
            "converged": res.converged, "failed": res.failed,
            "iterations": res.iterations,
            "linear_iterations": res.linear_iterations,
            "matvecs": res.matvecs, "host_syncs": res.host_syncs,
            "launches": _launches(), "route": route(sim.system),
            "setup_seconds": setup,
            "step_seconds": time.perf_counter() - w0,
        })
    return out


class MemoryOutput(NullOutput):
    """Output kept in memory on rank 0: per record the time, the global
    pressure, temperature and tracers, and the source fields."""

    def __init__(self, sim):
        super().__init__(sim)
        self.records = []

    def write(self, index, time, fluid, source_data=None, tracer=None,
              fluxes=None):
        self.records.append({
            "time": float(time),
            "pressure": _numpy(fluid.pressure),
            "temperature": _numpy(fluid.temperature),
            "tracer": _numpy(tracer),
            "source": {k: np.asarray(v)
                       for k, v in (source_data or {}).items()},
        })


def run_rank(comm, config, mesh=None, h5_filename=None):
    """A Timestepper run over the ranks. Rank 0 writes HDF5 output to
    h5_filename where given, else keeps it in memory. Returns the final
    state in natural order (y, region, tracers), the tries, the log of
    accepted steps, the in-memory records and the counts."""
    from waiwera_tpu_torch.sim.timestepper import Timestepper
    from waiwera_tpu_torch.utils.logging import Logger

    w0 = time.perf_counter()
    sim = _distributed(comm, config, mesh)
    if comm.rank != 0:
        output = NullOutput(sim)
    elif h5_filename is not None:
        from waiwera_tpu_torch.sim.output import HDF5Output

        output = HDF5Output(h5_filename, sim)
    else:
        output = MemoryOutput(sim)
    ts = Timestepper(config, sim, output=output, logger=Logger())
    _sync(comm.device)
    setup = time.perf_counter() - w0
    _reset_launches()
    counts0 = dict(comm.counts)
    seconds0 = dict(comm.seconds)
    w0 = time.perf_counter()
    ok = ts.run()
    _sync(comm.device)
    run_seconds = time.perf_counter() - w0
    output.close()
    collectives = {k: comm.counts[k] - counts0[k] for k in comm.counts}
    collective_s = {k: comm.seconds[k] - seconds0[k] for k in comm.seconds}
    launches = _launches()
    final_tracer = (None if ts.final_tracer is None
                    else _numpy(sim.to_global(ts.final_tracer)))
    return {
        "ok": ok,
        "y": _numpy(sim.to_global(ts.final_y)),
        "region": _numpy(sim.to_global(ts.final_region)),
        "tracer": final_tracer,
        "tried": ts.tried,
        "accepted": ts.accepted,
        "stats": ts.stats,
        "records": getattr(output, "records", None),
        "route": route(sim.system),
        "collectives": collectives,
        "collective_seconds": collective_s,
        "launches": launches,
        "setup_seconds": setup,
        "run_seconds": run_seconds,
    }


def run_configs(comm, configs):
    """run_rank for each config in turn, in one process group: one
    spawn of the ranks for several runs."""
    return [run_rank(comm, cfg) for cfg in configs]
