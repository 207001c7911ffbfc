"""Start N ranks, one process each, joined by a torch.distributed
process group (the mpiexec -np N of the reference).

run(fn, devices, *args) spawns one process per entry of `devices` with
torch.multiprocessing, joins them through a FileStore in a fresh
temporary directory (no TCP port), calls fn(comm, *args) on every rank
and returns the ranks' return values in rank order. fn must be a
module-level function (spawn pickles it by reference). The process
group has a timeout and the join a deadline, so a rank that waits in a
collective for ever fails the run instead of hanging it.
"""

from __future__ import annotations

import datetime
import os
import shutil
import tempfile
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from waiwera_tpu_torch.parallel.comm import Comm, backend_for

DEFAULT_TIMEOUT = 900.0  # seconds, for one collective and for the join


def _worker(rank, fn, devices, backend, store_path, out_dir, timeout,
            threads, args):
    torch.set_num_threads(threads)
    device = torch.device(devices[rank])
    if device.type == "cuda":
        torch.cuda.set_device(device)
    store = dist.FileStore(store_path, len(devices))
    dist.init_process_group(
        backend, store=store, rank=rank, world_size=len(devices),
        timeout=datetime.timedelta(seconds=timeout),
    )
    try:
        comm = Comm(rank, len(devices), backend, device)
        # the group's first collective involves every rank, as NCCL's
        # batched point-to-point calls require
        comm.barrier()
        out = fn(comm, *args)
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _indexed(device) -> torch.device:
    """The device with its index: "cuda" is card 0."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", 0)
    return device


def run(fn, devices, *args, timeout=DEFAULT_TIMEOUT, threads=None):
    """[fn(comm, *args) of each rank]. devices: one torch device per
    rank (repeat a device to share it; "cuda" is card 0), which also
    picks the backend (comm.backend_for); threads: torch.set_num_threads
    in each rank, by default the host's cores shared out among the
    ranks."""
    devices = [str(_indexed(d)) for d in devices]
    backend = backend_for(devices)
    if threads is None:
        threads = max(1, (os.cpu_count() or 1) // len(devices))
    tmp = tempfile.mkdtemp(prefix="waiwera_ranks_")
    try:
        ctx = mp.spawn(
            _worker,
            args=(fn, devices, backend, os.path.join(tmp, "store"), tmp,
                  timeout, threads, args),
            nprocs=len(devices), join=False,
        )
        deadline = time.monotonic() + timeout
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                for p in ctx.processes:
                    if p.is_alive():
                        p.kill()
                raise TimeoutError(
                    f"{len(devices)} ranks did not finish in {timeout} s")
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                           weights_only=False)
                for r in range(len(devices))]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
