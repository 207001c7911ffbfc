"""Collectives and the halo exchange of one rank (the counterpart of
the XLA collectives under shard_map in waiwera_tpu/parallel/spmd.py).

One process per rank, joined by a torch.distributed process group:

- lax.psum -> all_reduce(SUM); lax.pmax and reduce_any -> all_reduce(MAX)
- the all_gather halo exchange -> all_gather_into_tensor
- the edge-coloured lax.ppermute rounds -> one batch_isend_irecv per
  round, each rank sending at most one buffer and receiving at most one

Backends: NCCL where every rank has a card of its own; gloo on the CPU,
and gloo where ranks share a card (NCCL refuses two ranks on one GPU).
The gloo transport stages CUDA tensors through host memory explicitly:
each collective copies its buffer to the host, runs there and copies
the result back. That is the transport for shared-card runs, not a
fallback: NCCL runs take CUDA tensors as they are.

all_reduce_sum is differentiable by torch.func.jvp (its tangent is
reduced by a second collective), because the source network's group
totals sum over ranks inside the residual that the Jacobian's jvps
differentiate. Every collective adds one to its count in `counts` and
its host-clock seconds (the staging copies included) to `seconds`.
"""

from __future__ import annotations

import time

import numpy as np
import torch
import torch.distributed as dist


# all_gather_into_tensor, under its newer name where torch has it
_all_gather_into_tensor = (getattr(dist, "all_gather_single", None)
                           or dist.all_gather_into_tensor)


class Comm:
    """A rank's view of the process group: rank, size, backend, the
    device its tensors live on, and the collectives."""

    def __init__(self, rank: int, size: int, backend: str,
                 device: torch.device):
        self.rank = rank
        self.size = size
        self.backend = backend
        self.device = torch.device(device)
        # gloo stages CUDA buffers through the host
        self.staged = backend == "gloo" and self.device.type == "cuda"
        self.counts = {"all_reduce": 0, "all_gather": 0, "p2p_rounds": 0}
        self.seconds = dict.fromkeys(self.counts, 0.0)

    # -- transport ----------------------------------------------------

    def _host(self, t: torch.Tensor) -> torch.Tensor:
        t = t.detach()
        return t.cpu() if self.staged else t.clone()

    def _back(self, t: torch.Tensor) -> torch.Tensor:
        return t.to(self.device) if self.staged else t

    def _all_reduce(self, x: torch.Tensor, op) -> torch.Tensor:
        t0 = time.perf_counter()
        buf = self._host(x.contiguous())
        dist.all_reduce(buf, op=op)
        out = self._back(buf)
        self._count("all_reduce", t0)
        return out

    def _count(self, kind: str, t0: float):
        self.counts[kind] += 1
        self.seconds[kind] += time.perf_counter() - t0

    # -- reductions (psum / pmax) -------------------------------------

    def all_reduce_sum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum over ranks, replicated; differentiable by
        torch.func.jvp."""
        return _AllReduceSum.apply(x, self)

    def all_reduce_max(self, x: torch.Tensor) -> torch.Tensor:
        return self._all_reduce(x, dist.ReduceOp.MAX)

    def all_reduce_any(self, x: torch.Tensor) -> torch.Tensor:
        return self._all_reduce(x.to(torch.int32), dist.ReduceOp.MAX) > 0

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """[size, *x.shape]: every rank's x, stacked in rank order."""
        t0 = time.perf_counter()
        buf = self._host(x.contiguous()).reshape((-1,) + tuple(x.shape[1:]))
        out = buf.new_empty((self.size * buf.shape[0],) + tuple(buf.shape[1:]))
        _all_gather_into_tensor(out, buf)
        out = self._back(out.reshape((self.size,) + tuple(x.shape)))
        self._count("all_gather", t0)
        return out

    # -- halo exchange ------------------------------------------------

    def exchange(self, x: torch.Tensor, routes: "HaloRoutes") -> torch.Tensor:
        """x with its halo slots refilled from their owners: one
        batch_isend_irecv per round of the edge-coloured neighbour
        graph (PetscSF DMGlobalToLocal)."""
        out = x
        for send_to, send_idx, recv_from, recv_idx in routes.rounds:
            t0 = time.perf_counter()
            ops = []
            rbuf = None
            if send_to is not None:
                sbuf = self._host(x[send_idx])
                ops.append(dist.P2POp(dist.isend, sbuf, send_to))
            if recv_from is not None:
                rbuf = x.new_empty((len(recv_idx),) + tuple(x.shape[1:]),
                                   device="cpu" if self.staged else x.device)
                ops.append(dist.P2POp(dist.irecv, rbuf, recv_from))
            if ops:
                for req in dist.batch_isend_irecv(ops):
                    req.wait()
            if rbuf is not None:
                if out is x:
                    out = x.clone()
                out[recv_idx] = self._back(rbuf)
            self._count("p2p_rounds", t0)
        return out

    def barrier(self):
        dist.barrier()


class HaloRoutes:
    """One rank's point-to-point rounds from a PartitionPlan: per round,
    (destination rank or None, local slots to send, source rank or
    None, halo slots to fill), pad entries dropped."""

    def __init__(self, plan, rank: int, device):
        self.rounds = []
        for r, perm in enumerate(plan.p2p_perms):
            send_to = next((d for s, d in perm if s == rank), None)
            recv_from = next((s for s, d in perm if d == rank), None)
            send_idx = recv_idx = None
            if send_to is not None:
                k = int(np.sum(plan.p2p_recv[send_to, r] < plan.n_local))
                send_idx = torch.as_tensor(
                    plan.p2p_send[rank, r, :k].astype(np.int64),
                    device=device)
            if recv_from is not None:
                rec = plan.p2p_recv[rank, r]
                recv_idx = torch.as_tensor(
                    rec[rec < plan.n_local].astype(np.int64), device=device)
            self.rounds.append((send_to, send_idx, recv_from, recv_idx))


class _AllReduceSum(torch.autograd.Function):
    """all_reduce(SUM) whose forward-mode derivative is the sum of the
    tangents: psum is linear. Under vmap (the Jacobian's batched seeds)
    the batched tensor is reduced whole: the sum is elementwise."""

    @staticmethod
    def forward(x, comm):
        return comm._all_reduce(x, dist.ReduceOp.SUM)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.comm = inputs[1]

    @staticmethod
    def jvp(ctx, x_t, _comm_t):
        return _AllReduceSum.apply(x_t, ctx.comm)

    @staticmethod
    def vmap(info, in_dims, x, comm):
        return comm._all_reduce(x, dist.ReduceOp.SUM), in_dims[0]

    @staticmethod
    def backward(ctx, grad, *_):
        return ctx.comm._all_reduce(grad, dist.ReduceOp.SUM), None


def backend_for(devices) -> str:
    """nccl where every rank has a CUDA device of its own, else gloo
    (the CPU, or ranks sharing a card)."""
    devs = [torch.device(d) for d in devices]
    if all(d.type == "cuda" for d in devs) and \
            len({d.index for d in devs}) == len(devs):
        return "nccl"
    return "gloo"


def resolve_devices(num_devices: int, device=None,
                    devices=None) -> list:
    """The device of each rank: `devices` as given (a device may repeat:
    ranks then share it); else num_devices CPU ranks for device "cpu";
    else one CUDA card per rank, an error where there are fewer cards
    than ranks."""
    if devices is not None:
        if len(devices) < num_devices:
            raise ValueError(
                f"given {len(devices)} devices, needs {num_devices}")
        return [torch.device(d) for d in devices[:num_devices]]
    if device is not None and torch.device(device).type == "cpu":
        return [torch.device("cpu")] * num_devices
    avail = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if avail < num_devices:
        raise ValueError(
            f"a run over {num_devices} devices needs {num_devices} CUDA "
            f"devices but {avail} are available (pass devices= to share "
            f"a card, or device='cpu')")
    return [torch.device("cuda", i) for i in range(num_devices)]

