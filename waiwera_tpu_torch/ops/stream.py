"""Device-memory bandwidth from a stream kernel (counterpart of
bench.py:measure_bandwidth).

stream_scale(x, out) computes out = 0.999999 * x over a contiguous f32
tensor: the hand-written CUDA kernel csrc/stream_scale.cu on CUDA
tensors, its plain PyTorch version (stream_scale_reference) on CPU
tensors. measure_bandwidth ping-pongs the kernel between two [8, 8Mi]
f32 buffers (256 MiB each, far above the H100's 50 MB L2) in chains of
4 and 24 launches timed with CUDA events, and returns bytes per second
from the slope between the two chain lengths, as bench.py does with its
Pallas kernel.
"""

from __future__ import annotations

import ctypes

import torch

from waiwera_tpu_torch.ops.dia import LaunchCount

SCALE = 0.999999
N_SUB = 8
N_LANE = 8 * 1024 * 1024  # 256 MiB per f32 [8, 8Mi] array

# launches of csrc/stream_scale.cu (stream_scale on CUDA tensors)
stream_scale_launches = LaunchCount()

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        from waiwera_tpu_torch.ops import cuda_build

        fn = cuda_build.load("stream_scale").stream_scale_f32
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def stream_scale_reference(x: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: out = 0.999999 * x in f32."""
    return torch.mul(x, SCALE, out=out)


def stream_scale(x: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """out = 0.999999 * x (f32, contiguous, same shape). CPU tensors take
    the plain version; CUDA tensors launch csrc/stream_scale.cu, or
    raise."""
    if x.device.type == "cpu" and out.device.type == "cpu":
        return stream_scale_reference(x, out)
    if x.device.type != "cuda" or out.device != x.device:
        raise ValueError(
            f"stream_scale: x on {x.device}, out on {out.device}; both "
            "must be on one CUDA device (or both on the CPU)"
        )
    if x.dtype != torch.float32 or out.dtype != torch.float32:
        raise TypeError(f"stream_scale is f32 only (x {x.dtype}, "
                        f"out {out.dtype})")
    if x.shape != out.shape:
        raise ValueError(f"stream_scale: shapes {tuple(x.shape)} and "
                         f"{tuple(out.shape)} differ")
    if not (x.is_contiguous() and out.is_contiguous()):
        raise ValueError("stream_scale: x and out must be contiguous")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _kernel()(x.data_ptr(), out.data_ptr(), x.numel(), stream)
    if rc != 0:
        raise RuntimeError(f"stream_scale_f32 launch failed: CUDA error {rc}")
    stream_scale_launches.count += 1
    return out


def chain_seconds(fn, k: int, reps: int = 3) -> float:
    """Best of `reps` CUDA-event timings of k chained calls of fn(i), in
    seconds (one warm-up chain first)."""
    for i in range(k):
        fn(i)
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(k):
            fn(i)
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / 1e3)
    return best


def measure_bandwidth(device="cuda") -> float:
    """Device-memory bandwidth in bytes/s: stream_scale ping-ponged
    between two [8, 8Mi] f32 buffers, one read and one write of 256 MiB
    per launch, from the slope between chains of 4 and 24 launches (best
    of 3 each; the slope cancels a chain's fixed cost). Needs a CUDA
    device."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"measure_bandwidth needs a CUDA device, not {device}")
    bufs = [torch.ones((N_SUB, N_LANE), dtype=torch.float32, device=device),
            torch.empty((N_SUB, N_LANE), dtype=torch.float32, device=device)]

    def step(i):
        stream_scale(bufs[i % 2], bufs[(i + 1) % 2])

    per = (chain_seconds(step, 24) - chain_seconds(step, 4)) / 20
    if per <= 0.0:
        raise RuntimeError(f"stream chain slope {per:.3e} s is not positive")
    return 2.0 * 4.0 * N_SUB * N_LANE / per
