"""Device-memory bandwidth from a stream kernel (counterpart of
bench.py:measure_bandwidth).

stream_scale(x, out) computes out = 0.999999 * x over a contiguous f32
tensor: the hand-written CUDA kernels of csrc/stream_scale.cu on CUDA
tensors, its plain PyTorch version (stream_scale_reference) on CPU
tensors. On the card the array is cut by stream_plan: the 16-byte
aligned body goes to the vector kernel (one float4 per thread over a
grid of short-lived blocks), a head and a tail of at most 3 elements
each to the scalar kernel, which also takes the whole array where x and
out differ in alignment modulo 16 bytes. measure_bandwidth ping-pongs
the kernel between two [8, 8Mi] f32 buffers (256 MiB each, far above
the H100's 50 MB L2) in chains of 4 and 24 launches timed with CUDA
events, and returns bytes per second from the slope between the two
chain lengths, as bench.py does with its Pallas kernel.
"""

from __future__ import annotations

import ctypes

import torch

from waiwera_tpu_torch.ops.dia import LaunchCount

SCALE = 0.999999
N_SUB = 8
N_LANE = 8 * 1024 * 1024  # 256 MiB per f32 [8, 8Mi] array
ALIGN = 16  # bytes: float4 loads and stores need aligned addresses
ITEM = 4  # bytes per f32

# launches of the vector kernel (stream_scale_vec4_f32), the bench path's
stream_scale_launches = LaunchCount()
# launches of the scalar kernel (stream_scale_scalar_f32): heads, tails and
# arrays whose x and out differ in alignment
stream_scalar_launches = LaunchCount()

_fns: dict = {}


def _kernel(name):
    fn = _fns.get(name)
    if fn is None:
        from waiwera_tpu_torch.ops import cuda_build

        fn = getattr(cuda_build.load("stream_scale"), name)
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def stream_plan(x_ptr: int, out_ptr: int, n: int) -> list:
    """How stream_scale cuts n f32 values at byte addresses x_ptr and
    out_ptr: [(kernel, start, stop)] element ranges in order, kernel
    "vec4" for the body (both addresses 16-byte aligned, a multiple of 4
    elements) and "scalar" for a head and a tail of at most 3 elements
    each, or for the whole array where the two addresses differ modulo
    16 bytes."""
    if n <= 0:
        return []
    if (x_ptr - out_ptr) % ALIGN:
        return [("scalar", 0, n)]
    head = min(n, (-x_ptr % ALIGN) // ITEM)
    body = (n - head) // 4 * 4
    plan = [("scalar", 0, head), ("vec4", head, head + body),
            ("scalar", head + body, n)]
    return [p for p in plan if p[2] > p[1]]


def stream_scale_reference(x: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: out = 0.999999 * x in f32."""
    return torch.mul(x, SCALE, out=out)


def stream_scale(x: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """out = 0.999999 * x (f32, contiguous, same shape). CPU tensors take
    the plain version; CUDA tensors launch csrc/stream_scale.cu's kernels
    as stream_plan cuts the array, or raise."""
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
    x_ptr, out_ptr = x.data_ptr(), out.data_ptr()
    plan = stream_plan(x_ptr, out_ptr, x.numel())
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        for kind, start, stop in plan:
            name = f"stream_scale_{kind}_f32"
            rc = _kernel(name)(x_ptr + ITEM * start, out_ptr + ITEM * start,
                               stop - start, stream)
            if rc != 0:
                raise RuntimeError(f"{name} launch failed: CUDA error {rc}")
            count = (stream_scale_launches if kind == "vec4"
                     else stream_scalar_launches)
            count.count += 1
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
