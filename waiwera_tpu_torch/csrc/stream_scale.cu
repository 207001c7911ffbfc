// Stream kernel for measuring device-memory bandwidth:
//
//   out[i] = 0.999999f * x[i]      over a contiguous f32 array.
//
// Replaces the Pallas TPU kernel of bench.py:measure_bandwidth (kern,
// launched by stream at bench.py:309-324), which read and wrote (8, 65,536)
// tiles of an [8, 8Mi] f32 array through VMEM. Chained launches over arrays
// far larger than the 50 MB L2, timed by the slope between two chain
// lengths, give bytes moved (one read + one write per element) over time.
// The launch is opaque to the framework, so no chain can be folded away.
//
// What bounds it: memory only, 8 bytes moved per element and one multiply;
// the least time is n * 8 bytes / 3.35 TB/s on an H100 SXM.
//
// What the design does about it: 16-byte vector loads and stores (float4),
// so a warp moves 512 contiguous bytes per instruction, over a grid of up
// to 2^20 blocks of 256 threads, so that at the bench's size ([8, 8Mi] f32)
// every thread moves one float4 (a grid-stride loop takes larger arrays).
// The block scheduler hands out these short-lived blocks in address order,
// so the bytes in flight at any moment form one narrow window that sweeps
// the array. On an H100 that order is what reaches the card's copy rate.
// A persistent bulk-copy ring (one block per SM streaming tiles through
// shared memory with cp.async.bulk and mbarriers), timed against this
// kernel in turns in an experiment kept out of the tree, was slower when
// each block took a contiguous range (132 windows), slower by less when
// the tiles were dealt round-robin to the blocks (the SMs drift apart, and
// the window widens), and only tied it when an atomic ticket handed the tiles
// out in address order (PERF.md, Findings); nor did a capped grid or
// streaming cache hints help.
// The wrapper (ops/stream.py stream_plan) hands this kernel the 16-byte
// aligned body and the scalar kernel a head and a tail of at most 3
// elements each, or the whole array where x and out differ in alignment
// modulo 16 bytes.

#include <cuda_runtime.h>
#include <stdint.h>

#define STREAM_SCALE 0.999999f

__global__ void __launch_bounds__(256)
stream_scale_vec4(const float4* __restrict__ x, float4* __restrict__ out,
                  int64_t n4) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n4;
       i += stride) {
    float4 v = x[i];
    v.x *= STREAM_SCALE;
    v.y *= STREAM_SCALE;
    v.z *= STREAM_SCALE;
    v.w *= STREAM_SCALE;
    out[i] = v;
  }
}

__global__ void __launch_bounds__(256)
stream_scale_scalar(const float* __restrict__ x, float* __restrict__ out,
                    int64_t n) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    out[i] = x[i] * STREAM_SCALE;
  }
}

static unsigned int grid_for(int64_t work) {
  // one item per thread up to 2^28 threads; the grid-stride loop takes
  // the rest
  const int64_t cap = (int64_t)1 << 20;
  int64_t blocks = (work + 255) / 256;
  if (blocks > cap) blocks = cap;
  return (unsigned int)blocks;
}

// The vector kernel: x and out 16-byte aligned and n a multiple of 4 (else
// cudaErrorInvalidValue), on the current device. Launches on `stream` and
// returns cudaGetLastError() (0 on success); does not synchronise.
extern "C" int stream_scale_vec4_f32(const float* x, float* out, int64_t n,
                                     void* stream) {
  if (n < 0 || n % 4 != 0 ||
      (((uintptr_t)x | (uintptr_t)out) & (uintptr_t)15) != 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (n == 0) return (int)cudaSuccess;
  stream_scale_vec4<<<grid_for(n / 4), 256, 0, (cudaStream_t)stream>>>(
      (const float4*)x, (float4*)out, n / 4);
  return (int)cudaGetLastError();
}

// The scalar kernel, for the vector kernel's head and tail and for arrays
// whose x and out differ in alignment modulo 16 bytes: n f32 values on the
// current device. Launches on `stream`; returns cudaGetLastError().
extern "C" int stream_scale_scalar_f32(const float* x, float* out, int64_t n,
                                       void* stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  stream_scale_scalar<<<grid_for(n), 256, 0, (cudaStream_t)stream>>>(x, out,
                                                                      n);
  return (int)cudaGetLastError();
}
