// Stream kernel for measuring device-memory bandwidth:
//
//   out[i] = 0.999999f * x[i]      over a contiguous f32 array.
//
// Replaces the Pallas TPU kernel of bench.py:measure_bandwidth (kern,
// launched by stream at bench.py:312-324), which read and wrote (8, 65,536)
// tiles of an [8, 8Mi] f32 array through VMEM. Chained launches over arrays
// far larger than the 50 MB L2, timed by the slope between two chain
// lengths, give bytes moved (one read + one write per element) over time.
// The launch is opaque to the framework, so no chain can be folded away.
//
// What bounds it: memory only, 8 bytes moved per element and one multiply;
// the least time is n * 8 bytes / 3.35 TB/s on an H100 SXM.
//
// What the design does about it: 16-byte vector loads and stores (float4),
// so a warp moves 512 contiguous bytes per instruction, and a grid-stride
// loop over a grid of up to 2^20 blocks of 256 threads, so that at the
// bench's size ([8, 8Mi] f32) every thread moves one float4 and the whole
// array is in flight at once (on the card a grid capped at a few blocks
// per SM moved fewer bytes per second, and streaming cache hints did not
// help, so the loads and stores are plain). A scalar loop takes the tail
// (n % 4) and pointers not 16-byte aligned.

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
                    int64_t start, int64_t n) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = start + (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    out[i] = x[i] * STREAM_SCALE;
  }
}

static unsigned int grid_for(int64_t work, int threads) {
  // one element per thread up to 2^28 threads; the grid-stride loop takes
  // the rest
  const int64_t cap = (int64_t)1 << 20;
  int64_t blocks = (work + threads - 1) / threads;
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  return (unsigned int)blocks;
}

// x and out: n contiguous f32 values on the current device. Launches on
// `stream` and returns cudaGetLastError() (0 on success); does not
// synchronise.
extern "C" int stream_scale_f32(const float* x, float* out, int64_t n,
                                void* stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  const int threads = 256;
  cudaStream_t s = (cudaStream_t)stream;
  const bool aligned =
      (((uintptr_t)x | (uintptr_t)out) & (uintptr_t)15) == 0;
  int64_t done = 0;
  if (aligned) {
    const int64_t n4 = n / 4;
    if (n4 > 0) {
      stream_scale_vec4<<<grid_for(n4, threads), threads, 0, s>>>(
          (const float4*)x, (float4*)out, n4);
      cudaError_t e = cudaGetLastError();
      if (e != cudaSuccess) return (int)e;
    }
    done = n4 * 4;
  }
  if (done < n) {
    stream_scale_scalar<<<grid_for(n - done, threads), threads, 0, s>>>(
        x, out, done, n);
  }
  return (int)cudaGetLastError();
}
