// Block-banded SpMV for the Krylov solve of the implicit timestep.
//
//   y[i, r] = sum_k sum_c bands[k, r*b + c, i] * x[i + d_k, c]
//
// with x taken as zero outside [0, n). f32 or f64 (one instantiation each),
// b x b blocks with b in 1..4, at most 16 band offsets d_k (DiaOffsets,
// passed by value).
//
// Replaces the Pallas TPU kernel waiwera_tpu/ops/dia.py:_dia_kernel8
// (launched by _pallas_matvec8_il). The TPU kernel interleaved 8 cells per
// sublane, padded n to a multiple of 2048 and streamed x windows through
// VMEM with BlockSpecs; none of that is needed here. This kernel reads the
// element-major band layout [D, b*b, N] of the JAX package's DIAMatrix
// directly, and x and y in their natural [n, b] layout. The f64
// instantiation stands in for the JAX package's f64 path (jnp_matvec,
// waiwera_tpu/ops/dia.py:536), which the TPU kernel never took.
//
// What bounds it: memory. Each row reads D*b*b band values once and writes
// b values, and x is read D times from neighbouring rows (mostly from L2):
// about (D*b*b + 2*b) * sizeof(T) bytes per row, ~147 MB per f32 call at the
// flagship size (b = 3, D = 7, n = 532,480), i.e. ~44 us at the H100's
// 3.35 TB/s, and twice that in f64. Arithmetic is D*b*b FMAs per row, far
// below the card's float and double rates.
//
// What the design does about it: one thread per row, so consecutive
// threads read consecutive addresses of every band plane (fully coalesced
// 128-byte transactions); the b accumulators of a row stay in registers;
// the b values of x at a shifted row are read once and reused by all b
// output rows of the block; bands are read through the read-only path.
// Nothing is staged in shared memory: the band stream has no reuse, and
// the x reuse across bands (offsets +-1, +-nx, +-nx*ny) is served by L2.

#include <cuda_runtime.h>
#include <stdint.h>

struct DiaOffsets {
  int d[16];
};

__device__ __forceinline__ float fma_t(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ double fma_t(double a, double b, double c) {
  return fma(a, b, c);
}

template <typename T, int B>
__global__ void __launch_bounds__(256)
dia_spmv_kernel(const T* __restrict__ bands, const T* __restrict__ x,
                T* __restrict__ y, DiaOffsets offs, int num_bands,
                int64_t n, int64_t stride) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  T acc[B];
#pragma unroll
  for (int r = 0; r < B; ++r) acc[r] = T(0);
  for (int k = 0; k < num_bands; ++k) {
    const int64_t j = i + offs.d[k];
    if (j < 0 || j >= n) continue;  // x is zero outside [0, n)
    T xj[B];
#pragma unroll
    for (int c = 0; c < B; ++c) xj[c] = __ldg(x + j * B + c);
    const T* band = bands + (int64_t)k * (B * B) * stride + i;
#pragma unroll
    for (int r = 0; r < B; ++r) {
#pragma unroll
      for (int c = 0; c < B; ++c) {
        acc[r] = fma_t(__ldg(band + (int64_t)(r * B + c) * stride), xj[c],
                       acc[r]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < B; ++r) y[i * B + r] = acc[r];
}

template <typename T>
static int launch(const T* bands, const T* x, T* y, DiaOffsets offs,
                  int num_bands, int block_size, int64_t n, int64_t stride,
                  void* stream) {
  if (num_bands < 1 || num_bands > 16 || n < 0 || stride < n)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  const int threads = 256;
  const unsigned int blocks = (unsigned int)((n + threads - 1) / threads);
  cudaStream_t s = (cudaStream_t)stream;
  switch (block_size) {
    case 1:
      dia_spmv_kernel<T, 1><<<blocks, threads, 0, s>>>(bands, x, y, offs,
                                                       num_bands, n, stride);
      break;
    case 2:
      dia_spmv_kernel<T, 2><<<blocks, threads, 0, s>>>(bands, x, y, offs,
                                                       num_bands, n, stride);
      break;
    case 3:
      dia_spmv_kernel<T, 3><<<blocks, threads, 0, s>>>(bands, x, y, offs,
                                                       num_bands, n, stride);
      break;
    case 4:
      dia_spmv_kernel<T, 4><<<blocks, threads, 0, s>>>(bands, x, y, offs,
                                                       num_bands, n, stride);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// bands: [num_bands, b*b, stride] (stride >= n), x and y: [n, b], all of one
// type, contiguous on the current device. Launches on `stream` and returns
// cudaGetLastError() (0 on success); does not synchronise.
extern "C" int dia_spmv_f32(const float* bands, const float* x, float* y,
                            DiaOffsets offs, int num_bands, int block_size,
                            int64_t n, int64_t stride, void* stream) {
  return launch<float>(bands, x, y, offs, num_bands, block_size, n, stride,
                       stream);
}

extern "C" int dia_spmv_f64(const double* bands, const double* x, double* y,
                            DiaOffsets offs, int num_bands, int block_size,
                            int64_t n, int64_t stride, void* stream) {
  return launch<double>(bands, x, y, offs, num_bands, block_size, n, stride,
                        stream);
}
