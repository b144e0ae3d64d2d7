// Helpers shared by the port's CUDA kernels (compiled into each library).
#pragma once

#include <cuda_runtime.h>

#define RT_RETURN_IF_ERROR()                         \
  do {                                               \
    cudaError_t _e = cudaGetLastError();             \
    if (_e != cudaSuccess) return (int)_e;           \
  } while (0)

constexpr int kThreads = 256;

// the 16-byte vector of T (one load or store of 16 bytes a thread)
template <typename T> struct Vec16;
template <> struct Vec16<double> { using type = double2; };
template <> struct Vec16<float> { using type = float4; };

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}
