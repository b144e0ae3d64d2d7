// Helpers shared by the port's CUDA kernels (compiled into each library).
#pragma once

#include <cuda_runtime.h>

#define RT_RETURN_IF_ERROR()                         \
  do {                                               \
    cudaError_t _e = cudaGetLastError();             \
    if (_e != cudaSuccess) return (int)_e;           \
  } while (0)

constexpr int kThreads = 256;

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// One TS x TS tile of C = beta * C + alpha * P Q^T over depth K, computed by
// a block of kThreads threads (16 x 16, each thread owning a strided RM x RM
// patch).  P and Q are row-major with the depth index contiguous (leading
// dims ldp, ldq); K must be a multiple of KC.  Operand slices are staged
// through shared memory KC columns at a time.
template <typename T, int TS>
__device__ void gemm_nt_tile(const T* __restrict__ P, int ldp,
                             const T* __restrict__ Q, int ldq, int K,
                             T* C, int ldc, T alpha, bool accumulate) {
  constexpr int KC = 16;
  constexpr int RM = TS / 16;
  __shared__ T sP[KC][TS + 1];
  __shared__ T sQ[KC][TS + 1];
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  T acc[RM][RM];
#pragma unroll
  for (int a = 0; a < RM; ++a)
#pragma unroll
    for (int b = 0; b < RM; ++b) acc[a][b] = T(0);

  for (int k0 = 0; k0 < K; k0 += KC) {
    for (int e = tid; e < TS * KC; e += kThreads) {
      const int r = e / KC, k = e % KC;
      sP[k][r] = P[(long long)r * ldp + k0 + k];
      sQ[k][r] = Q[(long long)r * ldq + k0 + k];
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < KC; ++k) {
      T pa[RM], qb[RM];
#pragma unroll
      for (int a = 0; a < RM; ++a) pa[a] = sP[k][ty + 16 * a];
#pragma unroll
      for (int b = 0; b < RM; ++b) qb[b] = sQ[k][tx + 16 * b];
#pragma unroll
      for (int a = 0; a < RM; ++a)
#pragma unroll
        for (int b = 0; b < RM; ++b) acc[a][b] += pa[a] * qb[b];
    }
    __syncthreads();
  }
#pragma unroll
  for (int a = 0; a < RM; ++a)
#pragma unroll
    for (int b = 0; b < RM; ++b) {
      T* dst = C + (long long)(ty + 16 * a) * ldc + (tx + 16 * b);
      *dst = accumulate ? *dst + alpha * acc[a][b] : alpha * acc[a][b];
    }
}
