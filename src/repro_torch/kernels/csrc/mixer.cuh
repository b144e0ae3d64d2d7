// The Mamba-1 mixer's activation-type helpers, shared by ssm_scan.cu and
// causal_conv1d.cu.  T, the activation type, is float or __nv_bfloat16; it
// is read as float32, and each op is rounded back to T as torch rounds an
// op on a bf16 tensor (computed in float32, rounded to nearest even).
#pragma once

#include <cuda_bf16.h>

#include "common.cuh"

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
// v rounded to T, as float32
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f32(from_f32<T>(v));
}

// torch's silu in float32, written as PyTorch's CUDA kernel writes it: the
// math library's expf (not ex2.approx) and an IEEE division, so that a
// value rounded to bf16 afterwards lands where torch's lands.
__device__ __forceinline__ float silu_f32(float v) {
  return v / (1.f + expf(-v));
}

// n values of T, n * sizeof(T) bytes at an address aligned to that size,
// as one load or store
template <typename T, int n>
struct alignas(n * sizeof(T)) Packed {
  T e[n];
};
template <typename T, int n>
__device__ __forceinline__ void load_packed(const T* src, float (&v)[n]) {
  const Packed<T, n> pk = *reinterpret_cast<const Packed<T, n>*>(src);
#pragma unroll
  for (int i = 0; i < n; ++i) v[i] = to_f32(pk.e[i]);
}
template <typename T, int n>
__device__ __forceinline__ void store_packed(T* dst, const float (&v)[n]) {
  Packed<T, n> pk;
#pragma unroll
  for (int i = 0; i < n; ++i) pk.e[i] = from_f32<T>(v[i]);
  *reinterpret_cast<Packed<T, n>*>(dst) = pk;
}
