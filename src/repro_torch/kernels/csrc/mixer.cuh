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

// --- the fused scan's math (ssm_scan.cu and its backward, ssm_scan_bwd.cu)

constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// softplus and silu of the mixer entry, written for the FMA pipe and two
// MUFU operations each (ex2 and a reciprocal), not the math library's
// expf, log1pf and IEEE division, which made the mixer entry ~15% slower on
// this card (scripts/probe_ssm_scan.py, variant "libm").  softplus(v) =
// max(v, 0) + log1p(u), u = exp(-|v|) in (0, 1], with log1p(u) = 2 atanh(s),
// s = u / (2 + u) <= 1/3, its series to s^15 (truncation ~1e-9 relative);
// both agree with torch's to a few float32 ulps, far below the bf16
// rounding that follows.
// softplus(v) given u = exp(-|v|) (the backward forms sigmoid(v) from the
// same u)
__device__ __forceinline__ float softplus_of(float v, float u) {
  const float s = __fdividef(u, 2.f + u), s2 = s * s;
  float q = 1.f / 15;
  q = fmaf(q, s2, 1.f / 13);
  q = fmaf(q, s2, 1.f / 11);
  q = fmaf(q, s2, 1.f / 9);
  q = fmaf(q, s2, 1.f / 7);
  q = fmaf(q, s2, 1.f / 5);
  q = fmaf(q, s2, 1.f / 3);
  q = fmaf(q, s2, 1.f);
  return fmaxf(v, 0.f) + 2.f * s * q;
}
__device__ __forceinline__ float softplus_fast(float v) {
  return softplus_of(v, __expf(-fabsf(v)));
}
__device__ __forceinline__ float silu_fast(float v) {
  return __fdividef(v, 1.f + __expf(-v));
}
