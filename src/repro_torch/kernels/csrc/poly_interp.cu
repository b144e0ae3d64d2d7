// Horner evaluation of the piCholesky interpolant, for Hopper: into dense
// factors (interp_factors), and fused with the packed forward/back
// substitution (interp_solve).
//
// interp_factors replaces the Pallas kernel of
// src/repro/kernels/poly_interp.py:97 (body _make_kernel :48): Horner of Θ
// at every λ written straight into the dense L(λ), upper tiles zeroed.  The
// TPU version runs a (λ, i, j) grid of output tiles, reading each lower
// tile of Θ through a scalar-prefetched map, into a padded (q, hp, hp)
// buffer that is then cropped.  Here one block per (output tile, fold,
// chunk of kLamChunk λs) writes its tile of the unpadded (…, q, h, h)
// output directly, finding lower tile (i, j) of Θ at (j nt - j (j - 1) / 2
// + i - j) B^2 (no map): each thread takes 16 bytes of a tile row (one
// element where output rows are not 16-byte aligned), reads its r+1
// coefficients from the packed tile and writes its Horner values at each λ
// of the chunk.  Upper tiles and the upper half of diagonal tiles are
// written as zeros; nothing past h is written.  λ - center arrives cast to
// Θ's dtype, as at poly_interp.py:84.  Bound on this card: bytes (the q
// dense outputs dominate the r+1 coefficient reads, which the λ chunk
// shares); 2r flops per output.  Consecutive threads write consecutive
// columns, so stores are coalesced.
//
// rt_interp_factors_bf16 takes a bf16 Θ and writes bf16 factors, half the
// bytes: each Horner step runs in fp32 (__fmul_rn, __fadd_rn: never
// contracted into an FMA) and is rounded to nearest-even bf16 after the
// product and after the sum, as torch rounds each bf16 operation (and as
// the Pallas kernel computes at Θ's dtype).
//
// interp_solve replaces the Pallas kernel of src/repro/kernels/poly_interp.py:195
// (_interp_sweep, body _make_solve_kernel :109), the λ sweep of the
// piCholesky path: for each λ solve L(λ) L(λ)^T θ = g where every tile of
// L(λ) is Horner-evaluated from the (r+1) packed coefficient tiles of Θ as
// it is read.  Nothing of L(λ) is written to device memory.
//
// The TPU version walks a sequential (λ, row, column) grid and revisits its
// output ref as solved state, with the diagonal tiles Horner-evaluated and
// inverted outside the kernel (poly_interp.py:247-255).  Here the cluster
// solve of tri_solve.cuh runs both sweeps in one launch: a cluster of up to
// 8 blocks per (fold, λ, RHS column), each block owning every C-th tile row,
// right-looking updates, the solved segments passed between the blocks
// through distributed shared memory, the coefficient tiles staged by
// cp.async ahead of the barriers, and the diagonal tiles Horner-evaluated,
// identity-padded past h and inverted in the kernel's prologue.  λ - center
// arrives cast to Θ's dtype.
//
// Bound on this card: bytes (Θ is read once per λ per sweep; L2 shares the
// reads of the λs of one fold that run together) against about 2r+2 flops
// per coefficient value, and the chain of 2 nt dependent solves.
//
// rt_interp_solve_f32_bf16 is the mixed-precision variant (poly_interp.py
// under a bf16 compute dtype): Θ stays bf16 in device memory and is staged
// as bf16 by bulk copies, half the bytes of the sweep; each staged chunk
// of an off-diagonal tile is Horner-evaluated once in bf16 pairs into a
// bf16 tile (x rounded to bf16, every step rounded, :128-131), the
// diagonal tiles at float32 from Θ, inverted there (:245-255) and kept in
// bf16; λ - center, g, the sums and the solutions are float32, and every
// product runs on the bf16 tensor cores (tri_solve.cuh,
// tri_solve_mixed_kernel).

#include <cstdint>

#include "tri_solve.cuh"

constexpr int kLamChunk = 8;   // λs per interp_factors block

// The type a Horner step of Θ's dtype S is computed in (bf16: fp32)
template <typename S> struct HornerT { using type = S; };
template <> struct HornerT<__nv_bfloat16> { using type = float; };

// One Horner step v x + c at Θ's dtype: float64 and float32 as written,
// bf16 (held in fp32) rounded after the product and after the sum
template <typename S>
__device__ __forceinline__ typename HornerT<S>::type horner_step(
    typename HornerT<S>::type v, typename HornerT<S>::type x,
    typename HornerT<S>::type c) {
  if constexpr (std::is_same<S, __nv_bfloat16>::value)
    return bf16_round(__fadd_rn(bf16_round(__fmul_rn(v, x)), c));
  else
    return v * x + c;
}

// VN values at p (16 bytes, aligned, when VN > 1)
template <typename S, int VN>
__device__ __forceinline__ void load_units(S (&d)[VN], const S* p) {
  if constexpr (VN > 1) {
    using V = typename Vec16<S>::type;
    static_assert(sizeof(V) == VN * sizeof(S), "16 bytes");
    *reinterpret_cast<V*>(d) = *reinterpret_cast<const V*>(p);
  } else {
    d[0] = p[0];
  }
}
template <typename S, int VN>
__device__ __forceinline__ void store_units(S* p, const S (&d)[VN]) {
  if constexpr (VN > 1) {
    using V = typename Vec16<S>::type;
    *reinterpret_cast<V*>(p) = *reinterpret_cast<const V*>(d);
  } else {
    p[0] = d[0];
  }
}

// VN: output values a thread writes at once (16 bytes, or 1 where output
// rows are not 16-byte aligned)
template <typename S, int VN>
__global__ void __launch_bounds__(kThreads)
interp_factors_kernel(const S* __restrict__ theta, const S* __restrict__ x,
                      S* __restrict__ out, int n_lam, int degree, int nt,
                      int B, long long P, int h) {
  using F = typename HornerT<S>::type;
  const int i = blockIdx.x / nt, j = blockIdx.x % nt;
  const long long fold = blockIdx.y;
  const int lam0 = blockIdx.z * kLamChunk;
  const int n_here = min(kLamChunk, n_lam - lam0);
  const long long hh = (long long)h * h;
  S* O = out + (fold * n_lam + lam0) * hh;
  const bool lower = i >= j;
  const S* TH = theta + fold * (degree + 1) * P
                + (lower ? (long long)(j * nt - j * (j - 1) / 2 + i - j) * B * B : 0);
  F xs[kLamChunk];
#pragma unroll
  for (int t = 0; t < kLamChunk; ++t) xs[t] = t < n_here ? as_value(x[lam0 + t]) : F(0);
  const int rows = min(B, h - i * B), cols = min(B, h - j * B);
  const int units = (cols + VN - 1) / VN;       // VN divides cols when VN > 1
  for (int e = threadIdx.x; e < rows * units; e += kThreads) {
    const int r = e / units, c0 = e % units * VN;
    const long long dst = (long long)(i * B + r) * h + j * B + c0;
    if (!lower || (i == j && c0 > r)) {
      alignas(16) S w[VN];
#pragma unroll
      for (int u = 0; u < VN; ++u) w[u] = S(0.0f);
      for (int t = 0; t < n_here; ++t) store_units<S, VN>(O + t * hh + dst, w);
      continue;
    }
    const int off = r * B + c0;
    F v[kLamChunk][VN];
    alignas(16) S c[VN];
    load_units<S, VN>(c, TH + degree * P + off);
#pragma unroll
    for (int u = 0; u < VN; ++u)
#pragma unroll
      for (int t = 0; t < kLamChunk; ++t) v[t][u] = as_value(c[u]);
    for (int k = degree - 1; k >= 0; --k) {
      load_units<S, VN>(c, TH + k * P + off);
#pragma unroll
      for (int u = 0; u < VN; ++u)
#pragma unroll
        for (int t = 0; t < kLamChunk; ++t)
          v[t][u] = horner_step<S>(v[t][u], xs[t], as_value(c[u]));
    }
#pragma unroll
    for (int t = 0; t < kLamChunk; ++t) {
      if (t >= n_here) break;
      alignas(16) S w[VN];
#pragma unroll
      for (int u = 0; u < VN; ++u)
        w[u] = (i == j && c0 + u > r) ? S(0.0f) : S(v[t][u]);
      store_units<S, VN>(O + t * hh + dst, w);
    }
  }
}

template <typename S>
static int interp_factors(const void* theta, const void* x, void* out,
                          int n_fold, int n_lam, int degree, int nt, int B,
                          long long P, int h, void* stream) {
  constexpr int VN = 16 / sizeof(S);
  const int n_chunk = (n_lam + kLamChunk - 1) / kLamChunk;
  if (n_fold > 65535 || n_chunk > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid(nt * nt, n_fold, n_chunk);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const S* th = static_cast<const S*>(theta);
  S* o = static_cast<S*>(out);
  const bool vec = h % VN == 0 && (reinterpret_cast<uintptr_t>(theta) |
                                   reinterpret_cast<uintptr_t>(out)) % 16 == 0;
  if (vec)
    interp_factors_kernel<S, VN><<<grid, kThreads, 0, s>>>(
        th, static_cast<const S*>(x), o, n_lam, degree, nt, B, P, h);
  else
    interp_factors_kernel<S, 1><<<grid, kThreads, 0, s>>>(
        th, static_cast<const S*>(x), o, n_lam, degree, nt, B, P, h);
  RT_RETURN_IF_ERROR();
  return 0;
}

template <typename T, typename CT = T>
static int interp_solve(const void* theta, const void* x, const void* g,
                        void* scratch, void* out, int n_fold, int n_lam,
                        int degree, int nt, int B, long long P, int nrhs,
                        int g_per_lam, int h, int* plan, void* stream) {
  using Src = CT;      // Θ's type: bf16 for the mixed variant, else T
  SolveArgs<T, Src> a = {};
  a.src = static_cast<const Src*>(theta);
  a.x = static_cast<const T*>(x);
  a.scratch = static_cast<T*>(scratch);
  a.g = static_cast<const T*>(g);
  a.out = static_cast<T*>(out);
  a.P = P;
  a.h = h;
  a.nt = nt;
  a.nc = degree + 1;
  a.n_lam = n_lam;
  a.nrhs = nrhs;
  a.g_per_lam = g_per_lam;
  a.sweeps = 3;
  a.vec = reinterpret_cast<uintptr_t>(theta) % 16 == 0 && P % (16 / sizeof(Src)) == 0;
  if (sizeof(Src) < 4 && !a.vec) return (int)cudaErrorMisalignedAddress;
  return tri_solve_launch<T, kInterp, CT, Src>(
      a, B, (long long)n_fold * n_lam * nrhs, plan,
      static_cast<cudaStream_t>(stream));
}

extern "C" {
// theta: (n_fold, degree+1, P); x: (n_lam,) λ - center; g: (n_fold,
// [n_lam,] hp, nrhs) zero-padded past h; scratch: (n_fold * n_lam * nrhs,
// nt, B, inv_ld) for inverses that do not fit in shared memory, or null
// (then a launch that needs it returns kNeedsScratch and launches
// nothing); out: (n_fold, n_lam, hp, nrhs); plan: null, or kPlanInts ints
// that receive the launch plan (as for rt_trsm_f64).
int rt_interp_solve_f64(const void* theta, const void* x, const void* g,
                        void* scratch, void* out, int n_fold, int n_lam,
                        int degree, int nt, int B, long long P, int nrhs,
                        int g_per_lam, int h, int* plan, void* stream) {
  return interp_solve<double>(theta, x, g, scratch, out, n_fold, n_lam, degree,
                              nt, B, P, nrhs, g_per_lam, h, plan, stream);
}
int rt_interp_solve_f32(const void* theta, const void* x, const void* g,
                        void* scratch, void* out, int n_fold, int n_lam,
                        int degree, int nt, int B, long long P, int nrhs,
                        int g_per_lam, int h, int* plan, void* stream) {
  return interp_solve<float>(theta, x, g, scratch, out, n_fold, n_lam, degree,
                             nt, B, P, nrhs, g_per_lam, h, plan, stream);
}
// theta in bf16 (16-byte aligned); x, g, scratch, out float32
int rt_interp_solve_f32_bf16(const void* theta, const void* x, const void* g,
                             void* scratch, void* out, int n_fold, int n_lam,
                             int degree, int nt, int B, long long P, int nrhs,
                             int g_per_lam, int h, int* plan, void* stream) {
  return interp_solve<float, __nv_bfloat16>(theta, x, g, scratch, out, n_fold,
                                            n_lam, degree, nt, B, P, nrhs,
                                            g_per_lam, h, plan, stream);
}
// theta: (n_fold, degree+1, P); x: (n_lam,) λ - center at Θ's dtype;
// out: (n_fold, n_lam, h, h), at Θ's dtype.
int rt_interp_factors_f64(const void* theta, const void* x, void* out,
                          int n_fold, int n_lam, int degree, int nt, int B,
                          long long P, int h, void* stream) {
  return interp_factors<double>(theta, x, out, n_fold, n_lam, degree, nt, B,
                                P, h, stream);
}
int rt_interp_factors_f32(const void* theta, const void* x, void* out,
                          int n_fold, int n_lam, int degree, int nt, int B,
                          long long P, int h, void* stream) {
  return interp_factors<float>(theta, x, out, n_fold, n_lam, degree, nt, B, P,
                               h, stream);
}
// theta, x and out in bf16; each Horner step rounded to bf16
int rt_interp_factors_bf16(const void* theta, const void* x, void* out,
                           int n_fold, int n_lam, int degree, int nt, int B,
                           long long P, int h, void* stream) {
  return interp_factors<__nv_bfloat16>(theta, x, out, n_fold, n_lam, degree,
                                       nt, B, P, h, stream);
}
}
