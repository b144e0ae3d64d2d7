// Horner evaluation of the piCholesky interpolant, for Hopper: into dense
// factors (interp_factors), and fused with the packed forward/back
// substitution (interp_solve).
//
// interp_factors replaces the Pallas kernel of
// src/repro/kernels/poly_interp.py:97 (body _make_kernel :48): Horner of Θ
// at every λ written straight into the dense L(λ), upper tiles zeroed.  The
// TPU version runs a (λ, i, j) grid of output tiles into a padded
// (q, hp, hp) buffer that is then cropped.  Here one block per (output tile,
// fold, chunk of kLamChunk λs) writes its tile of the unpadded (…, q, h, h)
// output directly: each thread takes one element of the tile, reads its
// r+1 coefficients from the packed tile of Θ (through the int32 (nt, nt)
// map) and writes its Horner value at each λ of the chunk.  Upper tiles and
// the upper half of diagonal tiles are written as zeros; nothing past h is
// written.  λ - center arrives cast to Θ's dtype, as at poly_interp.py:84.
// Bound on this card: bytes (the q dense outputs dominate the r+1
// coefficient reads, which the λ chunk shares); 2r flops per output.
// Consecutive threads write consecutive columns, so stores are coalesced.
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
// as bf16, half the bytes of the sweep; each off-diagonal tile is
// Horner-evaluated in bf16 as it streams (x rounded to bf16, every step
// rounded, :128-131), the diagonal tiles at float32 from Θ and inverted
// there (:245-255); λ - center, g, the sums and the solutions are float32,
// and every product runs on the bf16 tensor cores (tri_solve.cuh, CT =
// bf16).

#include <cstdint>

#include "tri_solve.cuh"

constexpr int kLamChunk = 8;   // λs per interp_factors block

template <typename T>
__global__ void __launch_bounds__(kThreads)
interp_factors_kernel(const T* __restrict__ theta, const T* __restrict__ x,
                      const int* __restrict__ pmap, T* __restrict__ out,
                      int n_lam, int degree, int nt, int B, long long P, int h) {
  const int i = blockIdx.x / nt, j = blockIdx.x % nt;
  const long long fold = blockIdx.y;
  const int lam0 = blockIdx.z * kLamChunk;
  const int n_here = min(kLamChunk, n_lam - lam0);
  const long long hh = (long long)h * h;
  T* O = out + (fold * n_lam + lam0) * hh;
  const T* TH = theta + fold * (degree + 1) * P
                + (long long)pmap[i * nt + j] * B * B;
  const int rows = min(B, h - i * B), cols = min(B, h - j * B);
  for (int e = threadIdx.x; e < rows * cols; e += kThreads) {
    const int r = e / cols, c = e % cols;
    const long long dst = (long long)(i * B + r) * h + j * B + c;
    if (i < j || (i == j && c > r)) {
      for (int t = 0; t < n_here; ++t) O[t * hh + dst] = T(0);
      continue;
    }
    const int off = r * B + c;
    for (int t = 0; t < n_here; ++t) {
      const T xv = x[lam0 + t];
      T v = TH[degree * P + off];
      for (int k = degree - 1; k >= 0; --k) v = v * xv + TH[k * P + off];
      O[t * hh + dst] = v;
    }
  }
}

template <typename T>
static int interp_factors(const void* theta, const void* x, const void* pmap,
                          void* out, int n_fold, int n_lam, int degree, int nt,
                          int B, long long P, int h, void* stream) {
  const int n_chunk = (n_lam + kLamChunk - 1) / kLamChunk;
  if (n_fold > 65535 || n_chunk > 65535) return (int)cudaErrorInvalidValue;
  interp_factors_kernel<T><<<dim3(nt * nt, n_fold, n_chunk), kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(theta), static_cast<const T*>(x),
      static_cast<const int*>(pmap), static_cast<T*>(out), n_lam, degree, nt,
      B, P, h);
  RT_RETURN_IF_ERROR();
  return 0;
}

template <typename T, typename CT = T>
static int interp_solve(const void* theta, const void* x, const void* g,
                        void* scratch, void* out, int n_fold, int n_lam,
                        int degree, int nt, int B, long long P, int nrhs,
                        int g_per_lam, int h, int* plan, void* stream) {
  using Src = SrcT<T, true, CT>;      // Θ's type
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
  return tri_solve_launch<T, true, CT>(a, B, (long long)n_fold * n_lam * nrhs,
                                       plan, static_cast<cudaStream_t>(stream));
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
// pmap: (nt, nt) packed tile index; out: (n_fold, n_lam, h, h).
int rt_interp_factors_f64(const void* theta, const void* x, const void* pmap,
                          void* out, int n_fold, int n_lam, int degree, int nt,
                          int B, long long P, int h, void* stream) {
  return interp_factors<double>(theta, x, pmap, out, n_fold, n_lam, degree,
                                nt, B, P, h, stream);
}
int rt_interp_factors_f32(const void* theta, const void* x, const void* pmap,
                          void* out, int n_fold, int n_lam, int degree, int nt,
                          int B, long long P, int h, void* stream) {
  return interp_factors<float>(theta, x, pmap, out, n_fold, n_lam, degree, nt,
                               B, P, h, stream);
}
}
