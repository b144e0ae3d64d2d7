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
// piCholesky path: for each λ solve L(λ) L(λ)^T θ = g where every
// off-diagonal tile of L(λ) is Horner-evaluated from the (r+1) packed
// coefficient tiles of Θ on the fly.  Nothing of L(λ) is written to device
// memory.  The diagonal tiles are Horner-evaluated and inverted outside the
// kernel, as at poly_interp.py:247-255.
//
// The TPU version walks a sequential (λ, row, column) grid and revisits its
// output ref as solved state; CUDA blocks run in no order, so here one block
// per (λ, fold, RHS column) runs both sweeps in one loop and keeps the whole
// solution vector in shared memory: the forward sweep L w = g writes w, the
// reverse sweep L^T θ = w overwrites it in place tile by tile (tile i of w
// is read before θ_i replaces it; θ_t for t > i is final when read).  The
// reverse sweep reads column i of packed L as row i of L^T.  The
// (row, column) -> packed tile map is passed in as an int32 tensor.
//
// Bound on this card: bytes (Θ is read once per λ per sweep; L2 shares
// the reads of the λs of one fold that run together) against about 2r+2
// flops per coefficient value.  Reads are coalesced: a warp walks a tile
// row in the forward sweep, consecutive threads walk consecutive columns in
// the reverse sweep.

#include "common.cuh"

template <typename T>
__global__ void __launch_bounds__(kThreads)
interp_solve_kernel(const T* __restrict__ theta, const T* __restrict__ x,
                    const T* __restrict__ inv, const T* __restrict__ g,
                    const int* __restrict__ pmap, T* __restrict__ out,
                    int n_lam, int degree, int nt, int B, long long P,
                    int nrhs, int g_per_lam) {
  extern __shared__ unsigned char smem_raw[];
  const int hp = nt * B;
  T* w = reinterpret_cast<T*>(smem_raw);   // (hp,) solution in progress
  T* rhs = w + hp;                         // (B,)
  T* red = rhs + B;                        // (kThreads,)
  const int lam = blockIdx.x;
  const long long fold = blockIdx.y;
  const int col = blockIdx.z;
  const T xv = x[lam];
  const T* TH = theta + fold * (degree + 1) * P;
  const long long tile = (long long)B * B;
  const T* INV = inv + (fold * n_lam + lam) * nt * tile;
  const T* G = g + (g_per_lam ? (fold * n_lam + lam) : fold) * hp * nrhs;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  constexpr int kWarps = kThreads / 32;
  const int nph = kThreads / B;
  const int rr = tid % B, ph = tid / B;

  auto horner = [&](long long off) {
    T v = TH[degree * P + off];
    for (int k = degree - 1; k >= 0; --k) v = v * xv + TH[k * P + off];
    return v;
  };

  // forward sweep: L w = g
  for (int i = 0; i < nt; ++i) {
    for (int r = warp; r < B; r += kWarps) {
      T s = T(0);
      for (int t = 0; t < i; ++t) {
        const long long base = (long long)pmap[i * nt + t] * tile + (long long)r * B;
        for (int c = lane; c < B; c += 32) s += horner(base + c) * w[t * B + c];
      }
      s = warp_sum(s);
      if (lane == 0) rhs[r] = G[(long long)(i * B + r) * nrhs + col] - s;
    }
    __syncthreads();
    for (int r = warp; r < B; r += kWarps) {
      const T* iv = INV + (long long)i * tile + (long long)r * B;
      T s = T(0);
      for (int c = lane; c < B; c += 32) s += iv[c] * rhs[c];
      s = warp_sum(s);
      if (lane == 0) w[i * B + r] = s;
    }
    __syncthreads();
  }

  // reverse sweep: L^T θ = w, in place
  for (int i = nt - 1; i >= 0; --i) {
    T s = T(0);
    if (ph < nph)
      for (int t = i + 1; t < nt; ++t) {
        const long long base = (long long)pmap[t * nt + i] * tile + rr;
        for (int c = ph; c < B; c += nph) s += horner(base + (long long)c * B) * w[t * B + c];
      }
    red[tid] = s;
    __syncthreads();
    if (tid < B) {
      T acc = T(0);
      for (int q = 0; q < nph; ++q) acc += red[q * B + tid];
      rhs[tid] = w[i * B + tid] - acc;
    }
    __syncthreads();
    s = T(0);
    if (ph < nph)
      for (int q = ph; q < B; q += nph) s += INV[(long long)i * tile + (long long)q * B + rr] * rhs[q];
    red[tid] = s;
    __syncthreads();
    if (tid < B) {
      T acc = T(0);
      for (int q = 0; q < nph; ++q) acc += red[q * B + tid];
      w[i * B + tid] = acc;
    }
    __syncthreads();
  }

  T* O = out + ((fold * n_lam + lam) * hp) * nrhs;
  for (int r = tid; r < hp; r += kThreads) O[(long long)r * nrhs + col] = w[r];
}

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

template <typename T>
static int interp_solve(const void* theta, const void* x, const void* inv,
                        const void* g, const void* pmap, void* out, int n_fold,
                        int n_lam, int degree, int nt, int B, long long P,
                        int nrhs, int g_per_lam, void* stream) {
  if (B > kThreads || n_fold > 65535 || nrhs > 65535)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(nt * B + B + kThreads) * sizeof(T);
  cudaFuncSetAttribute(interp_solve_kernel<T>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  RT_RETURN_IF_ERROR();
  interp_solve_kernel<T><<<dim3(n_lam, n_fold, nrhs), kThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(theta), static_cast<const T*>(x),
      static_cast<const T*>(inv), static_cast<const T*>(g),
      static_cast<const int*>(pmap), static_cast<T*>(out), n_lam, degree, nt,
      B, P, nrhs, g_per_lam);
  RT_RETURN_IF_ERROR();
  return 0;
}

extern "C" {
// theta: (n_fold, degree+1, P); x: (n_lam,) λ - center; inv: (n_fold, n_lam,
// nt, B, B) inverted diagonal tiles; g: (n_fold, [n_lam,] hp, nrhs);
// pmap: (nt, nt) packed tile index; out: (n_fold, n_lam, hp, nrhs).
int rt_interp_solve_f64(const void* theta, const void* x, const void* inv,
                        const void* g, const void* pmap, void* out, int n_fold,
                        int n_lam, int degree, int nt, int B, long long P,
                        int nrhs, int g_per_lam, void* stream) {
  return interp_solve<double>(theta, x, inv, g, pmap, out, n_fold, n_lam,
                              degree, nt, B, P, nrhs, g_per_lam, stream);
}
int rt_interp_solve_f32(const void* theta, const void* x, const void* inv,
                        const void* g, const void* pmap, void* out, int n_fold,
                        int n_lam, int degree, int nt, int B, long long P,
                        int nrhs, int g_per_lam, void* stream) {
  return interp_solve<float>(theta, x, inv, g, pmap, out, n_fold, n_lam,
                             degree, nt, B, P, nrhs, g_per_lam, stream);
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
