// Blocked triangular solve L w = g / L^T w = g on dense factors, batched
// over factors, for Hopper.
//
// Replaces the Pallas kernel of src/repro/kernels/trsm.py:102
// (solve_lower_blocked, body _make_solve_kernel :24).  The TPU version
// revisits its output ref as solved state across a sequential grid over
// tile rows; CUDA blocks run in no order, so here one block per (factor,
// RHS column) walks every tile row in a loop and holds the solved segment
// in shared memory.  Per tile row: the row panel restricted to solved
// columns times the solved segment, subtracted from g, then multiplied by
// the pre-inverted diagonal tile (inverted outside the kernel, as at
// trsm.py:89-94).  The transposed solve walks the tile rows in reverse and
// reads column i of L as row i of L^T.
//
// The factor is read unpadded (h, h); rows and columns past h are masked
// here, and the identity tail of the last diagonal inverse keeps the padded
// rows at zero.
//
// Bound on this card: bytes (the lower triangle of each factor read once
// per sweep; 2 flops per value read).  Reads are coalesced: a warp walks a
// row for the forward sweep, consecutive threads walk consecutive columns
// for the transposed one.

#include "common.cuh"

template <typename T>
__global__ void __launch_bounds__(kThreads)
trsm_kernel(const T* __restrict__ l, const T* __restrict__ g,
            const T* __restrict__ inv, T* __restrict__ out, int h, int B,
            int nrhs, int transpose) {
  extern __shared__ unsigned char smem_raw[];
  const int nt = (h + B - 1) / B;
  const int hp = nt * B;
  T* w = reinterpret_cast<T*>(smem_raw);   // (hp,) solved segment
  T* rhs = w + hp;                         // (B,)
  T* red = rhs + B;                        // (kThreads,)
  const long long mat = blockIdx.x;
  const int col = blockIdx.y;
  const T* L = l + mat * h * h;
  const T* G = g + mat * h * nrhs;
  const T* INV = inv + mat * nt * B * B;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  constexpr int kWarps = kThreads / 32;
  const int nph = kThreads / B;            // column-pattern phases
  const int rr = tid % B, ph = tid / B;

  for (int step = 0; step < nt; ++step) {
    const int i = transpose ? nt - 1 - step : step;
    const int r0 = i * B;
    if (!transpose) {
      // rhs = g_i - L[i rows, solved columns] . w  (a warp per row)
      for (int r = warp; r < B; r += kWarps) {
        const int row = r0 + r;
        T s = T(0);
        if (row < h)
          for (int c = lane; c < r0; c += 32) s += L[(long long)row * h + c] * w[c];
        s = warp_sum(s);
        if (lane == 0) rhs[r] = (row < h ? G[(long long)row * nrhs + col] : T(0)) - s;
      }
      __syncthreads();
      for (int r = warp; r < B; r += kWarps) {
        const T* iv = INV + ((long long)i * B + r) * B;
        T s = T(0);
        for (int c = lane; c < B; c += 32) s += iv[c] * rhs[c];
        s = warp_sum(s);
        if (lane == 0) w[r0 + r] = s;
      }
      __syncthreads();
    } else {
      // rhs = g_i - L[solved rows, i columns]^T . w  (a thread per column)
      T s = T(0);
      const int c = r0 + rr;
      if (ph < nph && c < h)
        for (int t = r0 + B + ph; t < h; t += nph) s += L[(long long)t * h + c] * w[t];
      red[tid] = s;
      __syncthreads();
      if (tid < B) {
        T acc = T(0);
        for (int q = 0; q < nph; ++q) acc += red[q * B + tid];
        rhs[tid] = (r0 + tid < h ? G[(long long)(r0 + tid) * nrhs + col] : T(0)) - acc;
      }
      __syncthreads();
      // w_i = inv_i^T . rhs
      s = T(0);
      if (ph < nph)
        for (int q = ph; q < B; q += nph) s += INV[((long long)i * B + q) * B + rr] * rhs[q];
      red[tid] = s;
      __syncthreads();
      if (tid < B) {
        T acc = T(0);
        for (int q = 0; q < nph; ++q) acc += red[q * B + tid];
        w[r0 + tid] = acc;
      }
      __syncthreads();
    }
  }
  for (int r = tid; r < h; r += kThreads)
    out[(mat * h + r) * nrhs + col] = w[r];
}

template <typename T>
static int trsm(const void* l, const void* g, const void* inv, void* out,
                int batch, int h, int B, int nrhs, int transpose, void* stream) {
  if (B > kThreads || batch > 2147483647 || nrhs > 65535)
    return (int)cudaErrorInvalidValue;
  const int hp = ((h + B - 1) / B) * B;
  const size_t smem = (size_t)(hp + B + kThreads) * sizeof(T);
  cudaFuncSetAttribute(trsm_kernel<T>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  RT_RETURN_IF_ERROR();
  trsm_kernel<T><<<dim3(batch, nrhs), kThreads, smem,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(l), static_cast<const T*>(g),
      static_cast<const T*>(inv), static_cast<T*>(out), h, B, nrhs, transpose);
  RT_RETURN_IF_ERROR();
  return 0;
}

extern "C" {
// l: (batch, h, h) lower factors; g, out: (batch, h, nrhs);
// inv: (batch, nt, B, B) inverses of the identity-padded diagonal tiles.
int rt_trsm_f64(const void* l, const void* g, const void* inv, void* out,
                int batch, int h, int B, int nrhs, int transpose, void* stream) {
  return trsm<double>(l, g, inv, out, batch, h, B, nrhs, transpose, stream);
}
int rt_trsm_f32(const void* l, const void* g, const void* inv, void* out,
                int batch, int h, int B, int nrhs, int transpose, void* stream) {
  return trsm<float>(l, g, inv, out, batch, h, B, nrhs, transpose, stream);
}
}
