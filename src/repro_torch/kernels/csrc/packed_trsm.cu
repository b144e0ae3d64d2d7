// Triangular solve L w = g / L^T w = g read directly from tile-packed
// factors, batched over factors, for Hopper.
//
// Replaces the Pallas kernel of src/repro/kernels/packed_trsm.py:166
// (solve_lower_packed, body _make_kernel :42, tile map _step_tile_indices
// :83).  The TPU version walks a sequential (nt, nt) grid: the outer step is
// the tile row being solved, the inner step streams that row's tiles through
// a scalar-prefetched (s, u) -> packed-tile map, and solved rows are read
// back from the revisited output ref.  CUDA blocks run in no order, so here
// one block per (factor, RHS column) walks every tile row in a loop and
// keeps the whole solution in shared memory, as csrc/trsm.cu does for dense
// factors.  The (i, t) -> packed tile map is passed in as an int32 tensor
// (nt, nt); the forward sweep reads tile (i, t) for t < i, the transposed
// sweep walks the tile rows in reverse and reads column i of packed L as row
// i of L^T: tile (t, i) for t > i, element (c, r) for row r of L^T.  Each
// step ends with the pre-inverted diagonal tile (inverted once outside the
// kernel, identity on the padding of a ragged last tile, as at
// packed_trsm.py:112), used as is forward and transposed in reverse.
//
// The packed factor is zero on its padding, g is zero-padded to the tile
// multiple, and the identity tail keeps the padded solution rows at 0.
//
// Bound on this card: bytes (each packed value read once per sweep; 2 flops
// per value read).  Reads are coalesced: a warp walks a tile row in the
// forward sweep, consecutive threads walk consecutive tile columns in the
// transposed one.

#include "common.cuh"

template <typename T>
__global__ void __launch_bounds__(kThreads)
packed_trsm_kernel(const T* __restrict__ vec, const T* __restrict__ g,
                   const T* __restrict__ inv, const int* __restrict__ pmap,
                   T* __restrict__ out, int nt, int B, long long P, int nrhs,
                   int transpose) {
  extern __shared__ unsigned char smem_raw[];
  const int hp = nt * B;
  T* w = reinterpret_cast<T*>(smem_raw);   // (hp,) solved segment
  T* rhs = w + hp;                         // (B,)
  T* red = rhs + B;                        // (kThreads,)
  const long long mat = blockIdx.x;
  const int col = blockIdx.y;
  const long long tile = (long long)B * B;
  const T* V = vec + mat * P;
  const T* G = g + mat * hp * nrhs;
  const T* INV = inv + mat * nt * tile;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  constexpr int kWarps = kThreads / 32;
  const int nph = kThreads / B;            // column-pattern phases
  const int rr = tid % B, ph = tid / B;

  for (int step = 0; step < nt; ++step) {
    const int i = transpose ? nt - 1 - step : step;
    if (!transpose) {
      // rhs = g_i - sum_{t<i} L(i, t) w_t  (a warp per row)
      for (int r = warp; r < B; r += kWarps) {
        T s = T(0);
        for (int t = 0; t < i; ++t) {
          const long long base = (long long)pmap[i * nt + t] * tile + (long long)r * B;
          for (int c = lane; c < B; c += 32) s += V[base + c] * w[t * B + c];
        }
        s = warp_sum(s);
        if (lane == 0) rhs[r] = G[(long long)(i * B + r) * nrhs + col] - s;
      }
      __syncthreads();
      // w_i = inv_i rhs
      for (int r = warp; r < B; r += kWarps) {
        const T* iv = INV + (long long)i * tile + (long long)r * B;
        T s = T(0);
        for (int c = lane; c < B; c += 32) s += iv[c] * rhs[c];
        s = warp_sum(s);
        if (lane == 0) w[i * B + r] = s;
      }
      __syncthreads();
    } else {
      // rhs = g_i - sum_{t>i} L(t, i)^T w_t  (a thread per column of L(t, i))
      T s = T(0);
      if (ph < nph)
        for (int t = i + 1; t < nt; ++t) {
          const long long base = (long long)pmap[t * nt + i] * tile + rr;
          for (int c = ph; c < B; c += nph) s += V[base + (long long)c * B] * w[t * B + c];
        }
      red[tid] = s;
      __syncthreads();
      if (tid < B) {
        T acc = T(0);
        for (int q = 0; q < nph; ++q) acc += red[q * B + tid];
        rhs[tid] = G[(long long)(i * B + tid) * nrhs + col] - acc;
      }
      __syncthreads();
      // w_i = inv_i^T rhs
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
  }
  for (int r = tid; r < hp; r += kThreads)
    out[(mat * hp + r) * nrhs + col] = w[r];
}

template <typename T>
static int packed_trsm(const void* vec, const void* g, const void* inv,
                       const void* pmap, void* out, int batch, int nt, int B,
                       long long P, int nrhs, int transpose, void* stream) {
  if (B > kThreads || nrhs > 65535) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(nt * B + B + kThreads) * sizeof(T);
  cudaFuncSetAttribute(packed_trsm_kernel<T>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  RT_RETURN_IF_ERROR();
  packed_trsm_kernel<T><<<dim3(batch, nrhs), kThreads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(vec), static_cast<const T*>(g),
      static_cast<const T*>(inv), static_cast<const int*>(pmap),
      static_cast<T*>(out), nt, B, P, nrhs, transpose);
  RT_RETURN_IF_ERROR();
  return 0;
}

extern "C" {
// vec: (batch, P) packed factors; g, out: (batch, nt * B, nrhs), g
// zero-padded past h; inv: (batch, nt, B, B) inverses of the identity-padded
// diagonal tiles; pmap: (nt, nt) packed tile index.
int rt_packed_trsm_f64(const void* vec, const void* g, const void* inv,
                       const void* pmap, void* out, int batch, int nt, int B,
                       long long P, int nrhs, int transpose, void* stream) {
  return packed_trsm<double>(vec, g, inv, pmap, out, batch, nt, B, P, nrhs,
                             transpose, stream);
}
int rt_packed_trsm_f32(const void* vec, const void* g, const void* inv,
                       const void* pmap, void* out, int batch, int nt, int B,
                       long long P, int nrhs, int transpose, void* stream) {
  return packed_trsm<float>(vec, g, inv, pmap, out, batch, nt, B, P, nrhs,
                            transpose, stream);
}
}
