// Blocked right-looking Cholesky, batched over matrices, for Hopper.
//
// Replaces the Pallas kernels of src/repro/kernels/chol_blocked.py:
// _factor_panel (:115, body _make_panel_kernel :62 with _potf2 :31 and
// _inv_lower :48) and _syrk_update (:130, body _make_syrk_kernel :89).
//
// The TPU version keeps L11^-1 in VMEM scratch from grid step 0 to the later
// steps of the same pallas_call; CUDA blocks run in no order, so each tile
// column here is three launches and state passes between them through
// global memory:
//   (a) diag_kernel   one block per matrix: potf2 of the diagonal tile and
//                     the inverse of the factor, both in shared memory, both
//                     stored packed-lower (B(B+1)/2 values each) so that at
//                     B=128 in float64 the tile and its inverse fit
//                     together (132 KB, above the 48 KB default: the host
//                     raises the dynamic shared memory limit);
//   (b) panel_kernel  one block per (sub-tile, matrix): W_i = A_i1 L11^-T,
//                     written to a scratch panel W (not in place: the
//                     blocks of one row strip read each other's inputs);
//   (c) syrk_kernel   one block per (lower tile pair sub-tile, matrix):
//                     A22 -= W W^T on the lower tiles, plus write-back jobs
//                     copying W into the factor's column.
// The factor is computed in place in the identity-padded (hp, hp) copy the
// wrapper makes.
//
// Bound on this card: operations (h^3/3 per matrix, mostly in (c)).  This
// first version uses CUDA-core FMAs through a shared-memory tiled GEMM
// (gemm_nt_tile); the serial potf2 / inversion chain of (a) runs on one SM
// per matrix and is the latency floor of every tile column.

#include "common.cuh"

__device__ __forceinline__ int tri(int r, int c) { return r * (r + 1) / 2 + c; }

template <typename T>
__global__ void __launch_bounds__(kThreads)
diag_kernel(T* __restrict__ a, T* __restrict__ inv, int hp, int B, int lo) {
  extern __shared__ unsigned char smem_raw[];
  T* sL = reinterpret_cast<T*>(smem_raw);
  T* sX = sL + B * (B + 1) / 2;
  const int tid = threadIdx.x;
  T* A = a + (long long)blockIdx.x * hp * hp + (long long)lo * hp + lo;

  for (int e = tid; e < B * B; e += kThreads) {
    const int r = e / B, c = e % B;
    if (c <= r) sL[tri(r, c)] = A[(long long)r * hp + c];
  }
  __syncthreads();

  // potf2: column k scaled by its pivot, then the trailing lower update
  for (int k = 0; k < B; ++k) {
    const T piv = sqrt(sL[tri(k, k)]);
    __syncthreads();
    for (int r = k + tid; r < B; r += kThreads)
      sL[tri(r, k)] = (r == k) ? piv : sL[tri(r, k)] / piv;
    __syncthreads();
    const int n = B - k - 1;
    for (int e = tid; e < n * n; e += kThreads) {
      const int r = k + 1 + e / n, c = k + 1 + e % n;
      if (c <= r) sL[tri(r, c)] -= sL[tri(r, k)] * sL[tri(c, k)];
    }
    __syncthreads();
  }

  for (int e = tid; e < B * B; e += kThreads) {
    const int r = e / B, c = e % B;
    A[(long long)r * hp + c] = (c <= r) ? sL[tri(r, c)] : T(0);
  }

  // X = L^-1 by forward substitution; column c is independent of the other
  // columns, so one thread owns it (two partial sums halve the FMA chain)
  for (int c = tid; c < B; c += kThreads) {
    for (int k = c; k < B; ++k) {
      T s0 = T(0), s1 = T(0);
      int m = c;
      for (; m + 1 < k; m += 2) {
        s0 += sL[tri(k, m)] * sX[tri(m, c)];
        s1 += sL[tri(k, m + 1)] * sX[tri(m + 1, c)];
      }
      if (m < k) s0 += sL[tri(k, m)] * sX[tri(m, c)];
      sX[tri(k, c)] = ((k == c ? T(1) : T(0)) - (s0 + s1)) / sL[tri(k, k)];
    }
  }
  __syncthreads();

  T* X = inv + (long long)blockIdx.x * B * B;
  for (int e = tid; e < B * B; e += kThreads) {
    const int r = e / B, c = e % B;
    X[e] = (c <= r) ? sX[tri(r, c)] : T(0);
  }
}

// W[i] = A[lo + B + i*B : , lo : lo + B] . X^T for the m sub-diagonal tiles
template <typename T, int TS>
__global__ void __launch_bounds__(kThreads)
panel_kernel(const T* __restrict__ a, const T* __restrict__ inv,
             T* __restrict__ w, int hp, int B, int lo) {
  const int S = B / TS;
  const int job = blockIdx.x;
  const int i = job / (S * S), sub = job % (S * S);
  const int sr = sub / S, sc = sub % S;
  const long long mat = blockIdx.y;
  const T* P = a + mat * hp * hp + (long long)(lo + B + i * B + sr * TS) * hp + lo;
  const T* Q = inv + mat * B * B + (long long)(sc * TS) * B;
  T* C = w + mat * hp * B + (long long)(i * B + sr * TS) * B + sc * TS;
  gemm_nt_tile<T, TS>(P, hp, Q, B, B, C, B, T(1), false);
}

// Trailing update A22 -= W W^T over the lower tile pairs (row-major order,
// p -> (ti, tj) with tj <= ti), then write-back jobs copying W into the
// factor's column below the diagonal tile.
template <typename T, int TS>
__global__ void __launch_bounds__(kThreads)
syrk_kernel(T* __restrict__ a, const T* __restrict__ w, int hp, int B, int lo,
            int m) {
  const int S = B / TS;
  const int n_pairs = m * (m + 1) / 2;
  const int job = blockIdx.x;
  const int p = job / (S * S), sub = job % (S * S);
  const int sr = sub / S, sc = sub % S;
  const long long mat = blockIdx.y;
  T* A = a + mat * hp * hp;
  const T* W = w + mat * hp * B;
  if (p < n_pairs) {
    int ti = (int)((sqrt(8.0 * p + 1.0) - 1.0) * 0.5);
    while ((ti + 1) * (ti + 2) / 2 <= p) ++ti;
    while (ti * (ti + 1) / 2 > p) --ti;
    const int tj = p - ti * (ti + 1) / 2;
    if (ti == tj && sc > sr) return;  // strictly upper part of a diagonal tile
    const T* P = W + (long long)(ti * B + sr * TS) * B;
    const T* Q = W + (long long)(tj * B + sc * TS) * B;
    T* C = A + (long long)(lo + B + ti * B + sr * TS) * hp
             + (lo + B + tj * B + sc * TS);
    gemm_nt_tile<T, TS>(P, B, Q, B, B, C, hp, T(-1), true);
  } else {
    const int ti = p - n_pairs;
    const int r0 = ti * B + sr * TS, c0 = sc * TS;
    for (int e = threadIdx.x; e < TS * TS; e += kThreads) {
      const int r = r0 + e / TS, c = c0 + e % TS;
      A[(long long)(lo + B + r) * hp + lo + c] = W[(long long)r * B + c];
    }
  }
}

// Adds the number of kernels launched to *launches, one per launch that
// reported no error.
template <typename T, int TS>
static int run_columns(T* a, T* inv, T* w, int batch, int hp, int B,
                       int* launches, cudaStream_t s) {
  const int nt = hp / B;
  const int S = B / TS;
  const size_t smem = (size_t)B * (B + 1) * sizeof(T);
  cudaFuncSetAttribute(diag_kernel<T>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  RT_RETURN_IF_ERROR();
  for (int j = 0; j < nt; ++j) {
    const int lo = j * B;
    diag_kernel<T><<<batch, kThreads, smem, s>>>(a, inv, hp, B, lo);
    RT_RETURN_IF_ERROR();
    ++*launches;
    const int m = nt - 1 - j;
    if (m == 0) break;
    panel_kernel<T, TS><<<dim3(m * S * S, batch), kThreads, 0, s>>>(
        a, inv, w, hp, B, lo);
    RT_RETURN_IF_ERROR();
    ++*launches;
    syrk_kernel<T, TS><<<dim3((m * (m + 1) / 2 + m) * S * S, batch),
                         kThreads, 0, s>>>(a, w, hp, B, lo, m);
    RT_RETURN_IF_ERROR();
    ++*launches;
  }
  return 0;
}

template <typename T>
static int chol_blocked(void* a, void* inv, void* w, int batch, int hp, int B,
                        int* launches, void* stream) {
  T* A = static_cast<T*>(a);
  T* X = static_cast<T*>(inv);
  T* W = static_cast<T*>(w);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B % 16 != 0 || hp % B != 0 || batch > 65535) return (int)cudaErrorInvalidValue;
  if (B % 64 == 0) return run_columns<T, 64>(A, X, W, batch, hp, B, launches, s);
  if (B % 32 == 0) return run_columns<T, 32>(A, X, W, batch, hp, B, launches, s);
  return run_columns<T, 16>(A, X, W, batch, hp, B, launches, s);
}

extern "C" {
// a: (batch, hp, hp) identity-padded SPD matrices, factored in place (lower
// triangle; the strictly upper tiles keep their input values).
// inv: (batch, B, B) scratch for the diagonal inverse.  w: (batch, hp, B)
// scratch panel.  *launches is increased by the kernels launched
// (3 * hp / B - 2 when every launch succeeds).
int rt_chol_blocked_f64(void* a, void* inv, void* w, int batch, int hp, int B,
                        int* launches, void* stream) {
  return chol_blocked<double>(a, inv, w, batch, hp, B, launches, stream);
}
int rt_chol_blocked_f32(void* a, void* inv, void* w, int batch, int hp, int B,
                        int* launches, void* stream) {
  return chol_blocked<float>(a, inv, w, batch, hp, B, launches, stream);
}
}
