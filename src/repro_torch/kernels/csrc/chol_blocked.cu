// Blocked right-looking Cholesky, batched over matrices, for Hopper.
//
// Replaces the Pallas kernels of src/repro/kernels/chol_blocked.py:
// _factor_panel (:115, body _make_panel_kernel :62 with _potf2 :31 and
// _inv_lower :48) and _syrk_update (:130, body _make_syrk_kernel :89).
//
// The TPU version keeps L11^-1 in VMEM scratch from grid step 0 to the later
// steps of the same pallas_call; CUDA blocks run in no order, so each tile
// column here is three launches (3 * hp / B - 2 per call) and state passes
// between them through global memory:
//   (a) diag_kernel   one block per matrix factors the B x B diagonal tile
//                     and inverts the factor;
//   (b) panel_kernel  one block per (64 x 64 sub-tile, matrix):
//                     W_i = A_i1 L11^-T into a scratch panel W (not in
//                     place: the blocks of one row strip read each other's
//                     inputs), the depth cut to the nonzero part of L11^-T;
//   (c) syrk_kernel   one block per (lower tile pair sub-tile, matrix):
//                     A22 -= W W^T on the lower tiles but the next diagonal
//                     tile, plus write-back jobs copying W into the factor's
//                     column and writing zeros into the mirrored strictly
//                     upper tile, so the wrapper needs no tril.
// Look-ahead: (a) of column j + 1 first applies column j's update to its own
// tile (W0 W0^T, W0 the panel's first tile row) and runs on a second,
// high-priority stream beside (c) of column j; the caller's stream waits
// for it (an event) before (b) of column j + 1.  The diagonal step's one
// block per matrix (15 to 20 of the 132 SMs) thus overlaps the trailing
// update instead of following it.  Column 0 reads the caller's input and
// every kernel writes the output, so no copy of the input is made.
// B is a template parameter (16, 32, 64, 128): every index of the tile is
// compile-time arithmetic.
//
// The diagonal step (a).  The tile sits square in shared memory with a
// stride of B + 4 values (= 4 mod 16 doubles, so the fragment reads of the
// products below hit 16 distinct bank pairs per half-warp), loaded by
// cp.async with every load in flight at once.  The factor and its inverse
// do not both fit square at B = 128 in float64, so the inverse overwrites
// the factor in place after each column strip of the factor has been
// stored; only the 16 x 16 diagonal sub-block inverses are kept aside
// (NS x 16 x 20 values; before the factorization that space and one more
// like it stage W0 for the look-ahead update).  Shared memory at B = 128,
// float64: 135,168 + 2 x 20,480 bytes.
// Per 16-column sub-block p (NS = B / 16 of them):
//   - warp 0 factors A_pp in registers (each lane one column, eight rows,
//     pivot and columns broadcast by __shfl_sync, a reciprocal square root
//     and no divide on the chain) and, in the same loop, forms
//     X_pp = L_pp^-1 by right-looking forward substitution; no block
//     barrier inside;
//   - L_ip = A_ip X_pp^T, one warp per 16-row strip below;
//   - A_ij -= L_ip L_jp^T on the lower sub-blocks: warp 0 updates
//     A_{p+1,p+1} and goes straight on to factor it (look-ahead inside the
//     tile) while the other warps update the rest and store column strip p
//     of L.
// Two barriers per sub-block.  Then the inverse of the tile, block row by
// block row: T_ij = sum_{k=j}^{i-1} L_ik X_kj (warp j), X_ij = -X_ii T_ij;
// two barriers per row, the idle warps storing the finished row blocks.
// About 33 block barriers per tile at B = 128 (16 more for the staged
// look-ahead update), none per column.
//
// The products.  In float64 every product (the in-tile ones of (a), the
// panel and the trailing update) runs on the FP64 tensor cores through
// mma.sync.aligned.m16n8k4.row.col.f64: wgmma has no f64 type, so this is
// the tensor-core path for float64 on Hopper (m16n8k4 measured at 67
// TFLOP/s on the H100 SXM, m8n8k4 at 33).  Operands of (b) and (c) are
// staged by cp.async, 16 bytes a thread, into a double-buffered ring in
// shared memory, so the next 16-deep slice loads while this one multiplies.
// Float32 runs the same code with CUDA-core FMAs in place of the mma (TF32
// would not hold the float32 tolerance).
//
// The mixed-precision variant (rt_chol_blocked_f32_bf16; the Pallas kernels
// under a bf16 compute dtype, chol_blocked.py:80-82 and :98-100): the
// state (src, a, inv, w) stays float32, and the operands of (b) (A_i1 and
// X) and of (c) (W), and of the look-ahead update of (a) (W0, since the
// Pallas syrk covers the diagonal tile too), are rounded to bf16 as their
// fragments are formed and multiplied on the bf16 tensor cores
// (mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32, warp_mma_bf16)
// into float32 sums; one kKc = 16 slice is one k16 step.  The diagonal
// factor and its inverse stay float32 (CUDA-core products).  At the bf16
// tensor-core rate the variant's bound is bytes (the float32 matrices read
// and the factors written), and the diagonal step's serial chain, which
// stays float32, holds it as it holds the float64 kernel.
//
// Bound on this card: operations (h^3/3 per matrix, mostly in (c), on the
// FP64 tensor cores).  What holds it back: the diagonal step's serial chain
// (128 pivots per tile, each a shuffle, a reciprocal square root and a
// multiply-add on warp 0) on one SM per matrix, and the trailing update's
// read-modify-write of A22 with 64 x 64 tiles of depth B.

#include <cstdint>
#include <mutex>

#include "tri_solve.cuh"   // the warp products, cp.async, warp_potf2_inv

namespace {

constexpr int kWarps = kThreads / 32;
constexpr int kKc = 16;                 // depth of one staged slice in (b), (c)
constexpr int kLdStage = kKc + 4;

// (a) the diagonal step: factor and inverse of one B x B tile per matrix;
// CT the compute type of the look-ahead update
template <typename T, int B, typename CT>
__global__ void __launch_bounds__(kThreads)
diag_kernel(const T* src, T* a, T* __restrict__ inv,
            const T* __restrict__ w, int hp, int lo) {
  constexpr int LD = B + 4, NS = B / kNb, VN = 16 / sizeof(T);
  static_assert(B % kNb == 0 && NS <= kWarps, "B in 16..128");
  using V = typename Vec16<T>::type;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* S = reinterpret_cast<T*>(smem_raw);       // the tile, then its inverse
  T* Xd = S + B * LD;      // NS sub-block inverses; first a staging ring
  static_assert(kLdSub == kLdStage, "a ring stage is the size of Xd");
  const int tid = threadIdx.x, warp = tid >> 5;
  const long long at = (long long)blockIdx.x * hp * hp + (long long)lo * hp + lo;
  const T* A_in = src + at;
  T* A = a + at;
  T* X = inv + (long long)blockIdx.x * B * B;
  // final parts of the tile go out while other warps compute: column strip
  // p of L (zeros above the diagonal block) and row block i of X
  auto store_col = [&](int p, int t0, int n) {
    for (int e = t0; e < B * (kNb / VN); e += n) {
      const int r = e / (kNb / VN), c = p * kNb + e % (kNb / VN) * VN;
      *reinterpret_cast<V*>(A + (long long)r * hp + c) =
          *reinterpret_cast<const V*>(S + r * LD + c);
    }
  };
  auto store_row = [&](int i, int t0, int n) {
    for (int e = t0; e < kNb * (B / VN); e += n) {
      const int r = i * kNb + e / (B / VN), c = e % (B / VN) * VN;
      *reinterpret_cast<V*>(X + r * B + c) =
          *reinterpret_cast<const V*>(S + r * LD + c);
    }
  };

  // lower sub-blocks in (all loads in flight at once), upper ones zero
  // (they stay zero in L and in X)
  for (int e = tid; e < B * B / VN; e += kThreads) {
    const int r = e / (B / VN), c = e % (B / VN) * VN;
    if (c / kNb <= r / kNb)
      cp_async16(S + r * LD + c, A_in + (long long)r * hp + c);
    else
      *reinterpret_cast<V*>(S + r * LD + c) = V{};
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  if (w != nullptr) {
    // the previous tile column's trailing update of this tile, which its
    // syrk launch leaves out: A -= W0 W0^T, W0 the panel's first tile row,
    // staged kKc columns at a time through a two-stage ring (Xd and the
    // stage after it); each warp keeps the sums of its sub-block pairs
    constexpr int NP = NS * (NS + 1) / 2, PW = (NP + kWarps - 1) / kWarps;
    const T* W0 = w + (long long)blockIdx.x * hp * B;
    auto stage = [&](int buf, int k0) {
      for (int e = tid; e < B * kKc / VN; e += kThreads) {
        const int r = e / (kKc / VN), c = e % (kKc / VN) * VN;
        cp_async16(Xd + (buf * B + r) * kLdStage + c, W0 + r * B + k0 + c);
      }
      cp_async_commit();
    };
    T acc[PW][2][2][2];
    int pi[PW], pj[PW];            // a slot past the last pair repeats it
#pragma unroll
    for (int q = 0; q < PW; ++q) {
      const int e = min(warp + q * kWarps, NP - 1);
      int i = 0;
      while ((i + 1) * (i + 2) / 2 <= e) ++i;
      pi[q] = i;
      pj[q] = e - i * (i + 1) / 2;
      zero(acc[q]);
    }
    stage(0, 0);
    for (int kt = 0; kt < B / kKc; ++kt) {
      if (kt + 1 < B / kKc) {
        stage((kt + 1) & 1, (kt + 1) * kKc);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const T* R = Xd + (kt & 1) * B * kLdStage;
#pragma unroll
      for (int q = 0; q < PW; ++q)
        warp_product<CT, 2, 2>(acc[q], R + pi[q] * kNb * kLdStage, kLdStage,
                               R + pj[q] * kNb * kLdStage, 1, kLdStage, kKc);
      __syncthreads();
    }
#pragma unroll
    for (int q = 0; q < PW; ++q) {
      if (warp + q * kWarps >= NP) break;
      T* aij = S + pi[q] * kNb * LD + pj[q] * kNb;
      for_each_acc(acc[q], [&](int r, int c, T val) { aij[r * LD + c] -= val; });
    }
    __syncthreads();
  }

  if (warp == 0) warp_potf2_inv<T, LD>(S, Xd);
  __syncthreads();
  for (int p = 0; p < NS; ++p) {
    T* col = S + p * kNb * LD + p * kNb;          // A_pp, then the strips
    T* xpp = Xd + p * kNb * kLdSub;
    for (int i = p + 1 + warp; i < NS; i += kWarps) {   // L_ip = A_ip X_pp^T
      T* aip = col + (i - p) * kNb * LD;
      T acc[2][2][2];
      zero(acc);
      warp_mma<2, 2>(acc, aip, LD, xpp, 1, kLdSub, kNb);
      __syncwarp();
      for_each_acc(acc, [&](int r, int c, T val) { aip[r * LD + c] = val; });
    }
    __syncthreads();
    const int m = NS - 1 - p;                     // A_ij -= L_ip L_jp^T
    if (m == 0) break;
    // pair 0 is (p+1, p+1): warp 0 updates it and factors it at once
    // (look-ahead), while warps 1.. update the other pairs
    const int first = warp == 0 ? 0 : warp, step = warp == 0 ? 1 : kWarps - 1;
    const int last = warp == 0 ? 1 : m * (m + 1) / 2;
    for (int e = first; e < last; e += step) {
      int ii = 0;
      while ((ii + 1) * (ii + 2) / 2 <= e) ++ii;
      const int i = p + 1 + ii, j = p + 1 + e - ii * (ii + 1) / 2;
      T acc[2][2][2];
      zero(acc);
      warp_mma<2, 2>(acc, S + i * kNb * LD + p * kNb, LD,
                     S + j * kNb * LD + p * kNb, 1, LD, kNb);
      T* aij = S + i * kNb * LD + j * kNb;
      for_each_acc(acc, [&](int r, int c, T val) { aij[r * LD + c] -= val; });
    }
    if (warp == 0) {
      __syncwarp();
      warp_potf2_inv<T, LD>(col + kNb * LD + kNb, xpp + kNb * kLdSub);
    } else {
      store_col(p, tid - 32, kThreads - 32);      // column p of L is final
    }
    __syncthreads();
  }
  store_col(NS - 1, tid, kThreads);
  __syncthreads();
  for (int e = tid; e < NS * kNb * kNb; e += kThreads) {  // X_pp on the diagonal
    const int p = e / (kNb * kNb), r = e / kNb % kNb, c = e % kNb;
    S[(p * kNb + r) * LD + p * kNb + c] = Xd[p * kNb * kLdSub + r * kLdSub + c];
  }
  __syncthreads();

  // X_ij = -X_ii sum_{k=j}^{i-1} L_ik X_kj, block row by block row, in place
  for (int i = 1; i < NS; ++i) {
    const int j = warp;
    T acc[2][2][2];
    zero(acc);
    if (j < i)
      warp_mma<2, 2>(acc, S + i * kNb * LD + j * kNb, LD,
                     S + j * kNb * LD + j * kNb, LD, 1, (i - j) * kNb);
    __syncthreads();                              // row i's L has been read
    if (j >= i) store_row(i - 1, tid - 32 * i, kThreads - 32 * i);
    if (j < i) {
      T* tij = S + i * kNb * LD + j * kNb;
      for_each_acc(acc, [&](int r, int c, T val) { tij[r * LD + c] = val; });
      __syncwarp();
      zero(acc);
      warp_mma<2, 2>(acc, Xd + i * kNb * kLdSub, kLdSub, tij, LD, 1, kNb);
      __syncwarp();
      for_each_acc(acc, [&](int r, int c, T val) { tij[r * LD + c] = -val; });
    }
    __syncthreads();
  }

  store_row(NS - 1, tid, kThreads);
}

// ---------------------------------------------------------------------------
// One TS x TS tile of C = (C_in or 0) + alpha P Q^T over depth K (a multiple
// of kKc), computed by the whole block; C_in may be C.  P and Q are row-major with
// the depth index contiguous, 16-byte aligned rows.  Slices of kKc are
// staged by cp.async into a two-stage ring; warps form a WR x WC grid of
// (MI*8) x (NI*8) warp tiles (warps past WR*WC only load).
template <int TS> struct GemmShape;
template <> struct GemmShape<64> { static constexpr int WR = 2, WC = 4, MI = 4, NI = 2; };
template <> struct GemmShape<32> { static constexpr int WR = 2, WC = 4, MI = 2, NI = 1; };
template <> struct GemmShape<16> { static constexpr int WR = 1, WC = 2, MI = 2, NI = 1; };

template <typename T, int TS, typename CT>
__device__ void gemm_tile(const T* __restrict__ P, int ldp,
                          const T* __restrict__ Q, int ldq, int K,
                          const T* C_in, T* C, int ldc, T alpha) {
  using G = GemmShape<TS>;
  constexpr int VN = 16 / sizeof(T), CH = TS * kKc / VN;
  __shared__ __align__(16) T sP[2][TS * kLdStage];
  __shared__ __align__(16) T sQ[2][TS * kLdStage];
  const int tid = threadIdx.x, warp = tid >> 5;
  const bool active = warp < G::WR * G::WC;
  const int wr = warp / G::WC, wc = warp % G::WC;

  auto stage = [&](int buf, int k0) {
    for (int e = tid; e < CH; e += kThreads) {
      const int r = e / (kKc / VN), c = e % (kKc / VN) * VN;
      cp_async16(&sP[buf][r * kLdStage + c], P + (long long)r * ldp + k0 + c);
      cp_async16(&sQ[buf][r * kLdStage + c], Q + (long long)r * ldq + k0 + c);
    }
    cp_async_commit();
  };

  T acc[G::MI][G::NI][2];
  zero(acc);
  const int nk = K / kKc;
  stage(0, 0);
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) {
      stage((kt + 1) & 1, (kt + 1) * kKc);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (active)
      warp_product<CT, G::MI, G::NI>(
          acc, &sP[kt & 1][wr * G::MI * 8 * kLdStage], kLdStage,
          &sQ[kt & 1][wc * G::NI * 8 * kLdStage], 1, kLdStage, kKc);
    __syncthreads();
  }
  if (!active) return;
  const long long c0 = (long long)(wr * G::MI * 8) * ldc + wc * G::NI * 8;
  for_each_acc(acc, [&](int r, int c, T val) {
    const long long at = c0 + (long long)r * ldc + c;
    C[at] = C_in ? C_in[at] + alpha * val : alpha * val;
  });
}

// (b) W[i] = A[lo + B + i*B :, lo : lo + B] . X^T for the m sub-diagonal
// tiles; columns n < (sc + 1) TS of X^T are zero below depth (sc + 1) TS
template <typename T, int B, int TS, typename CT>
__global__ void __launch_bounds__(kThreads)
panel_kernel(const T* __restrict__ src, const T* __restrict__ inv,
             T* __restrict__ w, int hp, int lo) {
  constexpr int S = B / TS;
  const int job = blockIdx.x;
  const int i = job / (S * S), sub = job % (S * S);
  const int sr = sub / S, sc = sub % S;
  const long long mat = blockIdx.y;
  const T* P = src + mat * hp * hp + (long long)(lo + B + i * B + sr * TS) * hp + lo;
  const T* Q = inv + mat * B * B + (long long)(sc * TS) * B;
  T* C = w + mat * hp * B + (long long)(i * B + sr * TS) * B + sc * TS;
  gemm_tile<T, TS, CT>(P, hp, Q, B, (sc + 1) * TS, nullptr, C, B, T(1));
}

// (c) A22 -= W W^T over the lower tile pairs but the first (row-major
// order, p -> (ti, tj) with tj <= ti; pair 0, the next diagonal tile, is
// updated by the next diagonal step), then write-back jobs copying W into
// the factor's column below the diagonal tile and zeroing the mirrored tile
// above it.  A22 is read from src and written to a.
template <typename T, int B, int TS, typename CT>
__global__ void __launch_bounds__(kThreads)
syrk_kernel(const T* src, T* a, const T* __restrict__ w, int hp, int lo,
            int m) {
  constexpr int S = B / TS;
  const int n_pairs = m * (m + 1) / 2;
  const int job = blockIdx.x;
  const int p = job / (S * S) + 1, sub = job % (S * S);
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
    const long long at = mat * hp * hp + (long long)(lo + B + ti * B + sr * TS) * hp
                         + (lo + B + tj * B + sc * TS);
    gemm_tile<T, TS, CT>(P, B, Q, B, B, src + at, a + at, hp, T(-1));
  } else {
    const int ti = p - n_pairs;
    const int r0 = ti * B + sr * TS, c0 = sc * TS;
    for (int e = threadIdx.x; e < TS * TS; e += kThreads) {
      const int r = e / TS, c = e % TS;
      A[(long long)(lo + B + r0 + r) * hp + lo + c0 + c] =
          W[(long long)(r0 + r) * B + c0 + c];
      A[(long long)(lo + c0 + r) * hp + lo + B + r0 + c] = T(0);
    }
  }
}

// The look-ahead stream of the current device (highest priority, so the
// diagonal step's blocks take SMs as the trailing update frees them) and
// two events, made once per device.
struct LookAhead {
  cudaStream_t side = nullptr;
  cudaEvent_t panel_done = nullptr, diag_done = nullptr;
};

int look_ahead(LookAhead** out) {
  static std::mutex mu;
  static LookAhead per_device[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(mu);
  LookAhead& la = per_device[dev];
  if (la.side == nullptr) {
    int least = 0, greatest = 0;
    err = cudaDeviceGetStreamPriorityRange(&least, &greatest);
    if (err == cudaSuccess)
      err = cudaStreamCreateWithPriority(&la.side, cudaStreamNonBlocking,
                                         greatest);
    if (err == cudaSuccess)
      err = cudaEventCreateWithFlags(&la.panel_done, cudaEventDisableTiming);
    if (err == cudaSuccess)
      err = cudaEventCreateWithFlags(&la.diag_done, cudaEventDisableTiming);
    if (err != cudaSuccess) return (int)err;
  }
  *out = &la;
  return 0;
}

#define RT_RETURN_IF(expr)                           \
  do {                                               \
    cudaError_t _e = (expr);                         \
    if (_e != cudaSuccess) return (int)_e;           \
  } while (0)

// Adds the number of kernels launched to *launches, one per launch that
// reported no error.  Tile column j: panel(j) on the caller's stream s;
// then diag(j+1), which first applies column j's update to its own tile, on
// the look-ahead stream while syrk(j) updates the rest of the trailing
// matrix on s; s waits for diag(j+1) before panel(j+1).  Tile column 0
// (diag 0, panel 0, syrk 0) and diag 1 read the input from src; every
// kernel writes a.
template <typename T, int B, typename CT>
int run_columns(const T* src, T* a, T* inv, T* w, int batch, int hp,
                int* launches, cudaStream_t s) {
  constexpr int TS = B < 64 ? B : 64, S = B / TS;
  const int nt = hp / B;
  const size_t smem = (size_t)(B * (B + 4) + 2 * B * kLdStage) * sizeof(T);
  RT_RETURN_IF(cudaFuncSetAttribute(
      diag_kernel<T, B, CT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem));
  LookAhead* la = nullptr;
  if (nt > 1) {
    const int rc = look_ahead(&la);
    if (rc) return rc;
  }
  diag_kernel<T, B, CT><<<batch, kThreads, smem, s>>>(src, a, inv, nullptr, hp, 0);
  RT_RETURN_IF_ERROR();
  ++*launches;
  for (int j = 0; j + 1 < nt; ++j) {
    const int lo = j * B, m = nt - 1 - j;
    const T* in = j == 0 ? src : a;
    panel_kernel<T, B, TS, CT><<<dim3(m * S * S, batch), kThreads, 0, s>>>(
        in, inv, w, hp, lo);
    RT_RETURN_IF_ERROR();
    ++*launches;
    RT_RETURN_IF(cudaEventRecord(la->panel_done, s));
    RT_RETURN_IF(cudaStreamWaitEvent(la->side, la->panel_done, 0));
    diag_kernel<T, B, CT><<<batch, kThreads, smem, la->side>>>(
        j == 0 ? src : a, a, inv, w, hp, lo + B);
    RT_RETURN_IF_ERROR();
    ++*launches;
    RT_RETURN_IF(cudaEventRecord(la->diag_done, la->side));
    syrk_kernel<T, B, TS, CT><<<dim3((m * (m + 1) / 2 - 1 + m) * S * S, batch),
                                kThreads, 0, s>>>(in, a, w, hp, lo, m);
    RT_RETURN_IF_ERROR();
    ++*launches;
    RT_RETURN_IF(cudaStreamWaitEvent(s, la->diag_done, 0));
  }
  return 0;
}

template <typename T, typename CT = T>
int chol_blocked(const void* src, void* a, void* inv, void* w, int batch,
                 int hp, int B, int* launches, void* stream) {
  const T* In = static_cast<const T*>(src);
  T* A = static_cast<T*>(a);
  T* X = static_cast<T*>(inv);
  T* W = static_cast<T*>(w);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || hp % B != 0 || batch > 65535) return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(a) |
       reinterpret_cast<uintptr_t>(inv) | reinterpret_cast<uintptr_t>(w)) % 16)
    return (int)cudaErrorMisalignedAddress;
  switch (B) {
    case 16: return run_columns<T, 16, CT>(In, A, X, W, batch, hp, launches, s);
    case 32: return run_columns<T, 32, CT>(In, A, X, W, batch, hp, launches, s);
    case 64: return run_columns<T, 64, CT>(In, A, X, W, batch, hp, launches, s);
    case 128: return run_columns<T, 128, CT>(In, A, X, W, batch, hp, launches, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {
// src: (batch, hp, hp) SPD matrices (identity-padded when h % B != 0), read
// only; a: (batch, hp, hp) output, which may be src itself: on return its
// lower triangle holds L and its strictly upper part is zero.  inv:
// (batch, B, B) scratch for the diagonal inverse.  w: (batch, hp, B) scratch
// panel.  B is 16, 32, 64 or 128; the four pointers are 16-byte aligned.
// *launches is increased by the kernels launched (3 * hp / B - 2 when every
// launch succeeds).
int rt_chol_blocked_f64(const void* src, void* a, void* inv, void* w,
                        int batch, int hp, int B, int* launches,
                        void* stream) {
  return chol_blocked<double>(src, a, inv, w, batch, hp, B, launches, stream);
}
int rt_chol_blocked_f32(const void* src, void* a, void* inv, void* w,
                        int batch, int hp, int B, int* launches,
                        void* stream) {
  return chol_blocked<float>(src, a, inv, w, batch, hp, B, launches, stream);
}
// the same arguments, float32 state; the products in bf16
int rt_chol_blocked_f32_bf16(const void* src, void* a, void* inv, void* w,
                             int batch, int hp, int B, int* launches,
                             void* stream) {
  return chol_blocked<float, __nv_bfloat16>(src, a, inv, w, batch, hp, B,
                                            launches, stream);
}
}
