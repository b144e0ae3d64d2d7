// Device code shared by the port's dense-tile kernels, and the
// thread-block-cluster triangular solve of the dense trsm (trsm.cu), the
// fused interp-solve (poly_interp.cu) and the packed trsm (packed_trsm.cu).
//
// Part 1, moved here from chol_blocked.cu (the Cholesky's diagonal step
// and the solves' prologue use it): the FP64 tensor-core product of one
// warp (mma.sync m16n8k4, with a CUDA-core float32 overload), its bf16
// tensor-core form for the mixed-precision variants (warp_mma_bf16,
// mma.sync m16n8k16 with fp32 sums, and the one-column warp_mv_bf16),
// cp.async helpers, and the warp-level factor-and-inverse of a 16 x 16
// block (warp_potf2_inv), which also inverts a block that is already a
// lower factor (Factor = false).
//
// Part 2, the cluster solve.  One system is L v = g, L^T v = g, or both in
// turn (L L^T v = g), for one right-hand-side column; L is lower
// triangular in nt x nt tiles of B x B, read from one of three tile
// sources: the unpadded dense factor (kDense, trsm), the r+1 packed
// coefficient tiles of Θ, Horner-evaluated at λ - center as they are read
// (kInterp, interp_solve), or a tile-packed factor, which is a degree-0
// interpolant: one coefficient plane, no λ (kPacked, the packed trsm).
//
// A cluster of C <= 8 blocks serves one system (C = min(C, nt)); block b
// owns tile rows b, b + C, b + 2C, ...  Every block keeps the whole
// solution of each sweep in its own shared memory (a forward slot and a
// reverse slot, so no slot is ever overwritten), and for its own rows the
// pending sums acc_j and the inverses of the diagonal tiles.
//   - Prologue: each block reads (trsm, packed) or Horner-evaluates
//     (interp) its own diagonal tiles, adds the identity tail past h, and
//     inverts them: one warp per 16 x 16 sub-block in parallel
//     (warp_potf2_inv<false>), then X_ij = -X_ii sum_{k=j}^{i-1} L_ik X_kj
//     block row by block row on the tensor cores.  The inverse stays in
//     shared memory when the block's rows fit, otherwise in a scratch
//     tensor of the caller.
//   - Right-looking substitution: the owner of row i solves
//     v_i = X_i (g_i - acc_i) (X_i^T for the transposed sweep) and stores
//     v_i into every block's slot through distributed shared memory, then
//     arrives on the cluster barrier (release); every block waits
//     (acquire) and adds L_ji v_i (forward, rows j > i: a warp per row) or
//     L_ij^T v_i (reverse, rows j < i: consecutive threads on consecutive
//     columns) into the sums of the rows it owns.  Look-ahead: the owner
//     of the next row applies this update to that row first, solves it and
//     arrives; the others arrive at once and then update, so the next
//     solve waits only for its own row's update.  2 nt barrier phases for
//     both sweeps.
//   - Loads that do not depend on v run ahead: every tile a block will
//     read, over the whole run, is known at the start, so a ring of
//     `stages` chunks (chunk_rows x B values of each coefficient plane)
//     is kept in flight by cp.async, 16 bytes a thread (element-wise where
//     rows are not 16-byte aligned, zero-filled past h), across the
//     barriers.
// At nrhs = 1 the sweep does 2 flops per value read (2r + 2 for Horner):
// it is bound by bytes and by its 2 nt-step chain, so in float64 and
// float32 no tensor core runs in it; the launch spreads each system over C
// SMs.
//
// The compute type CT of the kernel template is the state type T (float64,
// float32) or, for the mixed-precision variants (T = float), bf16: then
// every product of the sweep (the updates L_ji v_i, L_ij^T v_i and the
// solves X_i (g_i - acc_i)) runs on the bf16 tensor cores, one 16-row strip
// a warp, the vector in column 0 of an m16n8k16 B fragment, its operands
// rounded to bf16 as the fragments are formed and summed in fp32, as the
// Pallas kernels cast them (trsm.py:42-51, poly_interp.py:128-150,
// packed_trsm.py:61-80).  The inverses are formed at fp32 from the tile
// source's own values.  The staged type Src is the type the tiles are
// stored in: T for the dense factor, Θ's (bf16 in the mixed interp_solve),
// and the packed factor's (bf16 for a bf16-stored factor, whose values
// are then exact in fp32; float32 for a float32 factor under bf16
// products, rounded as the fragments are formed).  interp_solve's bf16 Θ:
// the diagonal tiles are Horner-evaluated at fp32 from it, the
// off-diagonal ones in bf16 as they stream (x and every step rounded).
// A chunk then holds at least 16 rows (one strip).
#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>

#include <cstdint>
#include <map>
#include <mutex>
#include <tuple>
#include <type_traits>

#include "common.cuh"

template <> struct Vec16<__nv_bfloat16> { using type = uint4; };

constexpr int kNb = 16;                 // sub-block width of the diagonal step
constexpr int kLdSub = kNb + 4;         // stride of a stored sub-block inverse

// ===========================================================================
// Part 1: moved from chol_blocked.cu

// One warp's product of an (MI*8) x (NI*8) block over depth K:
//   acc += A B,  A(r, k) = a[r * lda + k],  B(k, n) = b[k * bk + n * bn].
// Lane (g, t) = (lane / 4, lane % 4) owns C[i*8 + g][j*8 + 2t + e], e = 0, 1.
// In float64 each pair of 8-row blocks is one mma.m16n8k4.f64 (A fragment
// rows g and g + 8 at column t, B fragment row t column g, accumulator rows
// g and g + 8 at columns 2t, 2t + 1): the 16 x 8 shapes run at the FP64
// tensor-core peak, the older m8n8k4 at half of it on this card.
__device__ __forceinline__ void dmma16(double (&lo)[2], double (&hi)[2],
                                       double a0, double a1, double b) {
  asm volatile(
      "mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+d"(lo[0]), "+d"(lo[1]), "+d"(hi[0]), "+d"(hi[1])
      : "d"(a0), "d"(a1), "d"(b));
}

template <int MI, int NI>
__device__ __forceinline__ void warp_mma(double (&acc)[MI][NI][2],
                                         const double* a, int lda,
                                         const double* b, int bk, int bn,
                                         int K) {
  static_assert(MI % 2 == 0, "float64 products take 16-row blocks");
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll 4
  for (int k0 = 0; k0 < K; k0 += 4) {
    double af[MI], bf[NI];
#pragma unroll
    for (int i = 0; i < MI; ++i) af[i] = a[(i * 8 + g) * lda + k0 + t];
#pragma unroll
    for (int j = 0; j < NI; ++j) bf[j] = b[(k0 + t) * bk + (j * 8 + g) * bn];
#pragma unroll
    for (int i = 0; i < MI; i += 2)
#pragma unroll
      for (int j = 0; j < NI; ++j)
        dmma16(acc[i][j], acc[i + 1][j], af[i], af[i + 1], bf[j]);
  }
}

template <int MI, int NI>
__device__ __forceinline__ void warp_mma(float (&acc)[MI][NI][2],
                                         const float* a, int lda,
                                         const float* b, int bk, int bn,
                                         int K) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  for (int k = 0; k < K; ++k) {
    float af[MI], bf[NI][2];
#pragma unroll
    for (int i = 0; i < MI; ++i) af[i] = a[(i * 8 + g) * lda + k];
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) bf[j][e] = b[k * bk + (j * 8 + 2 * t + e) * bn];
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NI; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) acc[i][j][e] += af[i] * bf[j][e];
  }
}

// bf16 with fp32 sums (the mixed-precision variants): two values rounded
// to bf16 (to nearest even) in one register, the first in the low half
__device__ __forceinline__ unsigned bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}
__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
template <typename T>
__device__ __forceinline__ T as_value(T v) { return v; }
__device__ __forceinline__ float as_value(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// One m16n8k16 product with bf16 operands and fp32 sums: A fragment rows g
// and g + 8 at columns 2t, 2t + 1 (a0, a1) and 2t + 8, 2t + 9 (a2, a3), B
// fragment rows 2t, 2t + 1 (b0) and 2t + 8, 2t + 9 (b1) at column g,
// accumulator rows g (lo) and g + 8 (hi) at columns 2t, 2t + 1.  A product
// of two bf16 values is exact in fp32.
__device__ __forceinline__ void bmma16(float (&lo)[2], float (&hi)[2],
                                       unsigned a0, unsigned a1, unsigned a2,
                                       unsigned a3, unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(lo[0]), "+f"(lo[1]), "+f"(hi[0]), "+f"(hi[1])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// The float warp_mma's product and accumulator layout with the operands
// rounded to bf16 as the fragments are formed, on the bf16 tensor cores;
// K a multiple of 16.
template <int MI, int NI>
__device__ __forceinline__ void warp_mma_bf16(float (&acc)[MI][NI][2],
                                              const float* a, int lda,
                                              const float* b, int bk, int bn,
                                              int K) {
  static_assert(MI % 2 == 0, "bf16 products take 16-row blocks");
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  for (int k0 = 0; k0 < K; k0 += 16) {
    const int k = k0 + 2 * t;
    unsigned af[MI / 2][4], bf[NI][2];
#pragma unroll
    for (int i = 0; i < MI / 2; ++i) {
      const float* r0 = a + (i * 16 + g) * lda + k;
      const float* r1 = r0 + 8 * lda;
      af[i][0] = bf16x2(r0[0], r0[1]);
      af[i][1] = bf16x2(r1[0], r1[1]);
      af[i][2] = bf16x2(r0[8], r0[9]);
      af[i][3] = bf16x2(r1[8], r1[9]);
    }
#pragma unroll
    for (int j = 0; j < NI; ++j) {
      const float* c = b + k * bk + (j * 8 + g) * bn;
      bf[j][0] = bf16x2(c[0], c[bk]);
      bf[j][1] = bf16x2(c[8 * bk], c[9 * bk]);
    }
#pragma unroll
    for (int i = 0; i < MI / 2; ++i)
#pragma unroll
      for (int j = 0; j < NI; ++j)
        bmma16(acc[2 * i][j], acc[2 * i + 1][j], af[i][0], af[i][1], af[i][2],
               af[i][3], bf[j][0], bf[j][1]);
  }
}

// The product of compute type CT: warp_mma when CT is the state type T,
// warp_mma_bf16 when it is bf16 (T = float)
template <typename CT, int MI, int NI, typename T>
__device__ __forceinline__ void warp_product(T (&acc)[MI][NI][2], const T* a,
                                             int lda, const T* b, int bk,
                                             int bn, int K) {
  if constexpr (std::is_same<CT, T>::value)
    warp_mma<MI, NI>(acc, a, lda, b, bk, bn, K);
  else
    warp_mma_bf16<MI, NI>(acc, a, lda, b, bk, bn, K);
}

// One warp: mv += A v over the 16 rows of a strip and the depth
// [k0, k0 + 16), bf16 operands, fp32 sums.  A(r, k) = a(r, k) and v(k) =
// v(k) (floats, rounded to bf16 here); v fills column 0 of the B fragment
// (lanes with g = 0; the other columns are zero).  Row r's sum: mv[0][0]
// of lane 4r for r < 8, mv[1][0] of lane 4(r - 8) for r >= 8
// (warp_mv_store).
template <typename FA, typename FV>
__device__ __forceinline__ void warp_mv_bf16(float (&mv)[2][2], FA a, FV v,
                                             int k0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int k = k0 + 2 * t;
  const unsigned b0 = g == 0 ? bf16x2(v(k), v(k + 1)) : 0u;
  const unsigned b1 = g == 0 ? bf16x2(v(k + 8), v(k + 9)) : 0u;
  bmma16(mv[0], mv[1], bf16x2(a(g, k), a(g, k + 1)),
         bf16x2(a(g + 8, k), a(g + 8, k + 1)),
         bf16x2(a(g, k + 8), a(g, k + 9)),
         bf16x2(a(g + 8, k + 8), a(g + 8, k + 9)), b0, b1);
}
template <typename T>
__device__ __forceinline__ void warp_mv_store(const float (&mv)[2][2], T* dst) {
  const int lane = threadIdx.x & 31;
  if ((lane & 3) == 0) {
    dst[lane >> 2] = mv[0][0];
    dst[(lane >> 2) + 8] = mv[1][0];
  }
}

template <typename T, int MI, int NI>
__device__ __forceinline__ void zero(T (&acc)[MI][NI][2]) {
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j) acc[i][j][0] = acc[i][j][1] = T(0);
}

// f(r, c, value) for every element of the block this lane owns
template <typename T, int MI, int NI, typename F>
__device__ __forceinline__ void for_each_acc(const T (&acc)[MI][NI][2], F f) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) f(i * 8 + g, j * 8 + 2 * t + e, acc[i][j][e]);
}

// ---------------------------------------------------------------------------
// cp.async: 16 bytes from global to shared memory without registers
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
// one element of N bytes (4 or 8), for rows that are not 16-byte aligned
template <int N>
__device__ __forceinline__ void cp_async_elem(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s), "l"(gmem),
               "n"(N));
}
// cp_async_wait<n> for n known only at run time (0..2, the stages of the
// cluster solve's ring less two)
__device__ __forceinline__ void cp_async_wait_n(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    default: cp_async_wait<2>(); break;
  }
}

// ---------------------------------------------------------------------------
// One warp factors the symmetric 16 x 16 block whose lower triangle is at s
// (stride LD) and forms the inverse of the factor, all in registers: lane
// holds column c = lane % 16 and rows r = lane / 16 + 2q, q = 0..7, of the
// whole symmetric block (v) and of the forward-substitution residual of
// L X = I (w).  Step k broadcasts the pivot, column k of L and row k of X by
// shuffles.  Writes L (zeros above) back to s and X (zeros above) to x.
// With Factor = false the block at s is already the lower factor L (only
// its lower triangle is read): the same loop forms X = L^-1 alone, with
// a divide by the pivot in place of the reciprocal square root, and s is
// left as it is.
template <typename T, int LD, bool Factor = true>
__device__ void warp_potf2_inv(T* s, T* x) {
  const int lane = threadIdx.x & 31, c = lane & 15, half = lane >> 4;
  T v[8], w[8];
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const int r = half + 2 * q;
    if constexpr (Factor)
      v[q] = r >= c ? s[r * LD + c] : s[c * LD + r];
    else
      v[q] = r >= c ? s[r * LD + c] : T(0);
    w[q] = r == c ? T(1) : T(0);
  }
#pragma unroll
  for (int k = 0; k < kNb; ++k) {
    const int owner = c + 16 * (k & 1);         // holds row k, column c
    // every shuffle first, so only one of them is on the pivot chain
    const T d = __shfl_sync(0xffffffffu, v[k >> 1], k + 16 * (k & 1));
    const T lc0 = __shfl_sync(0xffffffffu, v[k >> 1], owner);
    const T xk0 = __shfl_sync(0xffffffffu, w[k >> 1], owner);
    T lr[8];
#pragma unroll
    for (int q = k / 2; q < 8; ++q)     // rows r = half + 2q below k - 1
      lr[q] = __shfl_sync(0xffffffffu, v[q], k + 16 * half);
    if constexpr (Factor) {
      const T rp = rsqrt(d), piv = d * rp;       // no divide on the chain
      const T lc = lc0 * rp, xk = xk0 * rp;      // L[c][k], X[k][c]
#pragma unroll
      for (int q = k / 2; q < 8; ++q) lr[q] *= rp;                  // L[r][k]
#pragma unroll
      for (int q = k / 2; q < 8; ++q) {
        const int r = half + 2 * q;
        if (r > k) {
          if (c > k) v[q] -= lr[q] * lc;
          else if (c == k) v[q] = lr[q];
          w[q] -= lr[q] * xk;
        } else if (r == k) {
          if (c == k) v[q] = piv;
          else if (c > k) v[q] = lc;
          w[q] = xk;
        }
      }
    } else {
      const T xk = xk0 / d;                      // X[k][c]
#pragma unroll
      for (int q = k / 2; q < 8; ++q) {
        const int r = half + 2 * q;
        if (r > k) w[q] -= lr[q] * xk;
        else if (r == k) w[q] = xk;
      }
    }
  }
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const int r = half + 2 * q;
    if constexpr (Factor) s[r * LD + c] = r >= c ? v[q] : T(0);
    x[r * kLdSub + c] = w[q];
  }
}

// ===========================================================================
// Part 2: the cluster triangular solve

namespace cg = cooperative_groups;

// A clock stamp of one phase of the kernel (tag: which): empty, unless a
// probe build defines it first (scripts/probe_tri_solve.py stamps).
#ifndef TRI_SOLVE_STAMP
#define TRI_SOLVE_STAMP(tag) ((void)0)
#endif

constexpr int kMaxCluster = 8;      // the portable cluster size
constexpr int kMaxStages = 4;       // chunks of the staging ring
constexpr int kStageBytes = 32768;  // aimed-at bytes of one staged chunk

// The launch plan of one call, chosen on the host by solve_plan; a launch
// reports it as kPlanInts ints in this order.
struct SolvePlan {
  int cluster;          // C, blocks per system
  int max_active;       // cudaOccupancyMaxActiveClusters at this C
  int rows_per_block;   // ceil(nt / C)
  int inv_in_smem;      // the block's diagonal inverses in shared memory
  int smem_bytes;       // dynamic shared memory of a block
  int stages;           // chunks in the staging ring
  int chunk_rows;       // tile rows of one chunk
};
constexpr int kPlanInts = 7;
// returned by tri_solve_launch when it needs a scratch tensor (nothing
// was launched)
constexpr int kNeedsScratch = -1;

// The tile source of a solve (the Source parameter of the templates)
constexpr int kDense = 0;    // the unpadded dense factor (trsm)
constexpr int kInterp = 1;   // Θ's packed coefficient planes, Horner at λ
constexpr int kPacked = 2;   // a tile-packed factor: one plane, no λ

// S: the type the tiles are stored and staged in
template <typename T, typename S = T>
struct SolveArgs {
  const S* src;       // dense: L (batch, h, h); interp: Θ (n_fold, nc, P);
                      // packed: the factors (n_fold, P)
  const T* x;         // interp: (n_lam,) λ - center at T
  T* scratch;         // (n_sys, nt, B, inv_ld) inverses kept out of shared
                      // memory, or null
  const T* g;         // dense: (batch, h, nrhs); interp, packed: (n_fold,
                      // [n_lam,] hp, nrhs), zero-padded to hp
  T* out;             // dense: (batch, h, nrhs); interp, packed: (n_fold,
                      // n_lam, hp, nrhs)
  long long P;        // interp, packed: values of one packed plane
  int h, nt, nc;      // nc: coefficient planes (1 for dense and packed)
  int n_lam, nrhs, g_per_lam;   // packed: n_lam 1, g_per_lam 0
  int sweeps;         // 1 forward (L v = g), 2 reverse (L^T v = g), 3 both
  int inv_in_smem, stages, chunk_rows;
  int vec;            // every staged row is 16-byte aligned
};

// Offsets (in values) of a block's shared memory: the forward and reverse
// solution slots (hp each), the pending sums of its rows, a reduction
// buffer, the right-hand side of a solve, the inverses of its rows (when
// in shared memory), then the work area: first the prologue's tile and
// sub-block inverses, then the staging ring.
struct SolveSmem {
  long long wf, wr, acc, red, rhs, inv, work, total;
};

// Row stride of a diagonal inverse: 16 bytes past B, so that the 16-byte
// reads of consecutive rows by consecutive threads (the forward solve) fall
// in distinct banks.
template <typename T, int B>
__host__ __device__ constexpr int inv_ld() { return B + 16 / (int)sizeof(T); }

template <typename T, int B>
__host__ __device__ inline SolveSmem solve_smem(int nt, int C, bool inv_smem,
                                                int stage_elems, int stages) {
  constexpr int LD = inv_ld<T, B>();
  const long long hp = (long long)nt * B, R = (nt + C - 1) / C;
  SolveSmem m;
  m.wf = 0;
  m.wr = hp;
  m.acc = 2 * hp;
  m.red = m.acc + R * B;
  m.rhs = m.red + kThreads;
  m.inv = m.rhs + B;
  m.work = m.inv + (inv_smem ? R * B * LD : 0);
  const long long pro = (inv_smem ? 0 : (long long)B * LD) + (long long)B * kLdSub;
  const long long ring = (long long)stages * stage_elems;
  m.total = m.work + (pro > ring ? pro : ring);
  return m;
}

__device__ __forceinline__ void cluster_arrive() {   // release semantics
  asm volatile("barrier.cluster.arrive;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {     // acquire semantics
  asm volatile("barrier.cluster.wait;\n" ::: "memory");
}

// In place: the lower B x B tile L at S (stride inv_ld; the upper part zero)
// becomes X = L^-1.  Xd: B / 16 sub-block inverses at stride kLdSub.  One
// warp per diagonal sub-block (warp_potf2_inv without the factorization),
// then X_ij = -X_ii sum_{k=j}^{i-1} L_ik X_kj block row by block row, warp
// j on block (i, j), the products on the tensor cores in float64.
template <typename T, int B>
__device__ void invert_lower_tile(T* S, T* Xd) {
  constexpr int LD = inv_ld<T, B>(), NS = B / kNb;
  const int tid = threadIdx.x, warp = tid >> 5;
  if (warp < NS)
    warp_potf2_inv<T, LD, false>(S + warp * kNb * LD + warp * kNb,
                                 Xd + warp * kNb * kLdSub);
  __syncthreads();
  for (int e = tid; e < NS * kNb * kNb; e += kThreads) {   // X_pp on the diagonal
    const int p = e / (kNb * kNb), r = e / kNb % kNb, c = e % kNb;
    S[(p * kNb + r) * LD + p * kNb + c] = Xd[p * kNb * kLdSub + r * kLdSub + c];
  }
  __syncthreads();
  for (int i = 1; i < NS; ++i) {
    const int j = warp;
    T acc[2][2][2];
    zero(acc);
    if (j < i)
      warp_mma<2, 2>(acc, S + i * kNb * LD + j * kNb, LD,
                     S + j * kNb * LD + j * kNb, LD, 1, (i - j) * kNb);
    __syncthreads();                              // row i's L has been read
    if (j < i) {
      T* tij = S + i * kNb * LD + j * kNb;
      for_each_acc(acc, [&](int r, int c, T v) { tij[r * LD + c] = v; });
      __syncwarp();
      zero(acc);
      warp_mma<2, 2>(acc, Xd + i * kNb * kLdSub, kLdSub, tij, LD, 1, kNb);
      __syncwarp();
      for_each_acc(acc, [&](int r, int c, T v) { tij[r * LD + c] = -v; });
    }
    __syncthreads();
  }
}

// One cluster per system: blockIdx.x / C is the system, the block's rank in
// the cluster its place.  Systems: dense (matrix, column), interp ((fold,
// λ), column), packed (factor, column), column fastest.  CT: the compute
// type (T, or bf16 for the mixed variants, T = float); Src: the type the
// tiles are stored in.
template <typename T, int B, int Source, typename CT, typename Src>
__global__ void __launch_bounds__(kThreads, 1)
tri_solve_kernel(const SolveArgs<T, Src> a) {
  constexpr bool kMixed = !std::is_same<CT, T>::value;
  constexpr bool kTiles = Source != kDense;   // tiles of the packed layout
  constexpr int LD = inv_ld<T, B>(), VN = 16 / sizeof(Src), NW = kThreads / 32;
  constexpr int NPH = kThreads / B;              // row phases of a column walk
  // warps that split the depth of a mixed product over a B-row result
  constexpr int KQ = NW / (B / 16);
  static_assert(B % kNb == 0 && B / kNb <= NW && B <= kThreads / 2,
                "B in 16..128");
  static_assert(!kMixed || std::is_same<T, float>::value,
                "bf16 products have float sums");
  static_assert(std::is_same<Src, T>::value ||
                    (kMixed && Source != kDense && std::is_same<Src, CT>::value),
                "tiles are stored at T, or in bf16 under bf16 products");
  using V = typename Vec16<Src>::type;
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks(), me = (int)cluster.block_rank();
  const long long sys = blockIdx.x / C;
  const int nt = a.nt, hp = nt * B, tid = threadIdx.x, lane = tid & 31,
            warp = tid >> 5;
  const int cr = a.chunk_rows, nchunk = B / cr, plane = cr * B,
            stage_elems = a.nc * plane, S = a.stages;
  const SolveSmem m = solve_smem<T, B>(
      nt, C, a.inv_in_smem, (int)(stage_elems * sizeof(Src) / sizeof(T)), S);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  T* wf = sm + m.wf;
  T* wr = sm + m.wr;
  T* acc = sm + m.acc;
  T* red = sm + m.red;
  T* rhs = sm + m.rhs;
  T* work = sm + m.work;                  // the prologue's tile and inverses
  Src* ring = reinterpret_cast<Src*>(work);   // then the staging ring

  const Src* TH;          // the system's factor (dense, packed) or
                          // coefficients (interp)
  const T* G;             // its right-hand side, column already applied
  T* O;                   // its output, column already applied
  T xv = T(0);            // λ - center (interp)
  if constexpr (kTiles) {   // packed: n_lam = 1, the factor in the fold slot
    const long long col = sys % a.nrhs, fl = sys / a.nrhs, fold = fl / a.n_lam;
    TH = a.src + fold * a.nc * a.P;
    if constexpr (Source == kInterp) xv = a.x[fl % a.n_lam];
    G = a.g + (a.g_per_lam ? fl : fold) * hp * a.nrhs + col;
    O = a.out + fl * hp * a.nrhs + col;
  } else {
    const long long col = sys % a.nrhs, mat = sys / a.nrhs;
    TH = a.src + mat * a.h * a.h;
    G = a.g + mat * a.h * a.nrhs + col;
    O = a.out + mat * a.h * a.nrhs + col;
  }
  const int nrows = kTiles ? hp : a.h;          // rows of g and out
  const long long ld = kTiles ? B : a.h;        // row stride of a tile
  // tile (ti, tj), ti >= tj, coefficient plane k: its first value, and its
  // rows (or columns) inside h
  auto tile_at = [&](int ti, int tj, int k) -> const Src* {
    if constexpr (kTiles)
      return TH + k * a.P + (long long)(tj * nt - tj * (tj - 1) / 2 + ti - tj) * B * B;
    else
      return TH + (long long)ti * B * a.h + tj * B;
  };
  auto inside = [&](int t) { return kTiles ? B : min(B, a.h - t * B); };
  auto owner = [&](int i) { return i % C; };
  auto slot = [&](int i) { return (i - me) / C; };     // place among my rows
  const int s_begin = (a.sweeps & 1) ? 0 : nt, s_end = (a.sweeps & 2) ? 2 * nt : nt;
  auto row_of = [&](int s) { return s < nt ? s : 2 * nt - 1 - s; };

  cluster.sync();       // every block has started before any remote store
  TRI_SOLVE_STAMP(1);
  for (int e = tid; e < (int)(m.red - m.acc); e += kThreads) acc[e] = T(0);

  // prologue: the inverses of my diagonal tiles
  {
    T* Xd = work + (a.inv_in_smem ? 0 : B * LD);
    for (int i = me; i < nt; i += C) {
      T* D = a.inv_in_smem ? sm + m.inv + (long long)slot(i) * B * LD : work;
      const int lo = i * B;
      const Src* t0 = tile_at(i, i, 0);
      // D(r, c) = L_ii(r, c) for c <= r, else 0; identity past h
      auto put = [&](int r, int c, T v) {
        v = c <= r ? v : T(0);
        if (r == c && lo + r >= a.h) v = kTiles ? v + T(1) : T(1);
        D[r * LD + c] = v;
      };
      // Horner at T (bf16 tiles upcast), x unrounded; one plane: the value
      if (a.vec) {                        // 16-byte loads, the lower units only
        for (int e = tid; e < B * B / VN; e += kThreads) {
          const int r = e / (B / VN), c0 = e % (B / VN) * VN;
          T qv[VN];
#pragma unroll
          for (int u = 0; u < VN; ++u) qv[u] = T(0);
          if (c0 <= r && lo + r < (kTiles ? lo + B : a.h) &&
              lo + c0 < (kTiles ? lo + B : a.h)) {
            const long long off = (long long)r * ld + c0;
            const V q = *reinterpret_cast<const V*>(t0 + (a.nc - 1) * a.P + off);
            const Src* qs = reinterpret_cast<const Src*>(&q);
#pragma unroll
            for (int u = 0; u < VN; ++u) qv[u] = as_value(qs[u]);
            for (int k = a.nc - 2; k >= 0; --k) {
              const V p = *reinterpret_cast<const V*>(t0 + k * a.P + off);
              const Src* pv = reinterpret_cast<const Src*>(&p);
#pragma unroll
              for (int u = 0; u < VN; ++u) qv[u] = qv[u] * xv + as_value(pv[u]);
            }
          }
#pragma unroll
          for (int u = 0; u < VN; ++u) put(r, c0 + u, qv[u]);
        }
      } else {
        for (int e = tid; e < B * B; e += kThreads) {
          const int r = e / B, c = e % B;
          T v = T(0);
          if (c <= r && (kTiles || lo + r < a.h)) {
            const long long off = (long long)r * ld + c;
            v = as_value(t0[(a.nc - 1) * a.P + off]);
            for (int k = a.nc - 2; k >= 0; --k)
              v = v * xv + as_value(t0[k * a.P + off]);
          }
          put(r, c, v);
        }
      }
      __syncthreads();
      invert_lower_tile<T, B>(D, Xd);
      if (!a.inv_in_smem) {
        T* dst = a.scratch + (sys * nt + i) * B * LD;
        for (int e = tid; e < B * LD; e += kThreads) dst[e] = D[e];
        __syncthreads();
      }
    }
  }
  auto inverse = [&](int i) -> const T* {
    return a.inv_in_smem ? sm + m.inv + (long long)slot(i) * B * LD
                         : a.scratch + (sys * nt + i) * B * LD;
  };

  // The stream of update jobs, in the order they are consumed: after the
  // solve of step s (forward s < nt - 1: rows j > s, ascending; reverse
  // s >= nt, row i = 2nt - 1 - s: rows j < i, descending), each of my
  // rows' tile in nchunk chunks.  The next row, when mine, comes first.
  struct Cur { int s, j, rc; };
  auto first_job = [&](int s) -> Cur {
    for (; s < s_end - 1; ++s) {
      if (s < nt - 1) {
        const int j = s + 1 + ((me - (s + 1)) % C + C) % C;
        if (j < nt) return {s, j, 0};
      } else if (s >= nt) {
        const int i = 2 * nt - 1 - s;
        const int j = i - 1 - ((i - 1 - me) % C + C) % C;
        if (j >= 0) return {s, j, 0};
      }
    }
    return {s_end, 0, 0};
  };
  auto next = [&](Cur c) -> Cur {
    if (++c.rc < nchunk) return c;
    c.rc = 0;
    if (c.s < nt) {
      c.j += C;
      if (c.j < nt) return c;
    } else {
      c.j -= C;
      if (c.j >= 0) return c;
    }
    return first_job(c.s + 1);
  };
  // tile of a job: forward (j, i), reverse (i, j)
  auto issue = [&](Cur c, int stage) {
    if (c.s < s_end) {
      const int i = row_of(c.s);
      const int ti = c.s < nt ? c.j : i, tj = c.s < nt ? i : c.j;
      const int r0 = c.rc * cr, vr = inside(ti) - r0, vc = inside(tj);
      Src* dst = ring + stage * stage_elems;
      for (int k = 0; k < a.nc; ++k) {
        const Src* src = tile_at(ti, tj, k) + r0 * ld;
        Src* d = dst + k * plane;
        if (a.vec) {
          for (int e = tid; e < plane / VN; e += kThreads) {
            const int r = e / (B / VN), cc = e % (B / VN) * VN;
            if (r < vr && cc < vc)
              cp_async16(d + r * B + cc, src + r * ld + cc);
            else
              *reinterpret_cast<V*>(d + r * B + cc) = V{};
          }
        } else if constexpr (sizeof(Src) >= 4) {   // bf16 tiles are always aligned
          for (int e = tid; e < plane; e += kThreads) {
            const int r = e / B, cc = e % B;
            if (r < vr && cc < vc)
              cp_async_elem<sizeof(Src)>(d + r * B + cc, src + r * ld + cc);
            else
              d[r * B + cc] = Src(0);
          }
        }
      }
    }
    cp_async_commit();
  };
  T xb = xv;              // x as the off-diagonal Horner takes it
  if constexpr (kMixed) xb = bf16_round(xv);
  auto value = [&](const Src* st, int off) -> T {   // Horner in registers
    if constexpr (Source == kInterp && kMixed) {   // in bf16: every step
      float v = as_value(st[(a.nc - 1) * plane + off]);   // rounded, as torch
      for (int k = a.nc - 2; k >= 0; --k)                 // rounds it
        v = bf16_round(__fadd_rn(bf16_round(__fmul_rn(v, xb)),
                                 as_value(st[k * plane + off])));
      return v;
    } else if constexpr (Source == kInterp) {
      T v = st[(a.nc - 1) * plane + off];
      for (int k = a.nc - 2; k >= 0; --k) v = v * xv + st[k * plane + off];
      return v;
    } else {            // the tile's own value (bf16 tiles exact at T)
      return as_value(st[off]);
    }
  };

  TRI_SOLVE_STAMP(2);                            // the prologue's end
  Cur pc = first_job(s_begin), cc = pc;          // producer, consumer
  int issued = 0, consumed = 0;
  for (int q = 0; q < S - 1; ++q) {
    issue(pc, issued++ % S);
    if (pc.s < s_end) pc = next(pc);
  }
  T part = T(0);        // reverse: this thread's column sum over a tile
  auto consume_tile = [&]() {
    const int i = row_of(cc.s), j = cc.j;
    const bool fwd = cc.s < nt;
    const T* v = (fwd ? wf : wr) + i * B;
    T* aj = acc + slot(j) * B;
    float racc[2][2] = {};          // mixed reverse: a warp's column sums
    for (int rc = 0; rc < nchunk; ++rc) {
      cp_async_wait_n(S - 2);
      __syncthreads();
      issue(pc, issued++ % S);
      if (pc.s < s_end) pc = next(pc);
      const Src* st = ring + (consumed++ % S) * stage_elems;
      const int r0 = rc * cr;
      if constexpr (kMixed) {
        if (fwd) {      // aj[r] += L_ji[r, :] . v: a 16-row strip of the
                        // chunk a warp, the depth split over KF warps
          const int ns = cr / 16, kf = min(NW / ns, B / 16);
          const int strip = warp % ns, kp = warp / ns;
          if (kp < kf) {
            float mv[2][2] = {};
            for (int ks = kp; ks < B / 16; ks += kf)
              warp_mv_bf16(
                  mv, [&](int r, int k) { return value(st, (strip * 16 + r) * B + k); },
                  [&](int k) { return v[k]; }, ks * 16);
            warp_mv_store(mv, red + kp * cr + strip * 16);
          }
          __syncthreads();
          if (tid < cr) {
            T s = T(0);
            for (int p = 0; p < kf; ++p) s += red[p * cr + tid];
            aj[r0 + tid] += s;
          }
        } else {        // aj[c] += L_ij[:, c] . v: a 16-column strip a warp,
                        // the tile's 16-row steps dealt over KQ warps
          const int strip = warp % (B / 16), kp = warp / (B / 16);
          for (int ks = 0; ks < cr / 16; ++ks)
            if ((r0 / 16 + ks) % KQ == kp)
              warp_mv_bf16(
                  racc, [&](int r, int k) { return value(st, k * B + strip * 16 + r); },
                  [&](int k) { return v[r0 + k]; }, ks * 16);
        }
      } else if (fwd) {               // aj[r] += L_ji[r, :] . v  (a warp a row)
        for (int rr = warp; rr < cr; rr += NW) {
          T sum = T(0);
          for (int c = lane; c < B; c += 32) sum += value(st, rr * B + c) * v[c];
          sum = warp_sum(sum);
          if (lane == 0) aj[r0 + rr] += sum;
        }
      } else {                        // aj[c] += L_ij[:, c] . v  (a thread a column)
        const int c = tid % B;
        for (int rr = tid / B; rr < cr; rr += NPH)
          part += value(st, rr * B + c) * v[r0 + rr];
      }
    }
    if (!fwd) {
      if constexpr (kMixed)
        warp_mv_store(racc, red + warp / (B / 16) * B + warp % (B / 16) * 16);
      else
        red[tid] = part;
      part = T(0);
      __syncthreads();
      if (tid < B) {
        T s = T(0);
        for (int p = 0; p < (kMixed ? KQ : NPH); ++p) s += red[p * B + tid];
        aj[tid] += s;
      }
    }
    Cur t = cc;
    t.rc = nchunk - 1;
    cc = next(t);
  };
  // v_i = X_i (rhs_i - acc_i) (X_i^T for the reverse sweep), stored into
  // every block's slot; the last sweep's values also to the output
  auto solve = [&](int s) {
    const int i = row_of(s);
    const bool fwd = s < nt, last_sweep = !fwd || !(a.sweeps & 2);
    T* ai = acc + slot(i) * B;
    __syncthreads();
    for (int r = tid; r < B; r += kThreads) {
      const int row = i * B + r;
      const T gv = !fwd && (a.sweeps & 1) ? wf[row]
                   : row < nrows ? G[(long long)row * a.nrhs] : T(0);
      rhs[r] = gv - ai[r];
      ai[r] = T(0);
    }
    __syncthreads();
    const T* X = inverse(i);
    T* dst = (fwd ? wf : wr) + i * B;
    T sum = T(0);
    if constexpr (kMixed) {   // a 16-row strip a warp, the depth over KQ warps
      const int strip = warp % (B / 16), kp = warp / (B / 16), r0 = strip * 16;
      float mv[2][2] = {};
      for (int ks = kp; ks < B / 16; ks += KQ) {
        if (fwd)
          warp_mv_bf16(mv, [&](int r, int k) { return X[(long long)(r0 + r) * LD + k]; },
                       [&](int k) { return rhs[k]; }, ks * 16);
        else
          warp_mv_bf16(mv, [&](int r, int k) { return X[(long long)k * LD + r0 + r]; },
                       [&](int k) { return rhs[k]; }, ks * 16);
      }
      warp_mv_store(mv, red + kp * B + r0);
    } else if (fwd) {     // a thread a row of X_i, 16 bytes at a time
      const int r = tid % B;
      const T* xr = X + (long long)r * LD;
      if (reinterpret_cast<uintptr_t>(X) % 16 == 0 && LD % VN == 0) {
        for (int c = tid / B * VN; c < B; c += NPH * VN) {
          const V q = *reinterpret_cast<const V*>(xr + c);
          const T* qv = reinterpret_cast<const T*>(&q);
#pragma unroll
          for (int u = 0; u < VN; ++u) sum += qv[u] * rhs[c + u];
        }
      } else {
        for (int c = tid / B; c < B; c += NPH) sum += xr[c] * rhs[c];
      }
    } else {              // a thread a column of X_i
      const int c = tid % B;
      for (int r = tid / B; r < B; r += NPH) sum += X[(long long)r * LD + c] * rhs[r];
    }
    if constexpr (!kMixed) red[tid] = sum;
    __syncthreads();
    if (tid < B) {
      T v = T(0);
      for (int p = 0; p < (kMixed ? KQ : NPH); ++p) v += red[p * B + tid];
      for (int b = 0; b < C; ++b) *cluster.map_shared_rank(dst + tid, b) = v;
      if (last_sweep && i * B + tid < nrows) O[(long long)(i * B + tid) * a.nrhs] = v;
    }
  };

  if (owner(row_of(s_begin)) == me) solve(s_begin);
  cluster_arrive();
  for (int s = s_begin; s < s_end; ++s) {
    TRI_SOLVE_STAMP(100 + s);
    cluster_wait();                               // v of step s everywhere
    TRI_SOLVE_STAMP(200 + s);
    const bool last = s + 1 == s_end;
    if (!last && owner(row_of(s + 1)) == me) {    // look-ahead
      if (s != nt - 1) consume_tile();            // the next row's update
      TRI_SOLVE_STAMP(300 + s);
      solve(s + 1);
      TRI_SOLVE_STAMP(400 + s);
    }
    if (!last) cluster_arrive();
    while (cc.s == s) consume_tile();
    TRI_SOLVE_STAMP(500 + s);
  }
}

// ---------------------------------------------------------------------------
// Host side: the plan (cluster size by occupancy, shared-memory layout),
// chosen once per device and shape, and the cluster launch.

// Src: the type the tiles are staged in; min_rows: the fewest rows of a
// chunk (16, one strip of a bf16 product, for the mixed variants)
template <typename T, typename Src, int B>
bool solve_layout(int nt, int nc, int C, int max_smem, int min_rows,
                  SolvePlan* p) {
  int cr0 = min_rows > 8 ? min_rows : 8;
  while (cr0 * 2 <= B && (long long)cr0 * 2 * nc * B * sizeof(Src) <= kStageBytes)
    cr0 *= 2;
  if (cr0 > B) cr0 = B;
  for (int cr = cr0; cr >= min_rows; cr /= 2)
    for (int in_smem = 1; in_smem >= 0; --in_smem)
      for (int st = kMaxStages; st >= 2; --st) {
        const SolveSmem m = solve_smem<T, B>(
            nt, C, in_smem, (int)(nc * cr * B * sizeof(Src) / sizeof(T)), st);
        const long long bytes = m.total * (long long)sizeof(T);
        if (bytes <= max_smem) {
          *p = SolvePlan{C, 0, (nt + C - 1) / C, in_smem, (int)bytes, st, cr};
          return true;
        }
      }
  return false;
}

// The plan of one instantiation (each has a cache of its own, so the three
// tile sources, the compute types and the staged types never share one),
// per device and shape.
template <typename T, int B, int Source, typename CT, typename Src>
int solve_plan(int nt, int nc, long long n_sys, SolvePlan* best) {
  constexpr bool kMixed = !std::is_same<CT, T>::value;
  static std::mutex mu;
  static std::map<std::tuple<int, int, int, long long>, SolvePlan> cache;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  const auto key = std::make_tuple(dev, nt, nc, n_sys);
  std::lock_guard<std::mutex> lock(mu);
  const auto hit = cache.find(key);
  if (hit != cache.end()) {
    *best = hit->second;
    return 0;
  }
  int max_smem = 0;
  err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  auto kern = tri_solve_kernel<T, B, Source, CT, Src>;
  bool found = false;
  long long best_score = 0;
  for (int C = kMaxCluster; C >= 1; C /= 2) {
    if (C > nt && C > 1) continue;
    SolvePlan p;
    if (!solve_layout<T, Src, B>(nt, nc, C, max_smem, kMixed ? 16 : 1, &p))
      continue;
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               p.smem_bytes);
    if (err != cudaSuccess) return (int)err;
    cudaLaunchAttribute attr;
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = C;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(C, 1, 1);
    cfg.blockDim = dim3(kThreads, 1, 1);
    cfg.dynamicSmemBytes = p.smem_bytes;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
    int n = 0;
    err = cudaOccupancyMaxActiveClusters(&n, kern, &cfg);
    if (err != cudaSuccess) return (int)err;
    if (n <= 0) continue;
    p.max_active = n;
    // time ~ waves of clusters x the time of one system, ~ 1 / C
    const long long score = (n_sys + n - 1) / n * (kMaxCluster / C);
    if (!found || score < best_score) {
      *best = p;
      best_score = score;
      found = true;
    }
  }
  if (!found) return (int)cudaErrorInvalidConfiguration;
  cache.emplace(key, *best);
  return 0;
}

template <typename T, int B, int Source, typename CT, typename Src>
int solve_launch(SolveArgs<T, Src> a, long long n_sys, int* plan_out,
                 cudaStream_t stream) {
  SolvePlan p;
  int rc = solve_plan<T, B, Source, CT, Src>(a.nt, a.nc, n_sys, &p);
  if (rc) return rc;
  if (plan_out) {
    const int v[kPlanInts] = {p.cluster, p.max_active, p.rows_per_block,
                              p.inv_in_smem, p.smem_bytes, p.stages, p.chunk_rows};
    for (int k = 0; k < kPlanInts; ++k) plan_out[k] = v[k];
  }
  if (!p.inv_in_smem && a.scratch == nullptr) return kNeedsScratch;
  if (n_sys * p.cluster > 2147483647LL) return (int)cudaErrorInvalidValue;
  a.inv_in_smem = p.inv_in_smem;
  a.stages = p.stages;
  a.chunk_rows = p.chunk_rows;
  auto kern = tri_solve_kernel<T, B, Source, CT, Src>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem_bytes);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = p.cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(n_sys * p.cluster), 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = p.smem_bytes;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kern, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The launch of one call, B at run time (one of 16, 32, 64, 128).  The
// plan (cached per device and shape) goes to plan_out, when given, as
// kPlanInts ints in SolvePlan's order.  Returns kNeedsScratch, launching
// nothing, when the inverses the kernel forms do not fit in shared memory
// and a.scratch is null.  Source: kDense, kInterp or kPacked; CT: the
// compute type (T, or bf16 with T = float for the mixed variants); Src:
// the type the tiles are stored in (T, or bf16 for Θ or a packed factor
// under bf16 products).
template <typename T, int Source, typename CT = T, typename Src = T>
int tri_solve_launch(const SolveArgs<T, Src>& a, int B, long long n_sys,
                     int* plan_out, cudaStream_t stream) {
  switch (B) {
    case 16: return solve_launch<T, 16, Source, CT, Src>(a, n_sys, plan_out, stream);
    case 32: return solve_launch<T, 32, Source, CT, Src>(a, n_sys, plan_out, stream);
    case 64: return solve_launch<T, 64, Source, CT, Src>(a, n_sys, plan_out, stream);
    case 128: return solve_launch<T, 128, Source, CT, Src>(a, n_sys, plan_out, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
