// Device code shared by the port's dense-tile kernels, and the
// thread-block-cluster triangular solve of the dense trsm (trsm.cu), the
// fused interp-solve (poly_interp.cu) and the packed trsm (packed_trsm.cu).
//
// Part 1, moved here from chol_blocked.cu (the Cholesky's diagonal step
// and the solves' prologue use it): the FP64 tensor-core product of one
// warp (mma.sync m16n8k4, with a CUDA-core float32 overload), its bf16
// tensor-core form for the mixed-precision variants (warp_mma_bf16,
// mma.sync m16n8k16 with fp32 sums), the one-column products of the mixed
// cluster solve (warp_mv_smem: A by ldmatrix from a bf16 tile;
// warp_mv_global), bf16 pair arithmetic, cp.async and the bulk-copy engine
// with its mbarriers, and the warp-level factor-and-inverse of a 16 x 16
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
// The mixed-precision variants (T = float, bf16 products with fp32 sums,
// as the Pallas kernels cast them: trsm.py:42-51, poly_interp.py:128-150,
// packed_trsm.py:61-80) run tri_solve_mixed_kernel: the same walk, with
// every product on the bf16 tensor cores, one 16-row strip a warp, the
// vector in column 0 of an m16n8k16 B fragment, and each operand rounded
// to bf16 once where it is stored (the inverses, formed at fp32 from the
// tile source's own values; each staged chunk of L, Horner-evaluated in
// bf16 from a bf16 Θ with x and every step rounded) and read by ldmatrix;
// the ring is fed by the bulk-copy engine.  Its notes are at the kernel.
// The staged type Src is the type the tiles are stored in: T for the
// dense factor, Θ's (bf16 in the mixed interp_solve), and the packed
// factor's (bf16 for a bf16-stored factor, whose values are then exact in
// fp32; float32 for a float32 factor under bf16 products).
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

// ldmatrix: four 8 x 8 bf16 matrices from shared memory, lane l giving the
// address of row l % 8 of matrix l / 8; matrix m lands in r[m] (lane (g, t)
// holds its row g, columns 2t, 2t + 1; with .trans its transpose's)
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_trans(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// The B fragment of a vector: v(k0 + 2t ..) rounded to bf16 in column 0
// (lanes with g = 0; the other columns zero)
__device__ __forceinline__ void vec_fragment(const float* v, unsigned& b0,
                                             unsigned& b1) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  b0 = g == 0 ? bf16x2(v[2 * t], v[2 * t + 1]) : 0u;
  b1 = g == 0 ? bf16x2(v[2 * t + 8], v[2 * t + 9]) : 0u;
}

// One warp: mv += A v over a 16 x 16 bf16 block A and v(0..15) (floats,
// rounded to bf16 here), fp32 sums.  A(r, k) = a[r * ld + k], or
// a[k * ld + r] when Trans, in shared memory (ld a multiple of 8, rows
// 16-byte aligned): the A fragment by one ldmatrix.x4.  Row r's sum:
// mv[0][0] of lane 4r for r < 8, mv[1][0] of lane 4(r - 8) for r >= 8
// (warp_mv_store).
template <bool Trans>
__device__ __forceinline__ void warp_mv_smem(float (&mv)[2][2],
                                             const __nv_bfloat16* a, int ld,
                                             const float* v) {
  const int lane = threadIdx.x & 31, m = lane >> 3, rr = lane & 7;
  unsigned f[4], b0, b1;
  if constexpr (Trans)
    ldsm_x4_trans(f, a + (8 * (m >> 1) + rr) * ld + 8 * (m & 1));
  else
    ldsm_x4(f, a + (8 * (m & 1) + rr) * ld + 8 * (m >> 1));
  vec_fragment(v, b0, b1);
  bmma16(mv[0], mv[1], f[0], f[1], f[2], f[3], b0, b1);
}
// the same with A(r, k) = a[r * ld + k] in global memory (pairs of bf16
// read as 32-bit words)
__device__ __forceinline__ void warp_mv_global(float (&mv)[2][2],
                                               const __nv_bfloat16* a, int ld,
                                               const float* v) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  auto w = [&](int r, int k) {
    return *reinterpret_cast<const unsigned*>(a + (long long)r * ld + k);
  };
  unsigned b0, b1;
  vec_fragment(v, b0, b1);
  bmma16(mv[0], mv[1], w(g, 2 * t), w(g + 8, 2 * t), w(g, 2 * t + 8),
         w(g + 8, 2 * t + 8), b0, b1);
}

// bf16 pairs: a * b and a + b, each rounded once to bf16 (to nearest even;
// no contraction into an fma).  A product of two bf16 values is exact in
// fp32 and a sum of two is exact there unless their exponents differ by
// more than 16 (then both roundings give the larger), so these equal the
// fp32 operation rounded to bf16.
__device__ __forceinline__ unsigned bf16x2_mul(unsigned a, unsigned b) {
  unsigned d;
  asm("mul.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
__device__ __forceinline__ unsigned bf16x2_add(unsigned a, unsigned b) {
  unsigned d;
  asm("add.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
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
// the same for the mixed kernel's ring (0..7: its stages less one)
__device__ __forceinline__ void cp_async_wait_ring(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    case 5: cp_async_wait<5>(); break;
    case 6: cp_async_wait<6>(); break;
    default: cp_async_wait<7>(); break;
  }
}

// ---------------------------------------------------------------------------
// The bulk-copy engine and its barriers: an mbarrier counts the bytes of
// the copies it waits for.
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// waits for the phase; a copy that never lands (some 2 s of cycles) traps,
// so a fault shows as a launch error and not as a hung card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_addr(bar);
  const long long t0 = clock64();
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (!done && clock64() - t0 > 4000000000LL) __trap();
  } while (!done);
}

// bytes (a multiple of 16, both addresses 16-byte aligned) from global to
// shared memory, counted on bar
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
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

// The diagonal tile whose first value is at t0 (its rows from lo), read
// into D (stride inv_ld): D(r, c) = L_ii(r, c) for c <= r, else 0, the
// identity past h; Horner at T from Θ's planes (bf16 upcast), x unrounded;
// one plane: the value.  Planes > 0 (Θ in the mixed kernel, nc <= Planes,
// 16-byte rows): the loads of every plane of a unit are issued before its
// Horner steps, the same steps in the same order.
template <typename T, int B, int Source, typename Src, int Planes = 0>
__device__ __forceinline__ void diag_tile(T* D, const Src* t0,
                                          const SolveArgs<T, Src>& a, int lo,
                                          T xv) {
  constexpr bool kTiles = Source != kDense;
  constexpr int LD = inv_ld<T, B>(), VN = 16 / sizeof(Src);
  using V = typename Vec16<Src>::type;
  const int tid = threadIdx.x;
  const long long ld = kTiles ? B : a.h;
  auto put = [&](int r, int c, T v) {
    v = c <= r ? v : T(0);
    if (r == c && lo + r >= a.h) v = kTiles ? v + T(1) : T(1);
    D[r * LD + c] = v;
  };
  if (Planes > 0 && a.vec && a.nc <= Planes) {
#pragma unroll 2
    for (int e = tid; e < B * B / VN; e += kThreads) {
      const int r = e / (B / VN), c0 = e % (B / VN) * VN;
      T qv[VN];
#pragma unroll
      for (int u = 0; u < VN; ++u) qv[u] = T(0);
      if (c0 <= r && lo + r < (kTiles ? lo + B : a.h) &&
          lo + c0 < (kTiles ? lo + B : a.h)) {
        const long long off = (long long)r * ld + c0;
        V p[Planes > 0 ? Planes : 1];
#pragma unroll
        for (int k = 0; k < Planes; ++k)
          if (k < a.nc) p[k] = *reinterpret_cast<const V*>(t0 + k * a.P + off);
#pragma unroll
        for (int k = Planes - 1; k >= 0; --k) {
          const Src* pv = reinterpret_cast<const Src*>(&p[k]);
          if (k == a.nc - 1) {
#pragma unroll
            for (int u = 0; u < VN; ++u) qv[u] = as_value(pv[u]);
          } else if (k < a.nc - 1) {
#pragma unroll
            for (int u = 0; u < VN; ++u) qv[u] = qv[u] * xv + as_value(pv[u]);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < VN; ++u) put(r, c0 + u, qv[u]);
    }
  } else if (a.vec) {                 // 16-byte loads, the lower units only
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
}

// What the two cluster-solve kernels (one dtype, mixed) share: the system
// a cluster solves, the schedule of its steps and update jobs, a solve's
// right-hand side and the store of its solution.

// The system's factor (dense, packed) or coefficients (interp), its
// right-hand side and its output (column already applied), and λ - center
// (interp).  Systems: dense (matrix, column), interp ((fold, λ), column),
// packed (factor, column; n_lam = 1, the factor in the fold slot), column
// fastest.
template <typename T, typename Src>
struct SolveSystem {
  const Src* TH;
  const T* G;
  T* O;
  T xv;
};

template <int Source, typename T, typename Src>
__device__ __forceinline__ SolveSystem<T, Src> solve_system(
    const SolveArgs<T, Src>& a, long long sys, int hp) {
  SolveSystem<T, Src> y;
  y.xv = T(0);
  if constexpr (Source != kDense) {
    const long long col = sys % a.nrhs, fl = sys / a.nrhs, fold = fl / a.n_lam;
    y.TH = a.src + fold * a.nc * a.P;
    if constexpr (Source == kInterp) y.xv = a.x[fl % a.n_lam];
    y.G = a.g + (a.g_per_lam ? fl : fold) * hp * a.nrhs + col;
    y.O = a.out + fl * hp * a.nrhs + col;
  } else {
    const long long col = sys % a.nrhs, mat = sys / a.nrhs;
    y.TH = a.src + mat * a.h * a.h;
    y.G = a.g + mat * a.h * a.nrhs + col;
    y.O = a.out + mat * a.h * a.nrhs + col;
  }
  return y;
}

// The schedule of a block in its cluster of C: tile row i is owned by block
// i % C; step s solves row row_of(s) (forward s < nt, reverse after).  The
// stream of update jobs, in the order they are consumed: after the solve
// of step s (forward s < nt - 1: rows j > s, ascending; reverse s >= nt,
// row i = 2nt - 1 - s: rows j < i, descending), each of my rows' tile in
// nchunk chunks.  The next row, when mine, comes first.
struct SolveSchedule {
  struct Cur { int s, j, rc; };
  int nt, C, me, nchunk, s_begin, s_end;

  __device__ __forceinline__ SolveSchedule(int nt_, int C_, int me_,
                                           int nchunk_, int sweeps)
      : nt(nt_), C(C_), me(me_), nchunk(nchunk_),
        s_begin((sweeps & 1) ? 0 : nt_), s_end((sweeps & 2) ? 2 * nt_ : nt_) {}
  __device__ __forceinline__ int owner(int i) const { return i % C; }
  // place among my rows
  __device__ __forceinline__ int slot(int i) const { return (i - me) / C; }
  __device__ __forceinline__ int row_of(int s) const {
    return s < nt ? s : 2 * nt - 1 - s;
  }
  __device__ __forceinline__ Cur first_job(int s) const {
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
  }
  __device__ __forceinline__ Cur next(Cur c) const {
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
  }
  // tile of a job: forward (j, i), reverse (i, j)
  __device__ __forceinline__ void job_tile(const Cur& c, int& ti, int& tj) const {
    const int i = row_of(c.s);
    ti = c.s < nt ? c.j : i;
    tj = c.s < nt ? i : c.j;
  }
  // The steps: the first row's solve, then per step a cluster barrier (v
  // of step s everywhere), the next row's update and solve when it is mine
  // (look-ahead), and every other update job of step s.  cc: the consumer's
  // job, advanced by consume_tile.
  template <typename Solve, typename Consume>
  __device__ __forceinline__ void run(const Cur& cc, Solve&& solve,
                                      Consume&& consume_tile) const {
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
};

// A solve's right-hand side: rhs = g_i - acc_i (the reverse sweep after a
// forward one: g_i = the forward solution wf_i), acc_i cleared; between
// two block barriers.
template <typename T, int B>
__device__ __forceinline__ void solve_rhs(T* rhs, T* ai, const T* wf,
                                          const T* G, int i, bool from_wf,
                                          int nrows, int nrhs) {
  __syncthreads();
  for (int r = threadIdx.x; r < B; r += kThreads) {
    const int row = i * B + r;
    const T gv = from_wf ? wf[row] : row < nrows ? G[(long long)row * nrhs] : T(0);
    rhs[r] = gv - ai[r];
    ai[r] = T(0);
  }
  __syncthreads();
}

// v_i = the sum of the np partials of red (stride B, in order), stored into
// every block's slot dst; the last sweep's values also to the output O.
template <typename T, int B>
__device__ __forceinline__ void store_solution(cg::cluster_group& cluster, int C,
                                               const T* red, int np, T* dst,
                                               T* O, int i, bool last_sweep,
                                               int nrows, int nrhs) {
  __syncthreads();
  const int tid = threadIdx.x;
  if (tid < B) {
    T v = T(0);
    for (int p = 0; p < np; ++p) v += red[p * B + tid];
    for (int b = 0; b < C; ++b) *cluster.map_shared_rank(dst + tid, b) = v;
    if (last_sweep && i * B + tid < nrows) O[(long long)(i * B + tid) * nrhs] = v;
  }
}

// One cluster per system: blockIdx.x / C is the system (solve_system), the
// block's rank in the cluster its place.  One dtype T throughout (float64,
// float32); the mixed variants run tri_solve_mixed_kernel.
template <typename T, int B, int Source>
__global__ void __launch_bounds__(kThreads, 1)
tri_solve_kernel(const SolveArgs<T> a) {
  using Src = T;
  constexpr bool kTiles = Source != kDense;   // tiles of the packed layout
  constexpr int LD = inv_ld<T, B>(), VN = 16 / sizeof(Src), NW = kThreads / 32;
  constexpr int NPH = kThreads / B;              // row phases of a column walk
  static_assert(B % kNb == 0 && B / kNb <= NW && B <= kThreads / 2,
                "B in 16..128");
  using V = typename Vec16<Src>::type;
  using Cur = SolveSchedule::Cur;
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

  const SolveSystem<T, Src> y = solve_system<Source>(a, sys, hp);
  const SolveSchedule sc(nt, C, me, nchunk, a.sweeps);
  const int nrows = kTiles ? hp : a.h;          // rows of g and out
  const long long ld = kTiles ? B : a.h;        // row stride of a tile
  // tile (ti, tj), ti >= tj, coefficient plane k: its first value, and its
  // rows (or columns) inside h
  auto tile_at = [&](int ti, int tj, int k) -> const Src* {
    if constexpr (kTiles)
      return y.TH + k * a.P + (long long)(tj * nt - tj * (tj - 1) / 2 + ti - tj) * B * B;
    else
      return y.TH + (long long)ti * B * a.h + tj * B;
  };
  auto inside = [&](int t) { return kTiles ? B : min(B, a.h - t * B); };

  cluster.sync();       // every block has started before any remote store
  TRI_SOLVE_STAMP(1);
  for (int e = tid; e < (int)(m.red - m.acc); e += kThreads) acc[e] = T(0);

  // prologue: the inverses of my diagonal tiles
  {
    T* Xd = work + (a.inv_in_smem ? 0 : B * LD);
    for (int i = me; i < nt; i += C) {
      T* D = a.inv_in_smem ? sm + m.inv + (long long)sc.slot(i) * B * LD : work;
      diag_tile<T, B, Source>(D, tile_at(i, i, 0), a, i * B, y.xv);
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
    return a.inv_in_smem ? sm + m.inv + (long long)sc.slot(i) * B * LD
                         : a.scratch + (sys * nt + i) * B * LD;
  };

  // the chunk of job c into stage, by every thread's cp.async
  auto issue = [&](Cur c, int stage) {
    if (c.s < sc.s_end) {
      int ti, tj;
      sc.job_tile(c, ti, tj);
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
  auto value = [&](const Src* st, int off) -> T {   // Horner in registers
    if constexpr (Source == kInterp) {
      T v = st[(a.nc - 1) * plane + off];
      for (int k = a.nc - 2; k >= 0; --k) v = v * y.xv + st[k * plane + off];
      return v;
    } else {            // the tile's own value
      return st[off];
    }
  };

  TRI_SOLVE_STAMP(2);                            // the prologue's end
  Cur pc = sc.first_job(sc.s_begin), cc = pc;    // producer, consumer
  int issued = 0, consumed = 0;
  for (int q = 0; q < S - 1; ++q) {
    issue(pc, issued++ % S);
    if (pc.s < sc.s_end) pc = sc.next(pc);
  }
  T part = T(0);        // reverse: this thread's column sum over a tile
  auto consume_tile = [&]() {
    const int i = sc.row_of(cc.s), j = cc.j;
    const bool fwd = cc.s < nt;
    const T* v = (fwd ? wf : wr) + i * B;
    T* aj = acc + sc.slot(j) * B;
    for (int rc = 0; rc < nchunk; ++rc) {
      cp_async_wait_n(S - 2);
      __syncthreads();
      issue(pc, issued++ % S);
      if (pc.s < sc.s_end) pc = sc.next(pc);
      const Src* st = ring + (consumed++ % S) * stage_elems;
      const int r0 = rc * cr;
      if (fwd) {                      // aj[r] += L_ji[r, :] . v  (a warp a row)
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
      red[tid] = part;
      part = T(0);
      __syncthreads();
      if (tid < B) {
        T s = T(0);
        for (int p = 0; p < NPH; ++p) s += red[p * B + tid];
        aj[tid] += s;
      }
    }
    Cur t = cc;
    t.rc = nchunk - 1;
    cc = sc.next(t);
  };
  // v_i = X_i (rhs_i - acc_i) (X_i^T for the reverse sweep), stored into
  // every block's slot; the last sweep's values also to the output
  auto solve = [&](int s) {
    const int i = sc.row_of(s);
    const bool fwd = s < nt, last_sweep = !fwd || !(a.sweeps & 2);
    solve_rhs<T, B>(rhs, acc + sc.slot(i) * B, wf, y.G, i,
                    !fwd && (a.sweeps & 1), nrows, a.nrhs);
    const T* X = inverse(i);
    T sum = T(0);
    if (fwd) {            // a thread a row of X_i, 16 bytes at a time
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
    red[tid] = sum;
    store_solution<T, B>(cluster, C, red, NPH, (fwd ? wf : wr) + i * B, y.O, i,
                         last_sweep, nrows, a.nrhs);
  };

  sc.run(cc, solve, consume_tile);
}

// ---------------------------------------------------------------------------
// The mixed-precision cluster solve (T = float, bf16 products): the same
// systems, cluster, schedule (SolveSchedule: owner rows, job stream,
// look-ahead, barriers) as tri_solve_kernel, and the same sums in the same
// order, with every operand of a product rounded to bf16 once, where it is
// stored:
//   - the inverse X_i, formed at float32 by invert_lower_tile, is kept only
//     as bf16: in shared memory (row stride B + 8) when the block's rows
//     fit, else as X_i and X_i^T, B x B each, in the caller's scratch;
//   - each staged chunk of L is turned once into a bf16 tile (row stride
//     B + 8; two of them, so one barrier a chunk): Θ's planes Horner-
//     evaluated in bf16 pairs in the order of the Pallas kernel (x rounded,
//     every product and sum rounded), a float32 chunk rounded, a bf16
//     factor's chunk copied; zeros past h;
//   - the A fragments of every product come from those tiles by ldmatrix
//     (.trans for L^T and X^T), the vector in column 0 of the B fragment
//     (warp_mv_smem).
// The ring of Θ's or a packed factor's chunks is fed by the bulk-copy
// engine: a lane of warp 0 arms the stage's mbarrier with the chunk's
// bytes and issues one cp.async.bulk a coefficient plane (a contiguous
// cr x B run); the threads only turn chunks into tiles and multiply.  The
// dense factor's chunk (cr rows h apart) is fed by the threads' cp.async,
// 16 bytes each.  A stage is refilled S chunks ahead as soon as its chunk
// is a tile.  Sources that are not 16-byte aligned (a dense factor with
// h % 4 != 0, a float32 packed factor with P % 4 != 0) are read into the
// tiles straight from global memory.  The forward update sums its depth
// partials every chunk, the reverse update once a tile (as
// tri_solve_kernel); the depth split (kf warps a strip) is that of the
// one-dtype plan's chunk (mixed_depth_split), whatever the chunk, so the
// bits do not depend on the plan.  The prologue reads Θ's diagonal tiles
// with every plane of a unit loaded before its Horner steps (the same
// float32 steps), inverts them as tri_solve_kernel does, and stores the
// bf16 inverse 16 bytes a step.  Two blocks an SM (kMixedBlocksPerSm: at
// most 128 registers) where the shared memory allows.
// scripts/ab_tri_solve_mixed.py builds each element undone, and the
// designs tried and not kept, as edits of this source.

// row stride (in bf16 values) of a stored bf16 tile or inverse: 16 bytes
// past B, so the 8 rows of an ldmatrix fall in distinct banks
template <int B>
__host__ __device__ constexpr int bf_ld() { return B + 8; }

constexpr int kMixedMaxStages = 8;    // chunks of the mixed kernel's ring
constexpr int kMixedBlocksPerSm = 2;  // the mixed kernel's launch bound
constexpr int kMixedDiagPlanes = 4;   // Θ planes of the prologue loaded at once

// warps that split the depth of a forward update's strip: those of the
// chunk the one-dtype plan takes first (rows doubled from 16 while a chunk
// of nc planes stays within kStageBytes), min(8 / strips, B / 16)
__host__ __device__ inline int mixed_depth_split(int B, int nc,
                                                 int src_bytes) {
  int cr = 16;
  while (cr * 2 <= B && (long long)cr * 2 * nc * B * src_bytes <= kStageBytes)
    cr *= 2;
  const int kf = (kThreads / 32) / (cr / 16);
  return kf < B / 16 ? kf : B / 16;
}

// Byte offsets of a block's shared memory: the solution slots, pending
// sums, reduction buffer and right-hand side (floats), the ring's
// mbarriers, the bf16 inverses of its rows (when in shared memory), then
// the work area: the prologue's float32 tile and sub-block inverses, then
// the ring's stages and the two bf16 tiles.
struct MixedSmem {
  long long wf, wr, acc, red, rhs, bar, inv, work, tiles, total;
};

template <int B>
__host__ __device__ inline MixedSmem mixed_smem(int nt, int C, bool inv_smem,
                                                int kf, long long stage_bytes,
                                                int stages, int cr) {
  constexpr int LD = inv_ld<float, B>(), BL = bf_ld<B>();
  constexpr int KQ = (kThreads / 32) / (B / 16);
  const long long hp = (long long)nt * B, R = (nt + C - 1) / C;
  auto up = [](long long o, long long al) { return (o + al - 1) / al * al; };
  MixedSmem m;
  m.wf = 0;
  m.wr = hp * 4;
  m.acc = 2 * hp * 4;
  m.red = m.acc + R * B * 4;
  m.rhs = m.red + (long long)(kf > KQ ? kf : KQ) * B * 4;
  m.bar = up(m.rhs + B * 4, 16);
  m.inv = up(m.bar + kMixedMaxStages * 8, 128);
  m.work = m.inv + (inv_smem ? R * B * BL * 2 : 0);
  const long long pro = ((long long)B * LD + (long long)B * kLdSub) * 4;
  m.tiles = m.work + stages * stage_bytes;
  const long long ring = stages * stage_bytes + 2LL * cr * BL * 2;
  m.total = m.work + (pro > ring ? pro : ring);
  return m;
}

template <int B, int Source, typename Src>
__global__ void __launch_bounds__(kThreads, kMixedBlocksPerSm)
tri_solve_mixed_kernel(const SolveArgs<float, Src> a) {
  using T = float;
  using bf16 = __nv_bfloat16;
  using Cur = SolveSchedule::Cur;
  constexpr bool kTiles = Source != kDense;
  constexpr int LD = inv_ld<T, B>(), BL = bf_ld<B>(), NW = kThreads / 32;
  constexpr int KQ = NW / (B / 16);     // warps on the depth of a B-row result
  static_assert(B % kNb == 0 && B / kNb <= NW && B <= kThreads / 2,
                "B in 16..128");
  static_assert(std::is_same<Src, T>::value ||
                    (Source != kDense && std::is_same<Src, bf16>::value),
                "tiles are stored at float32, or in bf16 (Θ, a packed factor)");
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks(), me = (int)cluster.block_rank();
  const long long sys = blockIdx.x / C;
  const int nt = a.nt, hp = nt * B, tid = threadIdx.x, lane = tid & 31,
            warp = tid >> 5;
  const int cr = a.chunk_rows, nchunk = B / cr, plane = cr * B, S = a.stages;
  const int kf = mixed_depth_split(B, a.nc, sizeof(Src));
  const long long stage_bytes = a.vec ? (long long)a.nc * plane * sizeof(Src) : 0;
  const MixedSmem m =
      mixed_smem<B>(nt, C, a.inv_in_smem, kf, stage_bytes, S, cr);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* wf = reinterpret_cast<T*>(smem_raw + m.wf);
  T* wr = reinterpret_cast<T*>(smem_raw + m.wr);
  T* acc = reinterpret_cast<T*>(smem_raw + m.acc);
  T* red = reinterpret_cast<T*>(smem_raw + m.red);
  T* rhs = reinterpret_cast<T*>(smem_raw + m.rhs);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem_raw + m.bar);
  bf16* inv_s = reinterpret_cast<bf16*>(smem_raw + m.inv);
  T* work = reinterpret_cast<T*>(smem_raw + m.work);
  unsigned char* ring = smem_raw + m.work;
  bf16* tiles = reinterpret_cast<bf16*>(smem_raw + m.tiles);
  const bool bulk = a.vec && kTiles;    // the ring fed by bulk copies

  const SolveSystem<T, Src> y = solve_system<Source>(a, sys, hp);
  const SolveSchedule sc(nt, C, me, nchunk, a.sweeps);
  const int nrows = kTiles ? hp : a.h;
  const long long ld = kTiles ? B : a.h;
  auto tile_at = [&](int ti, int tj, int k) -> const Src* {
    if constexpr (kTiles)
      return y.TH + k * a.P + (long long)(tj * nt - tj * (tj - 1) / 2 + ti - tj) * B * B;
    else
      return y.TH + (long long)ti * B * a.h + tj * B;
  };
  auto inside = [&](int t) { return kTiles ? B : min(B, a.h - t * B); };

  if (tid == 0 && bulk)
    for (int q = 0; q < S; ++q) mbar_init(&full[q], 1);
  cluster.sync();       // every block has started before any remote store
  TRI_SOLVE_STAMP(1);
  for (int e = tid; e < (int)((m.red - m.acc) / 4); e += kThreads) acc[e] = T(0);

  // prologue: the inverses of my diagonal tiles, formed at float32 and
  // kept in bf16
  auto scratch_inv = [&](int i, int transposed) {
    return reinterpret_cast<bf16*>(a.scratch) +
           ((sys * nt + i) * 2 + transposed) * (long long)B * B;
  };
  for (int i = me; i < nt; i += C) {
    T* D = work;
    diag_tile<T, B, Source, Src, (Source == kInterp ? kMixedDiagPlanes : 0)>(
        D, tile_at(i, i, 0), a, i * B, y.xv);
    __syncthreads();
    TRI_SOLVE_STAMP(10 + 3 * sc.slot(i));         // the tile read
    invert_lower_tile<T, B>(D, work + B * LD);
    TRI_SOLVE_STAMP(11 + 3 * sc.slot(i));         // inverted
    // 8 values (16 bytes) a step: X's rows from D's rows; X^T's rows from
    // D's columns, consecutive threads on consecutive rows of X^T (distinct
    // banks of D)
    bf16* X = a.inv_in_smem ? inv_s + (long long)sc.slot(i) * B * BL
                            : scratch_inv(i, 0);
    const int xld = a.inv_in_smem ? BL : B;
    for (int e = tid; e < B * B / 8; e += kThreads) {
      const int r = e / (B / 8), c = e % (B / 8) * 8;
      const float* d = D + r * LD + c;
      *reinterpret_cast<uint4*>(X + r * xld + c) =
          make_uint4(bf16x2(d[0], d[1]), bf16x2(d[2], d[3]),
                     bf16x2(d[4], d[5]), bf16x2(d[6], d[7]));
    }
    if (!a.inv_in_smem) {
      bf16* Xt = scratch_inv(i, 1);
      for (int e = tid; e < B * B / 8; e += kThreads) {
        const int r = e % B, c = e / B * 8;
        const float* d = D + c * LD + r;
        *reinterpret_cast<uint4*>(Xt + r * B + c) = make_uint4(
            bf16x2(d[0], d[LD]), bf16x2(d[2 * LD], d[3 * LD]),
            bf16x2(d[4 * LD], d[5 * LD]), bf16x2(d[6 * LD], d[7 * LD]));
      }
    }
    __syncthreads();
    TRI_SOLVE_STAMP(12 + 3 * sc.slot(i));         // stored in bf16
  }

  // the chunk of job c into stage (bulk: by warp 0; else every thread, one
  // commit group a chunk)
  auto issue = [&](const Cur& c, int stage) {
    unsigned char* dst = ring + stage * stage_bytes;
    if (c.s < sc.s_end) {
      int ti, tj;
      sc.job_tile(c, ti, tj);
      const int r0 = c.rc * cr;
      if (bulk) {
        const uint32_t bytes = plane * sizeof(Src);
        if (lane == 0) mbar_expect_tx(&full[stage], a.nc * bytes);
        __syncwarp();
        for (int k = lane; k < a.nc; k += 32)
          bulk_copy(dst + k * bytes, tile_at(ti, tj, k) + (long long)r0 * B,
                    bytes, &full[stage]);
      } else if (a.vec) {
        constexpr int VN = 16 / sizeof(Src);
        const int vr = inside(ti) - r0, vc = inside(tj);
        for (int k = 0; k < a.nc; ++k) {
          const Src* src = tile_at(ti, tj, k) + (long long)r0 * ld;
          Src* d = reinterpret_cast<Src*>(dst) + k * plane;
          for (int e = tid; e < plane / VN; e += kThreads) {
            const int r = e / (B / VN), cc = e % (B / VN) * VN;
            if (r < vr && cc < vc) cp_async16(d + r * B + cc, src + r * ld + cc);
          }
        }
      }
    }
    if (!bulk && a.vec) cp_async_commit();
  };
  const unsigned xb2 = bf16x2(y.xv, y.xv);   // x rounded, in both halves
  // chunk rc of job c (staged in stage, or read from global memory) into
  // the bf16 tile t, 8 values (16 bytes) a step
  auto to_tile = [&](const Cur& c, int stage, bf16* t) {
    int ti, tj;
    sc.job_tile(c, ti, tj);
    const int r0 = c.rc * cr, vr = inside(ti) - r0, vc = inside(tj);
    const Src* st = reinterpret_cast<const Src*>(ring + stage * stage_bytes);
    for (int e = tid; e < plane / 8; e += kThreads) {
      const int r = e / (B / 8), c0 = e % (B / 8) * 8;
      uint4 q;
      if constexpr (Source == kInterp) {     // Horner in bf16 pairs
        q = *reinterpret_cast<const uint4*>(st + (a.nc - 1) * plane + r * B + c0);
        for (int k = a.nc - 2; k >= 0; --k) {
          const uint4 p = *reinterpret_cast<const uint4*>(st + k * plane + r * B + c0);
          q.x = bf16x2_add(bf16x2_mul(q.x, xb2), p.x);
          q.y = bf16x2_add(bf16x2_mul(q.y, xb2), p.y);
          q.z = bf16x2_add(bf16x2_mul(q.z, xb2), p.z);
          q.w = bf16x2_add(bf16x2_mul(q.w, xb2), p.w);
        }
      } else if constexpr (!std::is_same<Src, T>::value) {   // bf16 factor
        q = *reinterpret_cast<const uint4*>(st + r * B + c0);
      } else {                               // float32, rounded once
        float v[8];
        if (a.vec) {
          const float4 lo = *reinterpret_cast<const float4*>(st + r * B + c0);
          const float4 hi = *reinterpret_cast<const float4*>(st + r * B + c0 + 4);
          v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
          v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
        } else {
          const Src* src = tile_at(ti, tj, 0) + (long long)(r0 + r) * ld + c0;
#pragma unroll
          for (int u = 0; u < 8; ++u)
            v[u] = r < vr && c0 + u < vc ? src[u] : 0.0f;
        }
#pragma unroll
        for (int u = 0; u < 8; ++u)
          if (r >= vr || c0 + u >= vc) v[u] = 0.0f;
        q = make_uint4(bf16x2(v[0], v[1]), bf16x2(v[2], v[3]),
                       bf16x2(v[4], v[5]), bf16x2(v[6], v[7]));
      }
      *reinterpret_cast<uint4*>(t + r * BL + c0) = q;
    }
  };

  TRI_SOLVE_STAMP(2);                            // the prologue's end
  Cur pc = sc.first_job(sc.s_begin), cc = pc;    // producer, consumer
  int issued = 0, consumed = 0;
  if (a.vec) {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    for (int q = 0; q < S; ++q) {
      if (!bulk || warp == 0) issue(pc, q);
      ++issued;
      if (pc.s < sc.s_end) pc = sc.next(pc);
    }
  }
  auto consume_tile = [&]() {
    const int i = sc.row_of(cc.s), j = cc.j;
    const bool fwd = cc.s < nt;
    const T* v = (fwd ? wf : wr) + i * B;
    T* aj = acc + sc.slot(j) * B;
    float racc[2][2] = {};          // reverse: a warp's column sums
    for (int rc = 0; rc < nchunk; ++rc) {
      const int stage = consumed % S;
      bf16* t = tiles + (consumed & 1) * cr * BL;
      Cur c = cc;
      c.rc = rc;
      TRI_SOLVE_STAMP(600);                      // a chunk: wait
      if (bulk) {
        mbar_wait(&full[stage], (consumed / S) & 1);
      } else if (a.vec) {
        cp_async_wait_ring(S - 1);
        __syncthreads();
      }
      TRI_SOLVE_STAMP(601);                      // landed: to a tile
      to_tile(c, stage, t);
      __syncthreads();
      TRI_SOLVE_STAMP(602);                      // refill, multiply
      if (a.vec) {                    // the stage is free: S chunks ahead
        if (!bulk || warp == 0) issue(pc, stage);
        ++issued;
        if (pc.s < sc.s_end) pc = sc.next(pc);
      }
      ++consumed;
      const int r0 = rc * cr;
      if (fwd) {      // aj[r] += L_ji[r, :] . v: a 16-row strip of the
                      // chunk a warp, the depth split over kf warps
        const int ns = cr / 16, strip = warp % ns, kp = warp / ns;
        if (kp < kf) {
          float mv[2][2] = {};
          for (int ks = kp; ks < B / 16; ks += kf)
            warp_mv_smem<false>(mv, t + strip * 16 * BL + ks * 16, BL,
                                v + ks * 16);
          warp_mv_store(mv, red + kp * B + r0 + strip * 16);
        }
        __syncthreads();
        if (tid < cr) {
          T s = T(0);
          for (int p = 0; p < kf; ++p) s += red[p * B + r0 + tid];
          aj[r0 + tid] += s;
        }
      } else {        // aj[c] += L_ij[:, c] . v: a 16-column strip a warp,
                      // the tile's 16-row steps dealt over KQ warps
        const int strip = warp % (B / 16), kp = warp / (B / 16);
        for (int ks = 0; ks < cr / 16; ++ks)
          if ((r0 / 16 + ks) % KQ == kp)
            warp_mv_smem<true>(racc, t + ks * 16 * BL + strip * 16, BL,
                               v + r0 + ks * 16);
      }
      TRI_SOLVE_STAMP(603);                      // multiplied (warp 0)
    }
    if (!fwd) {                       // one sum a tile, in order
      warp_mv_store(racc, red + warp / (B / 16) * B + warp % (B / 16) * 16);
      __syncthreads();
      if (tid < B) {
        T s = T(0);
        for (int p = 0; p < KQ; ++p) s += red[p * B + tid];
        aj[tid] += s;
      }
    }
    Cur t = cc;
    t.rc = nchunk - 1;
    cc = sc.next(t);
  };
  // v_i = X_i (rhs_i - acc_i) (X_i^T for the reverse sweep), stored into
  // every block's slot; the last sweep's values also to the output
  auto solve = [&](int s) {
    const int i = sc.row_of(s);
    const bool fwd = s < nt, last_sweep = !fwd || !(a.sweeps & 2);
    solve_rhs<T, B>(rhs, acc + sc.slot(i) * B, wf, y.G, i,
                    !fwd && (a.sweeps & 1), nrows, a.nrhs);
    {                       // a 16-row strip a warp, the depth over KQ warps
      const int strip = warp % (B / 16), kp = warp / (B / 16), r0 = strip * 16;
      float mv[2][2] = {};
      if (a.inv_in_smem) {
        const bf16* X = inv_s + (long long)sc.slot(i) * B * BL;
#pragma unroll
        for (int ks = kp; ks < B / 16; ks += KQ) {
          if (fwd)
            warp_mv_smem<false>(mv, X + r0 * BL + ks * 16, BL, rhs + ks * 16);
          else
            warp_mv_smem<true>(mv, X + ks * 16 * BL + r0, BL, rhs + ks * 16);
        }
      } else {
        const bf16* X = scratch_inv(i, fwd ? 0 : 1);
#pragma unroll
        for (int ks = kp; ks < B / 16; ks += KQ)
          warp_mv_global(mv, X + r0 * B + ks * 16, B, rhs + ks * 16);
      }
      warp_mv_store(mv, red + kp * B + r0);
    }
    store_solution<T, B>(cluster, C, red, KQ, (fwd ? wf : wr) + i * B, y.O, i,
                         last_sweep, nrows, a.nrhs);
  };

  sc.run(cc, solve, consume_tile);
}

// ---------------------------------------------------------------------------
// Host side: the plan (cluster size by occupancy, shared-memory layout),
// chosen once per device and shape, and the cluster launch.

// Src: the type the tiles are staged in
template <typename T, typename Src, int B>
bool solve_layout(int nt, int nc, int C, int max_smem, SolvePlan* p) {
  int cr0 = 8;
  while (cr0 * 2 <= B && (long long)cr0 * 2 * nc * B * sizeof(Src) <= kStageBytes)
    cr0 *= 2;
  if (cr0 > B) cr0 = B;
  for (int cr = cr0; cr >= 1; cr /= 2)
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

// clusters of C blocks with smem bytes each that the device runs at once
// (0: none)
template <typename K>
cudaError_t active_clusters(K kern, int C, int smem, int* n) {
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = C;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaOccupancyMaxActiveClusters(n, kern, &cfg);
}

// The plan of one one-dtype instantiation (each has a cache of its own, so
// the three tile sources and the dtypes never share one), per device and
// shape.
template <typename T, int B, int Source>
int solve_plan(int nt, int nc, long long n_sys, SolvePlan* best) {
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
  bool found = false;
  long long best_score = 0;
  for (int C = kMaxCluster; C >= 1; C /= 2) {
    if (C > nt && C > 1) continue;
    SolvePlan p;
    if (!solve_layout<T, T, B>(nt, nc, C, max_smem, &p)) continue;
    int n = 0;
    err = active_clusters(tri_solve_kernel<T, B, Source>, C, p.smem_bytes, &n);
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

// The mixed kernel's model of one system's time (ns), from the stamps of
// scripts/probe_tri_solve.py (NVIDIA H100 80GB HBM3, 700 W, two blocks an
// SM): a block inverts its R = ceil(nt / C) diagonal tiles; each step
// costs a cluster barrier and a solve on the chain; each sweep's
// nt (nt - 1) / 2 tile updates are spread over the C blocks, a tile
// costing kMixTileNs per 16 KB staged (a float32 tile of B = 64; a Θ
// plane of B = 128 is 32 KB).  Where the card runs 30 clusters of 8, the
// one-dtype plan's score (waves x 8 / C) picks 3 waves of C = 8 for 70
// systems at nt = 8, and this one one wave of C = 2: 1.18-1.55x faster at
// the main shapes (scripts/ab_tri_solve_mixed.py, variant waves_score;
// NVIDIA H100 80GB HBM3, 700 W).
constexpr double kMixInvNs = 26000.0;     // one diagonal tile read and inverted, B = 128
constexpr double kMixStepNs = 300.0;      // barrier, wait and the step's bookkeeping
constexpr double kMixTileNs = 1000.0;     // per 16 KB staged
constexpr double kMixSolveNs = 2000.0;    // inverse in shared memory
constexpr double kMixSolveL2Ns = 3500.0;  // inverse read from the scratch

// The plan of one mixed instantiation, per device and shape: every cluster
// size, inverse placement, chunk (from mixed_depth_split's down to 16
// rows) and ring (kMixedMaxStages down to 2 stages; none when the source
// is read from global memory) that fits, scored by waves of clusters x
// the model's time of one system; on a tie the first (larger C, inverses
// in shared memory, more rows a chunk, more stages).  The inverses stay in
// shared memory only where the blocks an SM the kernel is built for
// (kMixedBlocksPerSm) still fit beside them: a second block hides the
// first's barrier waits, and the solve's L2 reads of a bf16 inverse are a
// small term of a step.
template <int B, int Source, typename Src>
int mixed_plan(int nt, int nc, int sweeps, int vec, long long n_sys,
               SolvePlan* best) {
  static std::mutex mu;
  static std::map<std::tuple<int, int, int, long long, int, int>, SolvePlan> cache;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  const auto key = std::make_tuple(dev, nt, nc, n_sys, sweeps, vec);
  std::lock_guard<std::mutex> lock(mu);
  const auto hit = cache.find(key);
  if (hit != cache.end()) {
    *best = hit->second;
    return 0;
  }
  int max_smem = 0;
  err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  auto kern = tri_solve_mixed_kernel<B, Source, Src>;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  const int kf = mixed_depth_split(B, nc, sizeof(Src));
  int cr0 = 16;
  while (cr0 * 2 <= B && (long long)cr0 * 2 * nc * B * sizeof(Src) <= kStageBytes)
    cr0 *= 2;
  const int n_sweeps = (sweeps & 1) + (sweeps >> 1 & 1), steps = nt * n_sweeps;
  const double tile_ns =
      kMixTileNs * (double)nc * B * B * sizeof(Src) / 16384.0;
  const double inv_ns = kMixInvNs * (B / 128.0) * (B / 128.0);
  bool found = false;
  double best_score = 0;
  for (int C = kMaxCluster; C >= 1; C /= 2) {
    if (C > nt && C > 1) continue;
    const int R = (nt + C - 1) / C;
    for (int in_smem = 1; in_smem >= 0; --in_smem)
      for (int cr = cr0; cr >= 16; cr /= 2)
        for (int st = vec ? kMixedMaxStages : 1; st >= (vec ? 2 : 1); --st) {
          const long long stage_bytes =
              vec ? (long long)nc * cr * B * sizeof(Src) : 0;
          const MixedSmem m =
              mixed_smem<B>(nt, C, in_smem, kf, stage_bytes, st, cr);
          if (m.total > max_smem) continue;
          int n = 0, per_sm = 0;
          err = active_clusters(kern, C, (int)m.total, &n);
          if (err == cudaSuccess)
            err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &per_sm, kern, kThreads, (int)m.total);
          if (err != cudaSuccess) return (int)err;
          // inverses in shared memory only where the blocks an SM the
          // design is built for still fit
          if (n <= 0 || (in_smem && per_sm < kMixedBlocksPerSm)) continue;
          const double one =
              R * inv_ns +
              steps * (kMixStepNs + (in_smem ? kMixSolveNs : kMixSolveL2Ns)) +
              n_sweeps * ((nt * (nt - 1) / 2 + C - 1) / C) * tile_ns;
          const double score = (double)((n_sys + n - 1) / n) * one;
          if (!found || score < best_score) {
            *best = SolvePlan{C, n, R, in_smem, (int)m.total, st, cr};
            best_score = score;
            found = true;
          }
        }
  }
  if (!found) return (int)cudaErrorInvalidConfiguration;
  cache.emplace(key, *best);
  return 0;
}

template <typename K, typename A>
int cluster_launch(K kern, const A& a, const SolvePlan& p, long long n_sys,
                   cudaStream_t stream) {
  if (n_sys * p.cluster > 2147483647LL) return (int)cudaErrorInvalidValue;
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

template <typename T, int B, int Source, typename CT, typename Src>
int solve_launch(SolveArgs<T, Src> a, long long n_sys, int* plan_out,
                 cudaStream_t stream) {
  constexpr bool kMixed = !std::is_same<CT, T>::value;
  static_assert(!kMixed || (std::is_same<T, float>::value &&
                            std::is_same<CT, __nv_bfloat16>::value),
                "bf16 products have float sums");
  SolvePlan p;
  int rc;
  if constexpr (kMixed)
    rc = mixed_plan<B, Source, Src>(a.nt, a.nc, a.sweeps, a.vec, n_sys, &p);
  else
    rc = solve_plan<T, B, Source>(a.nt, a.nc, n_sys, &p);
  if (rc) return rc;
  if (plan_out) {
    const int v[kPlanInts] = {p.cluster, p.max_active, p.rows_per_block,
                              p.inv_in_smem, p.smem_bytes, p.stages, p.chunk_rows};
    for (int k = 0; k < kPlanInts; ++k) plan_out[k] = v[k];
  }
  if (!p.inv_in_smem && a.scratch == nullptr) return kNeedsScratch;
  a.inv_in_smem = p.inv_in_smem;
  a.stages = p.stages;
  a.chunk_rows = p.chunk_rows;
  if constexpr (kMixed)
    return cluster_launch(tri_solve_mixed_kernel<B, Source, Src>, a, p, n_sys,
                          stream);
  else
    return cluster_launch(tri_solve_kernel<T, B, Source>, a, p, n_sys, stream);
}

// The launch of one call, B at run time (one of 16, 32, 64, 128).  The
// plan (cached per device and shape) goes to plan_out, when given, as
// kPlanInts ints in SolvePlan's order.  Returns kNeedsScratch, launching
// nothing, when the inverses the kernel forms do not fit in shared memory
// and a.scratch is null (the mixed kernel keeps X_i and X_i^T there in
// bf16: 4 B^2 bytes a tile row, within the B (B + 4) floats the one-dtype
// float32 kernel takes).  Source: kDense, kInterp or kPacked; CT: the
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
