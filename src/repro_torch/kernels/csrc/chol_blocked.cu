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
// under a bf16 compute dtype, chol_blocked.py:80-82 and :98-100): the state
// stays float32, the operands of (b) (A_i1 and X) and of (c) (W), and of
// the look-ahead update of (a) (W0, since the Pallas syrk covers the
// diagonal tile too), are bf16 with float32 sums; the diagonal factor and
// its inverse stay float32 (CUDA-core products).  Two designs, chosen from
// B (mixed_variant in chol_blocked.py says the same):
//   - wgmma (B = 64, 128).  Each operand is rounded to bf16 (to nearest
//     even) once, where it is stored: (a) writes X as a bf16 (batch, B, B)
//     tensor, (b) rounds its A_i1 rows into shared memory and writes W
//     twice, float32 straight into the factor's column (in place: a block
//     reads its rows before it writes them) and a bf16 copy (batch, hp, B)
//     for the products.  The bf16 strips come into shared memory at full
//     depth B by the tensor memory accelerator (cp.async.bulk.tensor, the
//     128-byte swizzle, one mbarrier a block, no k-loop of barriers), and
//     wgmma.mma_async (bf16 x bf16 -> f32; both operands K-major, as
//     C -= P Q^T has them) multiplies them into float32 sums in registers,
//     two warpgroups a block.  (b) is one block a half tile row (64 rows,
//     m64n64k16 on the column halves at B = 128), (c) one block a lower
//     tile pair (m64n128k16 on the row halves, C asked into L2 while the
//     strips land, read once and written once) or a zeroing job for the
//     mirrored upper tile, and (a)'s look-ahead update W0 W0^T runs (c)'s
//     product on the bf16 copy; the rest of (a) is the one-dtype kernels'
//     (its float32 inverse in their order, rounded as it is stored).
//     wgmma sums a k16 step as mma.sync m16n8k16 does, in the same k
//     order, so the design gives the mma_sync design's bits.  Streams: (a)
//     of column j + 1 follows (b) of column j on the caller's stream (no
//     event between them), (c) runs on the look-ahead stream beside it,
//     and the caller's stream waits for (c) before (b) of column j + 1.
//     Same launches in the same number.
//   - mma_sync (B = 16, 32: the swizzled strips need 64-column boxes).
//     The one-dtype kernels with the operands rounded to bf16 as their
//     fragments are formed (warp_mma_bf16, mma.sync m16n8k16), staged in
//     float32 kKc = 16 columns at a time.  Built with
//     -DCHOL_MIXED_MMA_SYNC=1 it runs at every B (the design before wgmma,
//     kept for scripts/ab_chol_mixed.py).
// A product of two bf16 values is exact in float32, so the designs differ
// from the plain version only in the order of the float32 sums.  At the
// bf16 tensor-core rate the variant's bound is bytes (the float32 matrices
// read and the factors written); the diagonal step's serial chain, which
// stays float32, holds it as it holds the float64 kernel.
//
// Bound on this card: operations (h^3/3 per matrix, mostly in (c), on the
// FP64 tensor cores).  What holds it back: the diagonal step's serial chain
// (128 pivots per tile, each a shuffle, a reciprocal square root and a
// multiply-add on warp 0) on one SM per matrix, and the trailing update's
// read-modify-write of A22 with 64 x 64 tiles of depth B.

#include <cuda.h>         // CUtensorMap and its enums (the encoder is fetched
                          // through the runtime: no link to the driver)

#include <cstdint>
#include <mutex>

#include "tri_solve.cuh"   // the warp products, cp.async, the mbarrier
                           // helpers, warp_potf2_inv

#ifndef CHOL_MIXED_MMA_SYNC
#define CHOL_MIXED_MMA_SYNC 0
#endif

namespace {

constexpr int kWarps = kThreads / 32;
constexpr int kKc = 16;                 // depth of one staged slice in (b), (c)
constexpr int kLdStage = kKc + 4;

// ---------------------------------------------------------------------------
// The wgmma design of the mixed variant (bf16 operands stored once).

// the mixed variant at block B runs the wgmma design
template <typename T, int B, typename CT>
constexpr bool kWgmma =
    !std::is_same<T, CT>::value && B >= 64 && !CHOL_MIXED_MMA_SYNC;

using bf16 = __nv_bfloat16;

// p moved forward to the next shared address that is a multiple of 1024
// (the 128-byte swizzle repeats every 8 rows of 128 bytes)
__device__ __forceinline__ unsigned char* align_1024(unsigned char* p) {
  return p + ((1024u - smem_addr(p) % 1024u) % 1024u);
}

// box (c0, c1, c2) of a tensor map into shared memory, counted on bar
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         int c0, int c1, int c2,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(smem_addr(bar))
      : "memory");
}

// A strip of R rows x B bf16 columns in shared memory, as the tensor
// memory accelerator writes it with the 128-byte swizzle: B / 64 chunks of
// R rows x 128 bytes, the 16-byte unit u of row r at unit u ^ (r % 8).
// Byte offset of the unit holding columns [k, k + 8) of row r:
template <int R>
__device__ __forceinline__ uint32_t sw128_unit(int r, int k) {
  return (k >> 6) * R * 128 + r * 128 + ((((k & 63) >> 3) ^ (r & 7)) << 4);
}

// wgmma's shared-memory matrix descriptor of a K-major operand in that
// layout: start address, leading offset 16 bytes (unused when swizzled),
// 1024 bytes between 8-row groups, the 128-byte swizzle
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_m64n128(float (&d)[64], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_m64n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}


__device__ __forceinline__ void wgmma_m64n32(float (&d)[16], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}


__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

// the accumulators are not read or written before the products end
template <int N>
__device__ __forceinline__ void fence_operands(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Warpgroup g (threads 128 g ...) computes rows [R0 g, R0 g + 64) x
// columns [C0 g, C0 g + N) of a B x B tile, kAcc floats a thread.
template <int B> struct TcShape {
  static_assert(B == 64 || B == 128, "the wgmma design takes B = 64, 128");
  static constexpr int N = B == 128 ? 128 : 32;
  static constexpr int R0 = B == 128 ? 64 : 0;
  static constexpr int C0 = B == 128 ? 0 : 32;
  static constexpr int kAcc = N / 2;
};

// acc = P Q^T over depth B: P and Q are B-row strips (sw128_unit layout),
// rows of the tile from P, columns from Q
template <int B>
__device__ __forceinline__ void tile_product(float (&acc)[TcShape<B>::kAcc],
                                             const bf16* sP, const bf16* sQ) {
  using S = TcShape<B>;
  const int g = threadIdx.x >> 7;
  const uint32_t p0 = smem_addr(sP) + S::R0 * g * 128;
  const uint32_t q0 = smem_addr(sQ) + S::C0 * g * 128;
#pragma unroll
  for (int i = 0; i < S::kAcc; ++i) acc[i] = 0.f;
  fence_operands(acc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < B / 16; ++kk) {
    const uint32_t off = (kk >> 2) * B * 128 + (kk & 3) * 32;
    if constexpr (B == 128)
      wgmma_m64n128(acc, sw128_desc(p0 + off), sw128_desc(q0 + off), 1);
    else
      wgmma_m64n32(acc, sw128_desc(p0 + off), sw128_desc(q0 + off), 1);
  }
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  fence_operands(acc);
}

// f(r, c, acc(r, c), acc(r, c + 1)) for the thread's accumulators (c even):
// wgmma's f32 layout, 16 rows a warp, each 8 columns as mma.sync's m16n8
template <int B, typename F>
__device__ __forceinline__ void for_each_tc(const float (&acc)[TcShape<B>::kAcc],
                                            F f) {
  using S = TcShape<B>;
  const int t = threadIdx.x & 127, g = threadIdx.x >> 7;
  const int r = S::R0 * g + (t >> 5) * 16 + ((t & 31) >> 2);
  const int c = S::C0 * g + 2 * (t & 3);
#pragma unroll
  for (int j = 0; j < S::N / 8; ++j) {
    f(r, c + 8 * j, acc[4 * j], acc[4 * j + 1]);
    f(r + 8, c + 8 * j, acc[4 * j + 2], acc[4 * j + 3]);
  }
}

// dynamic shared memory of the wgmma design's (b) and (c): two strips of
// B x B bf16 on a 1024-byte boundary and their barrier
template <int B>
constexpr size_t kTcSmem = 1024 + 2 * B * B * sizeof(bf16) + 16;


// (a) the diagonal step: factor and inverse of one B x B tile per matrix;
// CT the compute type of the look-ahead update
template <typename T, int B, typename CT>
__global__ void __launch_bounds__(kThreads)
diag_kernel(const T* src, T* a, void* __restrict__ inv,
            const void* __restrict__ w, int hp, int lo,
            const __grid_constant__ CUtensorMap wmap) {
  // the wgmma design: X goes out in bf16, W0 comes in as the bf16 panel
  // (through wmap; w only says whether to apply it)
  constexpr bool kTc = kWgmma<T, B, CT>;
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
  T* X = static_cast<T*>(inv) + (long long)blockIdx.x * B * B;
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
    if constexpr (kTc) {         // rounded once, 8 values a 16-byte store
      bf16* Xb = static_cast<bf16*>(inv) + (long long)blockIdx.x * B * B;
      for (int e = t0; e < kNb * (B / 8); e += n) {
        const int r = i * kNb + e / (B / 8), c = e % (B / 8) * 8;
        const float* x = S + r * LD + c;
        *reinterpret_cast<uint4*>(Xb + r * B + c) =
            make_uint4(bf16x2(x[0], x[1]), bf16x2(x[2], x[3]),
                       bf16x2(x[4], x[5]), bf16x2(x[6], x[7]));
      }
    } else {
      for (int e = t0; e < kNb * (B / VN); e += n) {
        const int r = i * kNb + e / (B / VN), c = e % (B / VN) * VN;
        *reinterpret_cast<V*>(X + r * B + c) =
            *reinterpret_cast<const V*>(S + r * LD + c);
      }
    }
  };

  // the wgmma design's W0 strip (B rows of the bf16 panel), on its way
  // while the tile loads
  bf16* sW = nullptr;
  uint64_t* bar = nullptr;
  if constexpr (kTc) {
    sW = reinterpret_cast<bf16*>(
        align_1024(reinterpret_cast<unsigned char*>(Xd + 2 * B * kLdStage)));
    bar = reinterpret_cast<uint64_t*>(sW + B * B);
    if (w != nullptr && tid == 0) {
      mbar_init(bar, 1);
      mbar_expect_tx(bar, B * B * sizeof(bf16));
      for (int c = 0; c < B / 64; ++c)
        tma_load(sW + c * B * 64, &wmap, c * 64, 0, blockIdx.x, bar);
    }
  }
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
    if constexpr (kTc) {
      // the previous tile column's trailing update of this tile from the
      // bf16 panel, the whole depth at once, on the lower sub-blocks
      mbar_wait(bar, 0);
      float acc[TcShape<B>::kAcc];
      tile_product<B>(acc, sW, sW);
      for_each_tc<B>(acc, [&](int r, int c, float v0, float v1) {
        if ((c >> 4) <= (r >> 4)) {
          S[r * LD + c] -= v0;
          S[r * LD + c + 1] -= v1;
        }
      });
      __syncthreads();
    } else {
      // the previous tile column's trailing update of this tile, which its
      // syrk launch leaves out: A -= W0 W0^T, W0 the panel's first tile row,
      // staged kKc columns at a time through a two-stage ring (Xd and the
      // stage after it); each warp keeps the sums of its sub-block pairs
      constexpr int NP = NS * (NS + 1) / 2, PW = (NP + kWarps - 1) / kWarps;
      const T* W0 = static_cast<const T*>(w) + (long long)blockIdx.x * hp * B;
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

// (b) of the wgmma design: one block a half tile row, rows [64 hh,
// 64 hh + 64) of tile row i of the panel (B / 64 blocks a tile row).
// W = A_i1 X^T with A_i1 rounded to bf16 into shared memory (sw128_unit
// layout, 64 rows) by the threads and X (bf16, from (a)) brought by the
// tensor memory accelerator; warpgroup g computes columns [g B/2, g B/2 +
// B/2) (m64n64k16 at B = 128, m64n32k16 at 64).  W goes out in float32
// into the factor's column (over A_i1: this block alone reads those rows,
// and has read them) and in bf16 into the panel wb.
template <int B>
__global__ void __launch_bounds__(kThreads)
panel_kernel_tc(const float* src, float* a, bf16* __restrict__ wb,
                const __grid_constant__ CUtensorMap xmap, int hp, int lo) {
  constexpr int R = 64, N = B / 2, NA = N / 2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* base = align_1024(smem_raw);
  bf16* sA = reinterpret_cast<bf16*>(base);
  bf16* sX = sA + R * B;
  uint64_t* bar = reinterpret_cast<uint64_t*>(sX + B * B);
  const int tid = threadIdx.x, mat = blockIdx.y;
  const int i = blockIdx.x / (B / R), hh = blockIdx.x % (B / R);
  if (tid == 0) {
    mbar_init(bar, 1);
    mbar_expect_tx(bar, B * B * sizeof(bf16));
    for (int c = 0; c < B / 64; ++c)
      tma_load(sX + c * B * 64, &xmap, c * 64, 0, mat, bar);
  }
  const long long at = (long long)mat * hp * hp +
                       (long long)(lo + B + i * B + hh * R) * hp + lo;
  constexpr int U = R * B / 8 / kThreads;    // 8-column units a thread
  float4 v[U][2];
#pragma unroll
  for (int u = 0; u < U; ++u) {              // every load in flight at once
    const int e = tid + u * kThreads, r = e / (B / 8), k = e % (B / 8) * 8;
    const float4* row = reinterpret_cast<const float4*>(src + at +
                                                        (long long)r * hp + k);
    v[u][0] = row[0];
    v[u][1] = row[1];
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int e = tid + u * kThreads, r = e / (B / 8), k = e % (B / 8) * 8;
    *reinterpret_cast<uint4*>(base + sw128_unit<R>(r, k)) =
        make_uint4(bf16x2(v[u][0].x, v[u][0].y), bf16x2(v[u][0].z, v[u][0].w),
                   bf16x2(v[u][1].x, v[u][1].y), bf16x2(v[u][1].z, v[u][1].w));
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  mbar_wait(bar, 0);
  const int g = tid >> 7;
  float acc[NA];
#pragma unroll
  for (int q = 0; q < NA; ++q) acc[q] = 0.f;
  fence_operands(acc);
  wgmma_fence();
  const uint32_t p0 = smem_addr(sA), q0 = smem_addr(sX) + g * N * 128;
#pragma unroll
  for (int kk = 0; kk < B / 16; ++kk) {
    const uint32_t ka = (kk >> 2) * R * 128 + (kk & 3) * 32;
    const uint32_t kb = (kk >> 2) * B * 128 + (kk & 3) * 32;
    if constexpr (N == 64)
      wgmma_m64n64(acc, sw128_desc(p0 + ka), sw128_desc(q0 + kb), 1);
    else
      wgmma_m64n32(acc, sw128_desc(p0 + ka), sw128_desc(q0 + kb), 1);
  }
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  fence_operands(acc);
  float* W = a + at;
  bf16* Wb = wb + (long long)mat * hp * B + (long long)(i * B + hh * R) * B;
  const int t = tid & 127, r0 = (t >> 5) * 16 + ((t & 31) >> 2);
  const int c0 = g * N + 2 * (t & 3);
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int h8 = 0; h8 < 2; ++h8) {
      const int r = r0 + 8 * h8, c = c0 + 8 * j;
      const float v0 = acc[4 * j + 2 * h8], v1 = acc[4 * j + 2 * h8 + 1];
      *reinterpret_cast<float2*>(W + (long long)r * hp + c) =
          make_float2(v0, v1);
      *reinterpret_cast<unsigned*>(Wb + r * B + c) = bf16x2(v0, v1);
    }
}

// (c) of the wgmma design: job p < n_pairs - 1 is lower tile pair p + 1
// (pair 0 is the next diagonal step's), C -= W_ti W_tj^T from the bf16
// panel, C read from src and written to a once (a diagonal pair only on
// its lower 16 x 16 sub-blocks); job n_pairs - 1 + ti zeroes the mirrored
// strictly upper tile ti of the column's row strip.  The factor's column
// itself was written by (b).
template <int B>
__global__ void __launch_bounds__(kThreads, 2)
syrk_kernel_tc(const float* src, float* a,
               const __grid_constant__ CUtensorMap wmap, int hp, int lo,
               int m) {
  const int n_pairs = m * (m + 1) / 2, job = blockIdx.x;
  const long long mat = blockIdx.y;
  if (job >= n_pairs - 1) {
    const int ti = job - (n_pairs - 1);
    float* Z = a + mat * hp * hp + (long long)lo * hp + lo + B + ti * B;
    for (int e = threadIdx.x; e < B * B / 4; e += kThreads) {
      const int r = e / (B / 4), c = e % (B / 4) * 4;
      *reinterpret_cast<float4*>(Z + (long long)r * hp + c) =
          make_float4(0.f, 0.f, 0.f, 0.f);
    }
    return;
  }
  const int p = job + 1;
  int ti = (int)((sqrt(8.0 * p + 1.0) - 1.0) * 0.5);
  while ((ti + 1) * (ti + 2) / 2 <= p) ++ti;
  while (ti * (ti + 1) / 2 > p) --ti;
  const int tj = p - ti * (ti + 1) / 2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sP = reinterpret_cast<bf16*>(align_1024(smem_raw));
  bf16* sQ = ti == tj ? sP : sP + B * B;
  uint64_t* bar = reinterpret_cast<uint64_t*>(sP + 2 * B * B);
  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    mbar_expect_tx(bar, (ti == tj ? 1 : 2) * B * B * sizeof(bf16));
    for (int c = 0; c < B / 64; ++c) {
      tma_load(sP + c * B * 64, &wmap, c * 64, ti * B, (int)mat, bar);
      if (ti != tj) tma_load(sQ + c * B * 64, &wmap, c * 64, tj * B, (int)mat, bar);
    }
  }
  // C into L2 while its strips land and multiply: 128-byte lines
  const long long at = mat * hp * hp + (long long)(lo + B + ti * B) * hp +
                       (lo + B + tj * B);
  for (int e = threadIdx.x; e < B * B / 32; e += kThreads)
    asm volatile("prefetch.global.L2 [%0];\n" ::"l"(
        src + at + (long long)(e / (B / 32)) * hp + e % (B / 32) * 32));
  __syncthreads();
  mbar_wait(bar, 0);
  float acc[TcShape<B>::kAcc];
  tile_product<B>(acc, sP, sQ);
  for_each_tc<B>(acc, [&](int r, int c, float v0, float v1) {
    if (ti == tj && (c >> 4) > (r >> 4)) return;
    const long long e = at + (long long)r * hp + c;
    const float2 cin = *reinterpret_cast<const float2*>(src + e);
    *reinterpret_cast<float2*>(a + e) = make_float2(cin.x - v0, cin.y - v1);
  });
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
  const CUtensorMap none{};             // read by the wgmma design only
  diag_kernel<T, B, CT><<<batch, kThreads, smem, s>>>(src, a, inv, nullptr, hp,
                                                      0, none);
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
        j == 0 ? src : a, a, inv, w, hp, lo + B, none);
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

// The driver's cuTensorMapEncodeTiled, fetched once through the runtime.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

int tensor_map_encoder(EncodeTiled* out) {
  static std::once_flag once;
  static EncodeTiled fn = nullptr;
  static int rc = 0;
  std::call_once(once, [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &f, cudaEnableDefault, &q);
#endif
    if (e != cudaSuccess)
      rc = (int)e;
    else if (q != cudaDriverEntryPointSuccess || f == nullptr)
      rc = (int)cudaErrorSymbolNotFound;
    else
      fn = reinterpret_cast<EncodeTiled>(f);
  });
  *out = fn;
  return rc;
}

// The tensor map of (batch, rows, B) bf16 matrices, read in boxes of B
// rows x 64 columns of one matrix with the 128-byte swizzle.
template <int B>
int bf16_strips(CUtensorMap* map, const bf16* base, int rows, int batch) {
  EncodeTiled encode = nullptr;
  const int rc = tensor_map_encoder(&encode);
  if (rc) return rc;
  const cuuint64_t dim[3] = {(cuuint64_t)B, (cuuint64_t)rows,
                             (cuuint64_t)batch};
  const cuuint64_t stride[2] = {(cuuint64_t)B * sizeof(bf16),
                                (cuuint64_t)rows * B * sizeof(bf16)};
  const cuuint32_t box[3] = {64, (cuuint32_t)B, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<bf16*>(base), dim,
      stride, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// run_columns for the wgmma design: the same launches in the same order;
// X in xb (batch, B, B) and the panel in wb (batch, hp, B), both bf16.
// Tile column j: panel(j), then diag(j+1) on the caller's stream s (no
// event between them), syrk(j) on the look-ahead stream once panel(j) is
// done; s waits for syrk(j) (the event diag_done) before panel(j+1).
template <int B>
int run_columns_tc(const float* src, float* a, bf16* xb, bf16* wb, int batch,
                   int hp, int* launches, cudaStream_t s) {
  const int nt = hp / B;
  CUtensorMap xmap, wmap;
  int rc = bf16_strips<B>(&xmap, xb, B, batch);
  if (rc) return rc;
  rc = bf16_strips<B>(&wmap, wb, hp, batch);
  if (rc) return rc;
  const size_t smem_d = (size_t)(B * (B + 4) + 2 * B * kLdStage) *
                            sizeof(float) + 1024 + B * B * sizeof(bf16) + 16;
  RT_RETURN_IF(cudaFuncSetAttribute(
      diag_kernel<float, B, bf16>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_d));
  RT_RETURN_IF(cudaFuncSetAttribute(
      panel_kernel_tc<B>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kTcSmem<B>));
  RT_RETURN_IF(cudaFuncSetAttribute(
      syrk_kernel_tc<B>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kTcSmem<B>));
  LookAhead* la = nullptr;
  if (nt > 1) {
    rc = look_ahead(&la);
    if (rc) return rc;
  }
  diag_kernel<float, B, bf16><<<batch, kThreads, smem_d, s>>>(
      src, a, xb, nullptr, hp, 0, wmap);
  RT_RETURN_IF_ERROR();
  ++*launches;
  for (int j = 0; j + 1 < nt; ++j) {
    const int lo = j * B, m = nt - 1 - j;
    const float* in = j == 0 ? src : a;
    panel_kernel_tc<B><<<dim3(m * (B / 64), batch), kThreads, kTcSmem<B>,
                         s>>>(in, a, wb, xmap, hp, lo);
    RT_RETURN_IF_ERROR();
    ++*launches;
    RT_RETURN_IF(cudaEventRecord(la->panel_done, s));
    diag_kernel<float, B, bf16><<<batch, kThreads, smem_d, s>>>(
        in, a, xb, wb, hp, lo + B, wmap);
    RT_RETURN_IF_ERROR();
    ++*launches;
    RT_RETURN_IF(cudaStreamWaitEvent(la->side, la->panel_done, 0));
    syrk_kernel_tc<B><<<dim3(m * (m + 1) / 2 - 1 + m, batch), kThreads,
                        kTcSmem<B>, la->side>>>(in, a, wmap, hp, lo, m);
    RT_RETURN_IF_ERROR();
    ++*launches;
    RT_RETURN_IF(cudaEventRecord(la->diag_done, la->side));
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
    case 64:
      if constexpr (kWgmma<T, 64, CT>)
        return run_columns_tc<64>(In, A, static_cast<bf16*>(inv),
                                  static_cast<bf16*>(w), batch, hp, launches,
                                  s);
      else
        return run_columns<T, 64, CT>(In, A, X, W, batch, hp, launches, s);
    case 128:
      if constexpr (kWgmma<T, 128, CT>)
        return run_columns_tc<128>(In, A, static_cast<bf16*>(inv),
                                   static_cast<bf16*>(w), batch, hp,
                                   launches, s);
      else
        return run_columns<T, 128, CT>(In, A, X, W, batch, hp, launches, s);
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
// the same arguments, float32 state; the products in bf16.  At B = 64 and
// 128 (the wgmma design, unless built with -DCHOL_MIXED_MMA_SYNC=1) inv is
// (batch, B, B) bf16 and w (batch, hp, B) bf16: X and the panel rounded
// once.
int rt_chol_blocked_f32_bf16(const void* src, void* a, void* inv, void* w,
                             int batch, int hp, int B, int* launches,
                             void* stream) {
  return chol_blocked<float, __nv_bfloat16>(src, a, inv, w, batch, hp, B,
                                            launches, stream);
}
}
