// Depthwise causal convolution, bias and silu of the Mamba-1 mixer in one
// pass, from the wx GEMM's output to the post-conv activations xc, and its
// backward (kernel B).
//
// Computes what src/repro/models/layers.py:300-315 (causal_conv1d: the K
// taps of lax.conv_general_dilated over [state, x]) and
// src/repro/models/blocks.py:387-388 (+ conv_b, silu) compute, in the
// port's plain order (src/repro_torch/kernels/ref.py, causal_conv1d):
//
//   acc_t = (((xp[t] w_0 + xp[t+1] w_1) + xp[t+2] w_2) + ...)   float32,
//           each product and sum rounded (no FMA contraction)
//   xc_t  = silu(round_T(round_T(acc_t) + b))                   rounded to T
//
// over xp = [state, x] (state: the last K-1 inputs, zeros when absent), and
// the new state xp[S : S+K-1].  The backward recomputes the pre-activation,
// takes silu's gradient as PyTorch's kernel takes it, rounds it to T (dpre)
// and forms dxp_r = sum_k dpre_{r-k} w_k (k = 0 first, rounded once to T:
// dx and dstate), dw_k = sum dpre_t xp_{t+k} and db = sum dpre_t in float32.
// Rounded so, both equal their plain versions bit for bit (dw and db: the
// same products summed in another order).
//
// Bound on this card: bytes, with an instruction floor close behind.  At the
// serve prefill and training shape (B=4, S=2048, C=8192, bf16) the forward
// reads x once and writes xc once (2 x 134 MB, 0.080 ms at 3.35 TB/s), the
// backward reads x and dout and writes dx (0.120 ms).  The exact rounding
// (unfused products and sums, two roundings to T, the math library's expf
// and an IEEE division with its slow-path branch) costs 41 instructions an
// element forward and ~63 backward even in a whole tile's unguarded walk
// (the compiled code): ~0.09 and ~0.14 ms of issue over the card's 528
// schedulers.  So loads and arithmetic must overlap, and every
// instruction of a step counts.
//
// The first design was one thread per 16 bytes of channels (8 in bf16)
// walking a strip of 32 (forward) or 64 (backward) steps with its window
// in registers, each step's load behind a branch on the row (state or x)
// and on alignment.  It held ~one 16-byte load a thread in flight at 106
// registers (forward; 16 warps an SM) and 188 (backward; 8 warps), ~8 KB
// an SM: 1.18 and 0.65 TB/s.  Staging a whole strip in registers (8 or 16
// steps; 168 to 230 registers) was slower.
//
// This design decouples the bytes in flight from the warps that compute.
// A block is a unit (batch row, channel tile of kConvThreads x kThreadBytes
// = 512 bytes of a row, time segment of kSegment steps).  In the staged
// variant the lanes of warp 0 fill a ring of kStages slots of tile rows in
// shared memory with the bulk-copy engine, one cp.async.bulk a row slice,
// and each slot's mbarrier counts the bytes expected; no register holds a
// load in flight.  Every thread owns kThreadBytes of a row (2 bf16 or 1
// float32 channel) and walks the segment's rows out of the ring with its
// window (the K-1 previous inputs; backward also the K latest dpre and its
// dw, db sums) in registers: 45 registers forward, 86 backward (bf16), 9
// and 5 blocks an SM, 2 slots of each in flight.  The K-1 inputs before a
// segment are read once, in its prologue (from the state or zeros at its
// head).  A tile inside its segment runs without any step's guard, its
// stores walking a pointer; the two channels' roundings to bf16 go through
// one conversion that packs both.  The backward walks K-1 rows past its
// segment (the dpre that its last dx rows need) and writes its dw and db
// sums as one partial at the slot of its unit; a second launch sums the
// partials in their order (the same bits on every call, no atomics).
//
// Measured (scripts/ab_causal_conv1d.py, in turns, H100 80GB HBM3 at
// 700 W, 4 x 2048 x 8192): bf16 forward 0.214 -> 0.129 ms, backward with
// its sum 0.629 -> 0.213; float32 forward 0.209 -> 0.206 (the first
// design already streamed it at 2.6 TB/s), backward 0.389 -> 0.305.  What
// holds bf16 (probes): without arithmetic the walk streams at 2.4 TB/s
// (0.108 and 0.167 ms), without its stores it takes the kernels' own
// time, without silu and its gradient 0.115 and 0.173; the sum costs
// 0.004.  float32 is held by its 4-byte stores (without them 0.152 and
// 0.242).  Lost, bf16 forward / backward ms: the same walk fed a tile
// ahead in registers, not by the ring, 0.347 / 0.589 (142 and 117
// registers); every step guarded 0.142 / 0.272; each rounding its own
// conversion 0.144 / 0.220; 4 slots 0.154 / 0.218 and 32-row slots 0.159
// forward (fewer blocks an SM); 16-row slots backward 0.255; 128-step
// segments 0.129 / 0.225, 512-step 0.142 / 0.209; 1 KB channel tiles
// 0.147 / 0.209; 256 threads 0.125 / 0.219; the backward at 64 registers
// (spills) 0.218.  Even: 2 slots, 8-row slots forward.
//
// Shapes the bulk copies cannot take (a row slice that is not a whole
// number of 16 bytes, a base not 16-byte aligned, S = 0) run the generic
// variant: the same walk fed by the threads' own loads, a tile ahead in
// registers (one vector or masked element loads).  The wrapper chooses the
// variant from shape, dtype and alignment before the launch
// (causal_conv1d.variant), and a launch that cannot run it is refused.

#include <cstdint>
#include <initializer_list>
#include <type_traits>

#include "mixer.cuh"

constexpr int kWidth = 4;          // K, d_conv of every configuration
constexpr int kConvThreads = 128;  // threads a block
constexpr int kThreadBytes = 4;    // bytes of a row a thread owns
constexpr int kRowBytes = kConvThreads * kThreadBytes;   // a tile row
constexpr int kTileRows = 16;      // rows a ring slot holds, forward
constexpr int kBwdTileRows = 8;    // rows a ring slot holds, backward
constexpr int kStages = 3;         // ring slots
constexpr int kSegment = 256;      // time steps a unit walks

enum Variant { kGeneric = 0, kStaged = 1 };

struct ConvArgs {
  const void* x;      // (batch, S, C)
  const void* w;      // (C, K)
  const void* bias;   // (C,)
  const void* state;  // (batch, K-1, C) or null (zeros)
  void* out;          // (batch, S, C)
  void* new_state;    // (batch, K-1, C)
  int S, C;
};

struct ConvBwdArgs {
  ConvArgs f;         // x, w, bias, state, S, C (out, new_state unused)
  const void* dout;   // (batch, S, C)
  void* dx;           // (batch, S, C)
  void* dstate;       // (batch, K-1, C) or null
  float* part;        // (batch * segments, C, K + 1): dw_0..dw_{K-1}, db
};

// V channels of T at src as float32: one load of V elements (Vec) or nv
// element loads
template <typename T, int V, bool Vec>
__device__ __forceinline__ void load_elems(const T* src, int nv,
                                           float (&v)[V]) {
  if (Vec) {
    load_packed<T, V>(src, v);
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) v[j] = j < nv ? to_f32(src[j]) : 0.f;
  }
}

template <typename T, int V, bool Vec>
__device__ __forceinline__ void store_elems(T* dst, int nv,
                                            const float (&v)[V]) {
  if (Vec) {
    store_packed<T, V>(dst, v);
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j)
      if (j < nv) dst[j] = from_f32<T>(v[j]);
  }
}

// --- the bulk-copy engine and its barriers

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_addr(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// --- row sources: tile j holds rows [r0 + j TT, min(r0 + (j+1) TT, end))
// of NT tensors (the forward's x; the backward's x and dout) for the
// block's channel tile; row(j, n, r, v) is row r of tensor n for the
// thread's channels.

// The staged variant: a ring of kStages slots in shared memory, each row
// slice one bulk copy issued by a lane of warp 0, each slot an mbarrier.
template <typename T, int NT, int TT>
struct RingRows {
  static constexpr bool kVec = true;
  static constexpr int kTileRows = TT;
  static_assert(NT * TT <= 32, "one lane of warp 0 copies a row slice");
  struct Shared {
    alignas(128) unsigned char ring[kStages][NT][TT][kRowBytes];
    uint64_t full[kStages];
  };
  static constexpr int kSmem = sizeof(Shared);   // dynamic shared memory
  Shared& sh;
  const T* src[NT];   // tensor n at (b, row 0, the tile's first channel)
  int C, r0, end;
  uint32_t bytes;     // of a row slice: the tile's channels

  __device__ RingRows(Shared& s, const T* const (&base)[NT], long long b,
                      int S, int C_, int c0, int nc, int r0_, int end_)
      : sh(s), C(C_), r0(r0_), end(end_), bytes(nc * sizeof(T)) {
#pragma unroll
    for (int n = 0; n < NT; ++n) src[n] = base[n] + b * S * C + c0;
  }
  // by warp 0: tile j into its slot
  __device__ void issue(int j) {
    const int slot = j % kStages, lane = threadIdx.x;
    const int row = r0 + j * TT, rows = min(TT, end - row);
    if (lane == 0) mbar_expect_tx(&sh.full[slot], NT * rows * bytes);
    __syncwarp();
    const int n = lane / TT, r = lane % TT;
    if (n < NT && r < rows)
      bulk_copy(&sh.ring[slot][n][r][0], src[n] + (long long)(row + r) * C,
                bytes, &sh.full[slot]);
  }
  __device__ void start(int ntiles) {
    if (threadIdx.x == 0) {
#pragma unroll
      for (int i = 0; i < kStages; ++i) mbar_init(&sh.full[i], 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    }
    __syncthreads();
    if (threadIdx.x < 32)
      for (int j = 0; j < min(kStages, ntiles); ++j) issue(j);
  }
  __device__ void acquire(int j, int) {
    mbar_wait(&sh.full[j % kStages], (j / kStages) & 1);
  }
  template <int V>
  __device__ void row(int j, int n, int r, float (&v)[V]) const {
    load_packed<T, V>(reinterpret_cast<const T*>(
                          &sh.ring[j % kStages][n][r]
                                  [threadIdx.x * kThreadBytes]),
                      v);
  }
  // every thread is done with tile j: its slot takes tile j + kStages
  __device__ void release(int j, int ntiles) {
    __syncthreads();
    if (threadIdx.x < 32 && j + kStages < ntiles) issue(j + kStages);
  }
};

// The generic variant: each thread loads its own channels of tile j + 1
// into registers while it walks tile j (one vector load a row, or masked
// element loads when not Vec).
template <typename T, int NT, int TT, bool Vec>
struct DirectRows {
  static constexpr bool kVec = Vec;
  static constexpr int kTileRows = TT;
  static constexpr int V = kThreadBytes / sizeof(T);
  using Raw = Packed<T, V>;
  struct Shared {};
  static constexpr int kSmem = 0;
  const T* src[NT];   // tensor n at (b, row 0, the thread's first channel)
  int C, r0, end, nv;
  Raw cur[NT][TT], nxt[NT][TT];

  __device__ DirectRows(Shared&, const T* const (&base)[NT], long long b,
                        int S, int C_, int c0, int nc, int r0_, int end_)
      : C(C_), r0(r0_), end(end_),
        nv(max(0, min(V, nc - (int)threadIdx.x * V))) {
#pragma unroll
    for (int n = 0; n < NT; ++n)
      src[n] = base[n] + b * S * C + c0 + threadIdx.x * V;
  }
  __device__ void fetch(int j) {
    const int row = r0 + j * TT;
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int r = 0; r < TT; ++r) {
        if (nv == 0 || row + r >= end) continue;
        const T* s = src[n] + (long long)(row + r) * C;
        if (Vec) {
          nxt[n][r] = *reinterpret_cast<const Raw*>(s);
        } else {
#pragma unroll
          for (int i = 0; i < V; ++i)
            nxt[n][r].e[i] = i < nv ? s[i] : from_f32<T>(0.f);
        }
      }
  }
  __device__ void start(int ntiles) {
    if (ntiles > 0) fetch(0);
  }
  __device__ void acquire(int j, int ntiles) {
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int r = 0; r < TT; ++r) cur[n][r] = nxt[n][r];
    if (j + 1 < ntiles) fetch(j + 1);
  }
  template <int V_>
  __device__ void row(int, int n, int r, float (&v)[V_]) const {
#pragma unroll
    for (int i = 0; i < V_; ++i) v[i] = to_f32(cur[n][r].e[i]);
  }
  __device__ void release(int, int) {}
};

// the staged variant's row sources (forward: x; backward: x and dout);
// float32 slots hold twice the rows (its 4-byte stores hold it; a longer
// slot hides them better: forward 0.213 -> 0.206 ms, backward 0.324 ->
// 0.305; bf16 is slower so)
template <typename T>
using StagedFwdRows = RingRows<T, 1, kTileRows * (sizeof(T) == 4 ? 2 : 1)>;
template <typename T>
using StagedBwdRows =
    RingRows<T, 2, kBwdTileRows * (sizeof(T) == 4 ? 2 : 1)>;

// The unit's geometry and the thread's part of it
template <typename T>
struct Unit {
  static constexpr int V = kThreadBytes / sizeof(T);
  static constexpr int kChannels = kConvThreads * V;   // a channel tile
  int c0, nc, c, nv, s0, s1;
  long long b;
  __device__ Unit(int S, int C)
      : c0(blockIdx.x * kChannels), nc(min(kChannels, C - c0)),
        c(c0 + threadIdx.x * V),
        nv(max(0, min(V, nc - (int)threadIdx.x * V))),
        s0(blockIdx.y * kSegment), s1(min(S, s0 + kSegment)),
        b(blockIdx.z) {}
};

// w, the bias and the K-1 inputs before the segment (x rows s0-K+1 ..
// s0-1: from the state, or zeros, at the sequence's head) of the thread's
// channels
template <typename T, int K, int V, bool Vec>
__device__ __forceinline__ void prologue(const ConvArgs& p, const Unit<T>& u,
                                         float (&w)[K][V], float (&bias)[V],
                                         float (&win)[K - 1][V]) {
  const T* wg = static_cast<const T*>(p.w);
  const T* bg = static_cast<const T*>(p.bias);
#pragma unroll
  for (int j = 0; j < V; ++j) {
#pragma unroll
    for (int k = 0; k < K; ++k)
      w[k][j] = j < u.nv ? to_f32(wg[(long long)(u.c + j) * K + k]) : 0.f;
    bias[j] = j < u.nv ? to_f32(bg[u.c + j]) : 0.f;
  }
  const T* xg = static_cast<const T*>(p.x);
  const T* sg = static_cast<const T*>(p.state);
#pragma unroll
  for (int i = 0; i < K - 1; ++i) {
    const int r = u.s0 - (K - 1) + i;
    if (r >= 0)
      load_elems<T, V, Vec>(xg + (u.b * p.S + r) * p.C + u.c, u.nv, win[i]);
    else if (sg)
      load_elems<T, V, Vec>(sg + (u.b * (K - 1) + r + K - 1) * p.C + u.c,
                            u.nv, win[i]);
    else
#pragma unroll
      for (int j = 0; j < V; ++j) win[i][j] = 0.f;
  }
}

// v rounded to T, as float32: bf16 pairs by one conversion that packs two
template <typename T, int V>
__device__ __forceinline__ void round_all(float (&v)[V]) {
  if constexpr (std::is_same_v<T, __nv_bfloat16> && V % 2 == 0) {
#pragma unroll
    for (int j = 0; j < V; j += 2) {
      const float2 f =
          __bfloat1622float2(__floats2bfloat162_rn(v[j], v[j + 1]));
      v[j] = f.x;
      v[j + 1] = f.y;
    }
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) v[j] = round_to<T>(v[j]);
  }
}

// the pre-activations round_T(round_T(conv) + b) of the thread's channels:
// win holds xp rows t .. t+K-2, cur row t+K-1
template <typename T, int K, int V>
__device__ __forceinline__ void pre_acts(const float (&win)[K - 1][V],
                                         const float (&cur)[V],
                                         const float (&w)[K][V],
                                         const float (&bias)[V],
                                         float (&pre)[V]) {
#pragma unroll
  for (int j = 0; j < V; ++j) {
    float acc = __fmul_rn(win[0][j], w[0][j]);
#pragma unroll
    for (int k = 1; k < K - 1; ++k)
      acc = __fadd_rn(acc, __fmul_rn(win[k][j], w[k][j]));
    pre[j] = __fadd_rn(acc, __fmul_rn(cur[j], w[K - 1][j]));
  }
  round_all<T, V>(pre);
#pragma unroll
  for (int j = 0; j < V; ++j) pre[j] = __fadd_rn(pre[j], bias[j]);
  round_all<T, V>(pre);
}

template <int K, int V>
__device__ __forceinline__ void shift_in(float (&win)[K - 1][V],
                                         const float (&cur)[V]) {
#pragma unroll
  for (int i = 0; i < K - 2; ++i)
#pragma unroll
    for (int j = 0; j < V; ++j) win[i][j] = win[i + 1][j];
#pragma unroll
  for (int j = 0; j < V; ++j) win[K - 2][j] = cur[j];
}

template <typename T, int K, class Rows>
__global__ void __launch_bounds__(kConvThreads)
causal_conv1d_silu_kernel(const ConvArgs p) {
  constexpr int V = Unit<T>::V, TT = Rows::kTileRows;
  constexpr bool Vec = Rows::kVec;
  extern __shared__ __align__(128) unsigned char smem[];
  const Unit<T> u(p.S, p.C);
  const int ntiles = (u.s1 - u.s0 + TT - 1) / TT;
  const T* const srcs[1] = {static_cast<const T*>(p.x)};
  Rows rows(*reinterpret_cast<typename Rows::Shared*>(smem), srcs, u.b, p.S,
            p.C, u.c0, u.nc, u.s0, u.s1);
  rows.start(ntiles);
  T* __restrict__ og = static_cast<T*>(p.out);

  // win[i]: xp row t + i for the next step t
  float w[K][V], bias[V], win[K - 1][V];
  if (u.nv > 0) prologue<T, K, V, Vec>(p, u, w, bias, win);
  for (int j = 0; j < ntiles; ++j) {
    rows.acquire(j, ntiles);
    const int t0 = u.s0 + j * TT, n = min(TT, u.s1 - t0);
    if (u.nv > 0) {
      T* o = og + (u.b * p.S + t0) * p.C + u.c;   // xc row t0
      const auto step = [&](int r) {
        float cur[V], y[V];
        rows.row(j, 0, r, cur);
        pre_acts<T, K, V>(win, cur, w, bias, y);
#pragma unroll
        for (int i = 0; i < V; ++i) y[i] = silu_f32(y[i]);
        store_elems<T, V, Vec>(o, u.nv, y);
        o += p.C;
        shift_in<K, V>(win, cur);
      };
      if (n == TT) {   // a whole tile: no step's guard
#pragma unroll
        for (int r = 0; r < TT; ++r) step(r);
      } else {
#pragma unroll
        for (int r = 0; r < TT; ++r)
          if (r < n) step(r);
      }
    }
    rows.release(j, ntiles);
  }
  // the last segment's window is xp[S : S+K-1], the new state
  if (blockIdx.y == gridDim.y - 1 && u.nv > 0) {
    T* ns = static_cast<T*>(p.new_state);
#pragma unroll
    for (int i = 0; i < K - 1; ++i)
      store_elems<T, V, Vec>(ns + (u.b * (K - 1) + i) * p.C + u.c, u.nv,
                             win[i]);
  }
}

// silu's backward as PyTorch's kernel writes it, each operation rounded
// (no contraction): dout * s * (1 + v * (1 - s)), s = 1 / (1 + exp(-v))
__device__ __forceinline__ float silu_grad_f32(float dout, float v) {
  const float s = __fdiv_rn(1.f, __fadd_rn(1.f, expf(-v)));
  return __fmul_rn(__fmul_rn(dout, s),
                   __fadd_rn(1.f, __fmul_rn(v, __fsub_rn(1.f, s))));
}

// The backward of a unit: its segment [s0, s1) owns dx rows s0 .. s1-1 and
// the dw, db terms of steps s0 .. s1-1; dx row s needs dpre of steps s ..
// s+K-1, so the walk runs K-1 steps past s1 (dpre 0 past S).
template <typename T, int K, class Rows>
__global__ void __launch_bounds__(kConvThreads)
causal_conv1d_silu_bwd_kernel(const ConvBwdArgs p) {
  constexpr int V = Unit<T>::V, TT = Rows::kTileRows;
  constexpr bool Vec = Rows::kVec;
  const ConvArgs& f = p.f;
  extern __shared__ __align__(128) unsigned char smem[];
  const Unit<T> u(f.S, f.C);
  const int end = min(f.S, u.s1 + K - 1);
  const int ntiles = (end - u.s0 + TT - 1) / TT;
  const T* const srcs[2] = {static_cast<const T*>(f.x),
                            static_cast<const T*>(p.dout)};
  Rows rows(*reinterpret_cast<typename Rows::Shared*>(smem), srcs, u.b, f.S,
            f.C, u.c0, u.nc, u.s0, end);
  rows.start(ntiles);
  T* __restrict__ dxg = static_cast<T*>(p.dx);
  T* __restrict__ dsg = static_cast<T*>(p.dstate);

  // win[i]: xp row t + i for the next step t; dq[i]: dpre of step
  // t - K + 1 + i (zeros before the segment: no dx row of it reads them)
  float w[K][V], bias[V], win[K - 1][V], dq[K][V], dw[K][V], db[V];
  if (u.nv > 0) prologue<T, K, V, Vec>(f, u, w, bias, win);
#pragma unroll
  for (int j = 0; j < V; ++j) {
    db[j] = 0.f;
#pragma unroll
    for (int k = 0; k < K; ++k) dw[k][j] = dq[k][j] = 0.f;
  }
  // step t: its dpre into dq[K-1] (and the window moved on)
  const auto push = [&](const float (&cur)[V], const float (&dnew)[V]) {
    shift_in<K, V>(win, cur);
#pragma unroll
    for (int i = 0; i < K - 1; ++i)
#pragma unroll
      for (int j = 0; j < V; ++j) dq[i][j] = dq[i + 1][j];
#pragma unroll
    for (int j = 0; j < V; ++j) dq[K - 1][j] = dnew[j];
  };
  // dxp row t = sum_k dpre_{t-k} w_k, k = 0 first (after step t's push)
  const auto dxp = [&](float (&v)[V]) {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      float acc = 0.f;
#pragma unroll
      for (int k = 0; k < K; ++k)
        acc = __fadd_rn(acc, __fmul_rn(dq[K - 1 - k][j], w[k][j]));
      v[j] = acc;
    }
  };
  // dxp row t is dx row t-K+1, or dstate row t at the sequence's head
  const auto emit = [&](int t) {
    const int s = t - (K - 1);
    if (s < u.s0 && !(s < 0 && dsg)) return;
    float v[V];
    dxp(v);
    if (s >= u.s0)
      store_elems<T, V, Vec>(dxg + (u.b * f.S + s) * f.C + u.c, u.nv, v);
    else
      store_elems<T, V, Vec>(dsg + (u.b * (K - 1) + s + K - 1) * f.C + u.c,
                             u.nv, v);
  };

  for (int j = 0; j < ntiles; ++j) {
    rows.acquire(j, ntiles);
    const int t0 = u.s0 + j * TT, n = min(TT, end - t0);
    if (u.nv > 0) {
      // dpre of row r of the tile, with x row t (cur)
      const auto grad = [&](int r, float (&cur)[V], float (&dnew)[V]) {
        float dov[V];
        rows.row(j, 0, r, cur);
        rows.row(j, 1, r, dov);
        pre_acts<T, K, V>(win, cur, w, bias, dnew);
#pragma unroll
        for (int i = 0; i < V; ++i) dnew[i] = silu_grad_f32(dov[i], dnew[i]);
        round_all<T, V>(dnew);
      };
      // a step of the segment: its dw and db terms
      const auto accumulate = [&](const float (&cur)[V],
                                  const float (&dnew)[V]) {
#pragma unroll
        for (int i = 0; i < V; ++i) {
          db[i] += dnew[i];
#pragma unroll
          for (int k = 0; k < K - 1; ++k) dw[k][i] += dnew[i] * win[k][i];
          dw[K - 1][i] += dnew[i] * cur[i];
        }
      };
      if (n == TT && t0 >= u.s0 + K - 1 && t0 + TT <= u.s1) {
        // inside the segment: every step adds its terms and a dx row
        T* d = dxg + (u.b * f.S + t0 - (K - 1)) * f.C + u.c;
#pragma unroll
        for (int r = 0; r < TT; ++r) {
          float cur[V], dnew[V], v[V];
          grad(r, cur, dnew);
          accumulate(cur, dnew);
          push(cur, dnew);
          dxp(v);
          store_elems<T, V, Vec>(d, u.nv, v);
          d += f.C;
        }
      } else {
#pragma unroll
        for (int r = 0; r < TT; ++r) {
          if (r < n) {
            float cur[V], dnew[V];
            grad(r, cur, dnew);
            if (t0 + r < u.s1) accumulate(cur, dnew);
            push(cur, dnew);
            emit(t0 + r);
          }
        }
      }
    }
    rows.release(j, ntiles);
  }
  if (u.nv == 0) return;
  // past S: dpre 0, the last dx rows (and dstate when S < K-1)
  for (int t = end; t < u.s1 + K - 1; ++t) {
    const float zero[V] = {};
#pragma unroll
    for (int i = 0; i < K - 1; ++i)
#pragma unroll
      for (int j = 0; j < V; ++j) dq[i][j] = dq[i + 1][j];
#pragma unroll
    for (int j = 0; j < V; ++j) dq[K - 1][j] = zero[j];
    emit(t);
  }
  float* part = p.part + ((u.b * gridDim.y + blockIdx.y) * f.C + u.c) *
                             (K + 1);
#pragma unroll
  for (int j = 0; j < V; ++j) {
    if (j < u.nv) {
#pragma unroll
      for (int k = 0; k < K; ++k) part[j * (K + 1) + k] = dw[k][j];
      part[j * (K + 1) + K] = db[j];
    }
  }
}

// dw (C, K) and db (C,) summed over the partials in their order
template <int K>
__global__ void __launch_bounds__(256)
causal_conv1d_bwd_reduce_kernel(const float* __restrict__ part,
                                float* __restrict__ dw,
                                float* __restrict__ db, int parts, int C) {
  const long long i = blockIdx.x * 256ll + threadIdx.x;
  if (i >= (long long)C * (K + 1)) return;
  const int c = (int)(i / (K + 1)), k = (int)(i % (K + 1));
  float v = 0.f;
  for (int q = 0; q < parts; ++q) v += part[(long long)q * C * (K + 1) + i];
  if (k < K) dw[(long long)c * K + k] = v;
  else db[c] = v;
}

static int segments(int S) {
  return S > 0 ? (S + kSegment - 1) / kSegment : 1;
}

static bool aligned(const void* q, int bytes) {
  return reinterpret_cast<uintptr_t>(q) % bytes == 0;
}

// Which kernel runs: kStaged needs S >= 1, a row slice of the channel tile
// a whole number of 16 bytes and the bulk copies' sources 16-byte aligned;
// both variants' vector accesses need every tensor aligned to V elements.
// Returns 1 (vector accesses), 0 (element accesses) or -1 (refused).
template <typename T>
static int check_variant(int variant, int S, int C,
                         std::initializer_list<const void*> copied,
                         std::initializer_list<const void*> rest) {
  constexpr int V = kThreadBytes / (int)sizeof(T);
  bool vec = C % V == 0;
  for (const void* q : copied) vec = vec && (!q || aligned(q, V * sizeof(T)));
  for (const void* q : rest) vec = vec && (!q || aligned(q, V * sizeof(T)));
  if (variant == kGeneric) return vec ? 1 : 0;
  if (variant != kStaged || !vec || S < 1 || (C * sizeof(T)) % 16) return -1;
  for (const void* q : copied)
    if (!aligned(q, 16)) return -1;
  return 1;
}

// kernel<<<(channel tiles, segments, batch)>>> with the ring's shared
// memory (above 48 KB only once the kernel is allowed it)
template <typename T, class Rows, typename Kernel, typename Args>
static int launch(Kernel kernel, const Args& p, int S, int C, int batch,
                  cudaStream_t stream) {
  const int tiles = (C + Unit<T>::kChannels - 1) / Unit<T>::kChannels;
  const dim3 grid(tiles, segments(S), batch);
  if (Rows::kSmem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Rows::kSmem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<grid, kConvThreads, Rows::kSmem, stream>>>(p);
  RT_RETURN_IF_ERROR();
  return 0;
}

template <typename T, class Rows>
static int launch_fwd(const ConvArgs& p, int batch, cudaStream_t stream) {
  return launch<T, Rows>(causal_conv1d_silu_kernel<T, kWidth, Rows>, p, p.S,
                         p.C, batch, stream);
}

template <typename T, class Rows>
static int launch_bwd(const ConvBwdArgs& p, int batch, cudaStream_t stream) {
  return launch<T, Rows>(causal_conv1d_silu_bwd_kernel<T, kWidth, Rows>, p,
                         p.f.S, p.f.C, batch, stream);
}

static bool bad_shape(int batch, int S, int C, int K) {
  return batch < 1 || batch > 65535 || S < 0 || C < 1 || K != kWidth ||
         segments(S) > 65535;
}

template <typename T>
static int conv(const void* x, const void* w, const void* bias,
                const void* state, void* out, void* new_state, int batch,
                int S, int C, int K, int variant, void* stream) {
  if (bad_shape(batch, S, C, K)) return (int)cudaErrorInvalidValue;
  const int vec = check_variant<T>(variant, S, C, {x},
                                   {state, out, new_state});
  if (vec < 0) return (int)cudaErrorInvalidValue;
  const ConvArgs p{x, w, bias, state, out, new_state, S, C};
  const auto s = static_cast<cudaStream_t>(stream);
  if (variant == kStaged) return launch_fwd<T, StagedFwdRows<T>>(p, batch, s);
  return vec ? launch_fwd<T, DirectRows<T, 1, kTileRows, true>>(p, batch, s)
             : launch_fwd<T, DirectRows<T, 1, kTileRows, false>>(p, batch, s);
}

template <typename T>
static int conv_bwd(const void* x, const void* w, const void* bias,
                    const void* state, const void* dout, void* dx,
                    void* dstate, void* part, int batch, int S, int C, int K,
                    int variant, void* stream) {
  if (bad_shape(batch, S, C, K)) return (int)cudaErrorInvalidValue;
  const int vec = check_variant<T>(variant, S, C, {x, dout},
                                   {state, dx, dstate});
  if (vec < 0) return (int)cudaErrorInvalidValue;
  const ConvBwdArgs p{{x, w, bias, state, nullptr, nullptr, S, C}, dout, dx,
                      dstate, static_cast<float*>(part)};
  const auto s = static_cast<cudaStream_t>(stream);
  if (variant == kStaged) return launch_bwd<T, StagedBwdRows<T>>(p, batch, s);
  return vec
      ? launch_bwd<T, DirectRows<T, 2, kBwdTileRows, true>>(p, batch, s)
      : launch_bwd<T, DirectRows<T, 2, kBwdTileRows, false>>(p, batch, s);
}

extern "C" {
// time steps a unit walks: the backward's partials are (batch *
// ceil(S / segment), C, K + 1) (batch rows of them at S = 0)
int rt_causal_conv1d_segment() { return kSegment; }
// x, out: (batch, S, C); w: (C, K); bias: (C,); state (or null), new_state:
// (batch, K-1, C); all in one type (float32 or bf16), contiguous; variant:
// 0 generic, 1 staged (refused unless the shape and alignment allow it).
int rt_causal_conv1d_silu_f32(const void* x, const void* w, const void* bias,
                              const void* state, void* out, void* new_state,
                              int batch, int S, int C, int K, int variant,
                              void* stream) {
  return conv<float>(x, w, bias, state, out, new_state, batch, S, C, K,
                     variant, stream);
}
int rt_causal_conv1d_silu_bf16(const void* x, const void* w, const void* bias,
                               const void* state, void* out, void* new_state,
                               int batch, int S, int C, int K, int variant,
                               void* stream) {
  return conv<__nv_bfloat16>(x, w, bias, state, out, new_state, batch, S, C,
                             K, variant, stream);
}
// x, dout, dx: (batch, S, C); w: (C, K); bias: (C,); state, dstate (each
// or null): (batch, K-1, C); all in one type, contiguous; part: the
// partials, float32 scratch (rt_causal_conv1d_segment); variant as above.
int rt_causal_conv1d_silu_bwd_f32(const void* x, const void* w,
                                  const void* bias, const void* state,
                                  const void* dout, void* dx, void* dstate,
                                  void* part, int batch, int S, int C, int K,
                                  int variant, void* stream) {
  return conv_bwd<float>(x, w, bias, state, dout, dx, dstate, part, batch, S,
                         C, K, variant, stream);
}
int rt_causal_conv1d_silu_bwd_bf16(const void* x, const void* w,
                                   const void* bias, const void* state,
                                   const void* dout, void* dx, void* dstate,
                                   void* part, int batch, int S, int C, int K,
                                   int variant, void* stream) {
  return conv_bwd<__nv_bfloat16>(x, w, bias, state, dout, dx, dstate, part,
                                 batch, S, C, K, variant, stream);
}
// part: (parts, C, K + 1) float32; dw: (C, K), db: (C,) float32.
int rt_causal_conv1d_bwd_reduce(const void* part, void* dw, void* db,
                                int parts, int C, int K, void* stream) {
  if (K != kWidth || C < 1) return (int)cudaErrorInvalidValue;
  const long long n = (long long)C * (K + 1);
  causal_conv1d_bwd_reduce_kernel<kWidth>
      <<<(int)((n + 255) / 256), 256, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const float*>(part), static_cast<float*>(dw),
          static_cast<float*>(db), parts, C);
  RT_RETURN_IF_ERROR();
  return 0;
}
}
