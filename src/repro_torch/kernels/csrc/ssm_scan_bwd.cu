// The backward of the fused Mamba-1 mixer (rt_mamba_scan_* of ssm_scan.cu:
// softplus, the selective scan and the gate), for training on Hopper.
//
// Replaces no Pallas kernel: the JAX package differentiates its recurrence
// through the custom_vjp of chunked_linear_recurrence, whose backward
// (_clr_bwd, src/repro/models/layers.py:388) runs the same recurrence in
// reverse, and lets XLA differentiate softplus and the gate around it.
// Per batch row b, channel d and state n, with dt = softplus(dt_lin + bias),
// u = dt x, a_t = exp(dt_t A), h_t = a_t h_{t-1} + u_t B_t and
// y_t = h_t . C_t + D x_t gated by silu(z_t) in the activation type T:
//
//   dy'_t  = round_T(dy_t * round_T(silu(z_t)))        the gate's backward
//   dz_t   = round_T(round_T(dy_t * round_T(y_t)) * silu'(z_t))
//   lam_t  = C_t dy'_t + a_{t+1} lam_{t+1}              (+ dh_last at t = S-1)
//   dB_t   = sum_d lam_t u_t,   dC_t = sum_d dy'_t h_t
//   du_t   = sum_n lam_t B_t,   g_t = lam_t h_{t-1} a_t
//   dA    += sum_{b,t} g_t dt_t,  d dt_t = sum_n g_t A + du_t x_t
//   dx_t   = du_t dt_t + dy'_t D,  dD += dy'_t x_t
//   d dt_lin = d dt * sigmoid(dt_lin + bias),  d bias = sum_{b,t} d dt_lin
//   dh0    = a_0 lam_0
//
// as the plain version (src/repro_torch/kernels/ref.py, mamba_scan_bwd)
// computes them, in float32 (state and adjoint) from T or float32 inputs.
//
// The design:
// - Four lanes per (batch row, channel), each with a quarter of the N
//   states; a block owns 64 channels of one batch row (256 threads), so
//   carried values never leave the block's loop and no order between
//   blocks is assumed.  Two blocks share an SM at up to 128 registers a
//   thread (the forward's occupancy), not four at 64: the decays of a
//   segment need the registers.  One lane a channel, all N states in it,
//   ran eight warps an SM and was slower (PERF.md §6).
// - The segment states.  The backward needs the float32 states in reverse
//   and the forward keeps none per step: time goes in segments of 8 steps,
//   and the state at each segment's start comes either from the forward
//   kernel (rt_mamba_scan_* with its `states` output; the entry
//   rt_mamba_scan_bwd_ckpt_*, which reads them), or from the kernel's own
//   walk forward from h0 over the whole sequence (rt_mamba_scan_bwd_*,
//   which writes them to the scratch `ckpt` first).  Both form a state
//   with the same instructions (ex2.approx of dt A log2 e, an FFMA with
//   u B, softplus_fast of mixer.cuh), so the two entries give the same
//   bits.  Training asks the forward for them in remat's recompute, which
//   runs right before the layer's backward; everywhere else the walk runs.
// - Each decay formed once in the backward.  The segments go last first:
//   the recompute runs the segment's 8 steps forward from its checkpoint,
//   keeping each exp(dt A) in registers (8 steps x a lane's states) and
//   the state before each step in shared memory (private to the lane),
//   with y of each step; the adjoint runs back through the same steps and
//   takes the decays from the registers.  So the adjoint's steps issue no
//   exponential (the walk, when it runs, forms a second set).  The steps
//   run all 8 unguarded (a segment's missing steps have dt = 0, a decay
//   of 1, and no input), one basic block the compiler can schedule.
// - Loads a segment ahead.  One barrier a segment.  Right after it, each
//   thread issues the global loads of segment k-2 (x, dt_lin, z, dy per
//   (t, d), a share of the B and C rows and of the checkpoints) into
//   registers, which are stored a whole segment later.  Then, in one
//   phase, it finishes segment k+1 (what depends on a whole segment: dx,
//   dz, d dt_lin; the dB | dC sums over the block's warps, coalesced) and
//   stores segment k-1, loaded the segment before, prepared into the
//   buffer segment k+1 frees (dt = softplus, u = dt x, dy', the softplus
//   and silu derivatives once per (t, d); B and C rows zero-padded to NP;
//   the checkpoints into their slot): four independent items a thread
//   between two barriers.  Then segment k's steps.  Item warps of their
//   own beside the step warps (warp specialization) were slower: four of
//   them could not keep up with eight step warps (PERF.md §6).
// - Deterministic sums across blocks.  dB and dC (sums over d_inner) are
//   reduced within a warp by a butterfly reduce-scatter over its eight
//   channels (seven shuffles for a lane's eight values), then over the
//   block's warps in shared memory, and written per block as partials; dA,
//   dD and d dt_bias per batch row.  A second launch
//   (rt_mamba_scan_bwd_reduce) sums the partials in a fixed order, so the
//   same inputs give the same bits.  No atomics.
// - B and C are read in place from the x_proj output (row strides given),
//   as the forward reads them; their gradients come out contiguous
//   (float32, (batch, S, N) each).
//
// Bound on this card, at the training shape (B 4, S 2048, d_inner 8192,
// N 16, bf16): the bytes the function must move (x, z, dy, dx, dz in bf16,
// dt_lin and d dt_lin in float32; ~1.2 GB, ~0.36 ms at 3.35 TB/s), just
// above its exponentials once each (1.07e9 on the special-function units,
// 16 a clock an SM, ~0.32 ms with the per-(t, d) ones).  Besides, the
// checkpoints are read once (~0.54 GB; the walk writes them first), and
// each lane issues ~9 FP32 operations a state and step in the adjoint and
// ~4 in the recompute, with the warp's dB | dC reduce-scatter; the
// adjoint is the largest part of the time, then the per-(t, d) phases
// (scripts/ab_mamba_scan_bwd.py's probes leave each out).

#include <cstdint>

#include "mixer.cuh"

constexpr int kBwdChannels = 64;  // channels per block
constexpr int kLanes = 4;         // lanes per channel
constexpr int kBwdThreads = kBwdChannels * kLanes;
constexpr int kBwdWarps = kBwdThreads / 32;
constexpr int kSeg = 8;           // time steps per segment
constexpr int kSegItems = kSeg * kBwdChannels;   // (t, d) of a segment
constexpr int kItems = kSegItems / kBwdThreads;  // of them a thread
constexpr int kBwdMaxState = 32;
constexpr float kLn2 = 0.6931471805599453f;

struct BwdArgs {
  const void* x;          // (batch, S, di) T
  const float* dt_lin;    // (batch, S, di)
  const float* dt_bias;   // (di,)
  const void* bm;         // B: row (b, t) at b * bc_sb + t * bc_ss elements
  const void* cm;         // C: the same strides
  long long bc_sb, bc_ss;
  const float* a;         // (di, N), negative
  const float* dskip;     // (di,)
  const void* z;          // (batch, S, di) T
  const float* h0;        // (batch, di, N) or null (zero state)
  const void* dy;         // (batch, S, di) T
  const float* dh_last;   // (batch, di, N) or null
  void* dx;               // (batch, S, di) T
  float* ddt_lin;         // (batch, S, di)
  void* dz;               // (batch, S, di) T
  float* dh0;             // (batch, di, N) or null
  float* part_bc;         // (batch, S, groups, 2N): dB | dC per block
  float* ckpt;            // (batch, nseg, di, N): states at segment starts
  float* part_d;          // (batch, N + 2, di): dA rows, dD, d dt_bias
  int S, di, N, groups;
};

// One block's shared memory in floats: the lanes' states (slot s the state
// before step s; [s][c][n]) and checkpoints (two slots, segments of either
// parity; [c][n]), then two buffers (segments of either parity), each with
// per (step, channel) the float4 (dt, u, dy', x), the softplus derivative,
// sigmoid(z) and 1 + z (1 - sigmoid(z)) (silu's derivative is their
// product), dy, y, du and sum_n g A, then B and C rows ([s][B | C], NP
// each, zero-padded) and the warps' dB | dC sums.
template <int NP>
struct BwdSmem {
  static constexpr int SPL = NP / kLanes;            // states a lane
  static constexpr int V = 2 * SPL > 8 ? 2 * SPL : 8;  // dB | dC a lane, padded
  static constexpr int VO = V / 8;                   // after the scatter
  static constexpr int sh = 0;
  static constexpr int ck = sh + kSeg * kBwdChannels * NP;
  static constexpr int buf0 = ck + 2 * kBwdChannels * NP;
  static constexpr int rec = 0;                      // within a buffer
  static constexpr int sig = rec + 4 * kSegItems;
  static constexpr int sz = sig + kSegItems;
  static constexpr int wz = sz + kSegItems;
  static constexpr int dy = wz + kSegItems;
  static constexpr int y = dy + kSegItems;
  static constexpr int du = y + kSegItems;
  static constexpr int ga = du + kSegItems;
  static constexpr int bc = ga + kSegItems;
  static constexpr int red = bc + kSeg * 2 * NP;
  static constexpr int buf = red + kSeg * kBwdWarps * kLanes * V;
  static constexpr int floats = buf0 + 2 * buf;
  static constexpr int bytes = floats * 4;
  static constexpr int kBlocksPerSm = NP <= 16 ? 2 : 1;
  static_assert(SPL >= 1 && NP % kLanes == 0, "N padded to whole lanes");
  static_assert(buf0 % 4 == 0 && buf % 4 == 0 && bc % 4 == 0,
                "16-byte aligned regions");
};

// One step of the reduce-scatter below, at lane distance O: the lane with
// bit O set keeps the upper half of its values and adds its partner's.
template <int O, int M>
__device__ __forceinline__ void reduce_scatter_step(float (&v)[M], int lane) {
  const bool up = lane & O;
#pragma unroll
  for (int i = 0; i < M / 2; ++i) {
    const float lo = v[i], hi = v[i + M / 2];
    const float send = up ? lo : hi;
    v[i] = (up ? hi : lo) + __shfl_xor_sync(0xffffffffu, send, O);
  }
}
// v (V values a lane) summed over the warp's eight channels (lane bits 2-4)
// and scattered: the lane of channel j (of 8) in the warp ends with the sums
// of values [j V/8, (j + 1) V/8) in v[0 .. V/8).
template <int V>
__device__ __forceinline__ void reduce_channels(float (&v)[V], int lane) {
  reduce_scatter_step<16, V>(v, lane);
  float w[V / 2];
#pragma unroll
  for (int i = 0; i < V / 2; ++i) w[i] = v[i];
  reduce_scatter_step<8, V / 2>(w, lane);
  float q[V / 4];
#pragma unroll
  for (int i = 0; i < V / 4; ++i) q[i] = w[i];
  reduce_scatter_step<4, V / 4>(q, lane);
#pragma unroll
  for (int i = 0; i < V / 8; ++i) v[i] = q[i];
}

// the sum of v over a channel's four lanes, in every one of them
__device__ __forceinline__ float lanes_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// n consecutive floats of shared memory, 16 bytes a load where n allows
template <int n>
__device__ __forceinline__ void lds(const float* src, float (&v)[n]) {
  if constexpr (n % 4 == 0) {
#pragma unroll
    for (int i = 0; i < n; i += 4) {
      const float4 q = *reinterpret_cast<const float4*>(src + i);
      v[i] = q.x, v[i + 1] = q.y, v[i + 2] = q.z, v[i + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < n; ++i) v[i] = src[i];
  }
}
template <int n>
__device__ __forceinline__ void sts(float* dst, const float (&v)[n]) {
  if constexpr (n % 4 == 0) {
#pragma unroll
    for (int i = 0; i < n; i += 4)
      *reinterpret_cast<float4*>(dst + i) =
          make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
  } else {
#pragma unroll
    for (int i = 0; i < n; ++i) dst[i] = v[i];
  }
}

// A thread's share of one segment's global loads, held in registers from
// the fetch (right after a barrier) to the deposit (after the next
// barrier): x, dt_lin, z, dy of its kItems (step, channel) items, kBc
// values of the B | C rows, and its lane's checkpoint.
template <typename T, int NP>
struct Raw {
  static constexpr int SPL = NP / kLanes;
  static constexpr int kBc = (kSeg * 2 * NP + kBwdThreads - 1) / kBwdThreads;
  float x[kItems], dtl[kItems], z[kItems], dy[kItems], bc[kBc], h[SPL];
  int tk;   // the segment's steps

  // segment k of batch row b, channels [c0, c0 + 64); `grad` false loads
  // only what the walk needs (x, dt_lin, B)
  __device__ __forceinline__ void fetch(const BwdArgs& p, long long b, int c0,
                                        int k, int tid, bool grad) {
    const int t0 = k * kSeg;
    tk = min(kSeg, p.S - t0);
    const int c = tid % kBwdChannels;
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int s = (tid + j * kBwdThreads) / kBwdChannels;
      x[j] = dtl[j] = z[j] = dy[j] = 0.f;
      if (s < tk && c0 + c < p.di) {
        const long long row = (b * p.S + t0 + s) * p.di + c0 + c;
        x[j] = to_f32(static_cast<const T*>(p.x)[row]);
        dtl[j] = p.dt_lin[row];
        if (grad) {
          z[j] = to_f32(static_cast<const T*>(p.z)[row]);
          dy[j] = to_f32(static_cast<const T*>(p.dy)[row]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kBc; ++i) {
      const int e = tid + i * kBwdThreads;
      const int s = e / (2 * NP), m = (e / NP) % 2, n = e % NP;
      bc[i] = 0.f;
      if (e < kSeg * 2 * NP && s < tk && n < p.N && (m == 0 || grad))
        bc[i] = to_f32(static_cast<const T*>(m ? p.cm : p.bm)
                           [b * p.bc_sb + (long long)(t0 + s) * p.bc_ss + n]);
    }
    if (grad) {
      const int d = c0 + tid / kLanes, n0 = SPL * (tid % kLanes);
      const int nseg = (p.S + kSeg - 1) / kSeg;
#pragma unroll
      for (int i = 0; i < SPL; ++i)
        h[i] = (d < p.di && n0 + i < p.N)
                   ? p.ckpt[((b * nseg + k) * p.di + d) * p.N + n0 + i] : 0.f;
    }
  }

  // into buffer `buf`: (dt, u, dy', x), the softplus derivative, the
  // factors of silu's derivative and dy per item, formed once per (t, d)
  // (softplus and its derivative from one exponential, silu and its
  // derivative from another); the B | C rows; the checkpoint into slot 0
  // slot `ck` of the lane.  Steps past the segment's end get dt = 0
  // (and u = dy' = 0, B = C = 0 from the fetch), so the steps run all
  // kSeg of them unguarded: a decay of 1, no input, no gradient.
  __device__ __forceinline__ void deposit(float* buf, float* ck, float bias,
                                          int tid, bool grad) const {
    using Sm = BwdSmem<NP>;
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int e = tid + j * kBwdThreads;
      const float v = bias + dtl[j];
      const float ev = __expf(-fabsf(v));
      const float dt = e / kBwdChannels < tk ? softplus_of(v, ev) : 0.f;
      float dyp = 0.f;
      if (grad) {
        dyp = round_to<T>(dy[j] * round_to<T>(silu_fast(z[j])));
        const float sg = __fdividef(1.f, 1.f + __expf(-z[j]));
        buf[Sm::sig + e] = __fdividef(v >= 0.f ? 1.f : ev, 1.f + ev);
        buf[Sm::sz + e] = sg;
        buf[Sm::wz + e] = 1.f + z[j] * (1.f - sg);
        buf[Sm::dy + e] = dy[j];
      }
      reinterpret_cast<float4*>(buf + Sm::rec)[e] =
          make_float4(dt, dt * x[j], dyp, x[j]);
    }
#pragma unroll
    for (int i = 0; i < kBc; ++i) {
      const int e = tid + i * kBwdThreads;
      if (e < kSeg * 2 * NP) buf[Sm::bc + e] = bc[i];
    }
    if (grad) sts(ck, h);
  }
};

template <typename T, int NP, bool Walk>
__global__ void __launch_bounds__(kBwdThreads, BwdSmem<NP>::kBlocksPerSm)
mamba_scan_bwd_kernel(const BwdArgs p) {
  using Sm = BwdSmem<NP>;
  constexpr int SPL = Sm::SPL, V = Sm::V, VO = Sm::VO;
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int c = tid / kLanes, l = tid % kLanes;
  const int g = blockIdx.x, c0 = g * kBwdChannels, d = c0 + c;
  const long long b = blockIdx.y;
  const int S = p.S, di = p.di, N = p.N;
  const bool on = d < di;
  const int nseg = (S + kSeg - 1) / kSeg;
  const int n0 = SPL * l;            // this lane's first state
  // this lane's states: slot s at hs + s * kBwdChannels * NP; its
  // checkpoint of segment k
  float* hs = smem + Sm::sh + c * NP + n0;
  const auto ck_of = [&](int k) {
    return smem + Sm::ck + ((k & 1) * kBwdChannels + c) * NP + n0;
  };
  const auto buf_of = [&](int k) { return smem + Sm::buf0 + (k & 1) * Sm::buf; };
  const auto steps_of = [&](int k) { return min(kSeg, S - k * kSeg); };

  float a2[SPL];
#pragma unroll
  for (int i = 0; i < SPL; ++i)
    a2[i] = (on && n0 + i < N) ? p.a[(long long)d * N + n0 + i] * kLog2e
                               : 0.f;
  // the channel of this thread's items in the deposit and the finish:
  // tid % 64, the same for each item
  const int df = c0 + tid % kBwdChannels;
  const float bias = df < di ? p.dt_bias[df] : 0.f;
  const float dski = df < di ? p.dskip[df] : 0.f;

  if constexpr (Walk) {
    // the walk forward from h0: the state at every segment's start
    float h[SPL];
#pragma unroll
    for (int i = 0; i < SPL; ++i)
      h[i] = (on && p.h0 && n0 + i < N) ? p.h0[(b * di + d) * N + n0 + i]
                                        : 0.f;
    float* buf = buf_of(0);
    for (int k = 0; k < nseg; ++k) {
      if (on) {
#pragma unroll
        for (int i = 0; i < SPL; ++i)
          if (n0 + i < N)
            p.ckpt[((b * nseg + k) * di + d) * N + n0 + i] = h[i];
      }
      if (k == nseg - 1) break;
      __syncthreads();
      Raw<T, NP> rw;
      rw.fetch(p, b, c0, k, tid, false);
      rw.deposit(buf, ck_of(0), bias, tid, false);
      __syncthreads();
#pragma unroll
      for (int s = 0; s < kSeg; ++s) {
        const float4 r = reinterpret_cast<const float4*>(buf + Sm::rec)
            [s * kBwdChannels + c];
        float bq[SPL];
        lds(buf + Sm::bc + 2 * s * NP + n0, bq);
#pragma unroll
        for (int i = 0; i < SPL; ++i)
          h[i] = fmaf(ex2_approx(r.x * a2[i]), h[i], r.y * bq[i]);
      }
    }
    __syncthreads();
  }

  float lam[SPL], da[SPL];
#pragma unroll
  for (int i = 0; i < SPL; ++i) {
    lam[i] = (on && n0 + i < N && p.dh_last)
                 ? p.dh_last[(b * di + d) * N + n0 + i] : 0.f;
    da[i] = 0.f;
  }
  // dD and d dt_bias of channel df over this thread's items
  float dd = 0.f, dbias = 0.f;

  // the recompute of segment k and the adjoint back through it, all kSeg
  // steps straight (see the deposit), so the compiler can overlap them
  const auto steps = [&](int k) {
    float* buf = buf_of(k);
    const float4* rec = reinterpret_cast<const float4*>(buf + Sm::rec);
    float h[SPL], ab[kSeg][SPL];
    lds(ck_of(k), h);
#pragma unroll
    for (int s = 0; s < kSeg; ++s) {
      // step s forward: its decays kept, the state before it stored; y
      const float4 r = rec[s * kBwdChannels + c];
      float bq[SPL], cq[SPL];
      lds(buf + Sm::bc + 2 * s * NP + n0, bq);
      lds(buf + Sm::bc + (2 * s + 1) * NP + n0, cq);
      sts(hs + s * kBwdChannels * NP, h);
      float y = 0.f;
#pragma unroll
      for (int i = 0; i < SPL; ++i) {
        ab[s][i] = ex2_approx(r.x * a2[i]);
        h[i] = fmaf(ab[s][i], h[i], r.y * bq[i]);
        y = fmaf(h[i], cq[i], y);
      }
      y = lanes_sum(y);
      if (l == 0) buf[Sm::y + s * kBwdChannels + c] = y;
    }
    // the adjoint back through the steps; h: the state after step s
#pragma unroll
    for (int s = kSeg - 1; s >= 0; --s) {
      const int e = s * kBwdChannels + c;
      const float4 r = rec[e];   // dt, u, dy', x
      float bq[SPL], cq[SPL], hp[SPL], vals[V];
      lds(buf + Sm::bc + 2 * s * NP + n0, bq);
      lds(buf + Sm::bc + (2 * s + 1) * NP + n0, cq);
      lds(hs + s * kBwdChannels * NP, hp);
      float du = 0.f, ga = 0.f;
#pragma unroll
      for (int i = 0; i < SPL; ++i) {
        const float lv = fmaf(cq[i], r.z, lam[i]);
        vals[i] = lv * r.y;            // dB
        vals[SPL + i] = h[i] * r.z;    // dC
        h[i] = hp[i];
        du = fmaf(lv, bq[i], du);
        const float abar = ab[s][i];
        lam[i] = abar * lv;
        const float gv = lam[i] * hp[i];
        da[i] = fmaf(gv, r.x, da[i]);
        ga = fmaf(gv, a2[i], ga);
      }
#pragma unroll
      for (int i = 2 * SPL; i < V; ++i) vals[i] = 0.f;
      // du to lanes 0 and 2, sum_n g A to lanes 1 and 3: over the
      // channel's lanes, one shuffle each step
      const float keep = l & 1 ? ga : du, send = l & 1 ? du : ga;
      float v2 = keep + __shfl_xor_sync(0xffffffffu, send, 1);
      v2 += __shfl_xor_sync(0xffffffffu, v2, 2);
      if (l < 2) buf[(l ? Sm::ga : Sm::du) + e] = v2;
      reduce_channels<V>(vals, lane);
      float* out = buf + Sm::red +
                   ((s * kBwdWarps + warp) * kLanes + l) * V +
                   ((lane >> 2) & 7) * VO;
#pragma unroll
      for (int q = 0; q < VO; ++q) out[q] = vals[q];
    }
  };

  // what segment k's steps left per (t, d) and per block, finished by
  // every thread: dz, dx, d dt_lin, the dD and d dt_bias sums, and the
  // block's dB | dC partials (its warps' sums, in warp order)
  const auto finish = [&](int k) {
    const float* buf = buf_of(k);
    const float4* rec = reinterpret_cast<const float4*>(buf + Sm::rec);
    const int t0 = k * kSeg, tk = steps_of(k);
    // both items formed first, then stored where they exist
    float dz[kItems], dx[kItems], dtl[kItems];
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int e = tid + j * kBwdThreads;
      const float4 r = rec[e];
      const float y = fmaf(dski, r.w, buf[Sm::y + e]);
      const float ds = round_to<T>(buf[Sm::dy + e] * round_to<T>(y));
      const float du = buf[Sm::du + e];
      dtl[j] = fmaf(du, r.w, buf[Sm::ga + e] * kLn2) * buf[Sm::sig + e];
      dz[j] = ds * buf[Sm::sz + e] * buf[Sm::wz + e];
      dx[j] = fmaf(du, r.x, r.z * dski);
      dd = fmaf(r.z, r.w, dd);   // 0 past the segment's end: dy' = x = 0
    }
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int s = (tid + j * kBwdThreads) / kBwdChannels;
      if (s < tk && df < di) {
        const long long row = (b * S + t0 + s) * di + df;
        static_cast<T*>(p.dz)[row] = from_f32<T>(dz[j]);
        static_cast<T*>(p.dx)[row] = from_f32<T>(dx[j]);
        p.ddt_lin[row] = dtl[j];
        dbias += dtl[j];
      }
    }
    for (int e = tid; e < tk * 2 * N; e += kBwdThreads) {
      const int s = e / (2 * N), j = e % (2 * N);
      const int n = j < N ? j : j - N;
      const int idx = (j < N ? 0 : SPL) + n % SPL;
      float v = 0.f;
#pragma unroll
      for (int w = 0; w < kBwdWarps; ++w)
        v += buf[Sm::red + ((s * kBwdWarps + w) * kLanes + n / SPL) * V + idx];
      p.part_bc[((b * S + t0 + s) * p.groups + g) * 2 * N + j] = v;
    }
  };

  // the segments last first, one barrier each: after it, the loads of
  // segment k-2 go out, segment k+1 is finished and segment k-1 (loaded a
  // segment ago) deposited into the buffer segment k+1 frees, together,
  // then segment k's steps run (the last pass, k = -1, only finishes
  // segment 0)
  Raw<T, NP> rw;
  if (nseg > 0) {
    rw.fetch(p, b, c0, nseg - 1, tid, true);
    rw.deposit(buf_of(nseg - 1), ck_of(nseg - 1), bias, tid, true);
  }
  if (nseg > 1) rw.fetch(p, b, c0, nseg - 2, tid, true);
  for (int k = nseg - 1; k >= -1; --k) {
    __syncthreads();
    Raw<T, NP> ahead;
    if (k > 1) ahead.fetch(p, b, c0, k - 2, tid, true);
    if (k + 1 < nseg) finish(k + 1);
    if (k > 0) rw.deposit(buf_of(k - 1), ck_of(k - 1), bias, tid, true);
    if (k >= 0) steps(k);
    rw = ahead;
  }

  // dA rows and dh0 per lane; dD and d dt_bias: the four threads of a
  // channel (tid / 64) summed in their order
  if (on) {
#pragma unroll
    for (int i = 0; i < SPL; ++i) {
      const int n = n0 + i;
      if (n < N) {
        p.part_d[(b * (N + 2) + n) * di + d] = da[i];
        if (p.dh0) p.dh0[(b * di + d) * N + n] = lam[i];
      }
    }
  }
  float* sums = smem + Sm::buf0;   // every buffer is free after the barrier
  __syncthreads();
  sums[tid] = dd;
  sums[kBwdThreads + tid] = dbias;
  __syncthreads();
  if (tid < kBwdChannels && df < di) {
    float vd = 0.f, vb = 0.f;
#pragma unroll
    for (int q = 0; q < kBwdThreads / kBwdChannels; ++q) {
      vd += sums[q * kBwdChannels + tid];
      vb += sums[kBwdThreads + q * kBwdChannels + tid];
    }
    p.part_d[(b * (N + 2) + N) * di + df] = vd;
    p.part_d[(b * (N + 2) + N + 1) * di + df] = vb;
  }
}

// The partials summed in a fixed order: dB, dC (batch, S, N) over the
// channel blocks; dA (di, N), dD and d dt_bias (di,) over the batch rows.
__global__ void __launch_bounds__(256)
mamba_scan_bwd_reduce_kernel(const float* __restrict__ part_bc,
                             const float* __restrict__ part_d,
                             float* __restrict__ db, float* __restrict__ dc,
                             float* __restrict__ da, float* __restrict__ dd,
                             float* __restrict__ dbias, int batch, int S,
                             int di, int N, int groups) {
  const long long n_bc = (long long)batch * S * 2 * N;
  const long long n_d = (long long)di * (N + 2);
  for (long long i = blockIdx.x * 256ll + threadIdx.x; i < n_bc + n_d;
       i += (long long)gridDim.x * 256) {
    if (i < n_bc) {
      const long long row = i / (2 * N);
      const int j = (int)(i % (2 * N));
      float v = 0.f;
      for (int g = 0; g < groups; ++g)
        v += part_bc[(row * groups + g) * 2 * N + j];
      if (j < N) db[row * N + j] = v;
      else dc[row * N + j - N] = v;
    } else {
      const long long e = i - n_bc;
      const int j = (int)(e / di), d = (int)(e % di);
      float v = 0.f;
      for (int bb = 0; bb < batch; ++bb)
        v += part_d[((long long)bb * (N + 2) + j) * di + d];
      if (j < N) da[(long long)d * N + j] = v;
      else if (j == N) dd[d] = v;
      else dbias[d] = v;
    }
  }
}

template <typename T, int NP, bool Walk>
static int launch_bwd(const BwdArgs& p, int batch, cudaStream_t stream) {
  using Sm = BwdSmem<NP>;
  static const cudaError_t attr = [] {
    cudaError_t e = cudaFuncSetAttribute(
        mamba_scan_bwd_kernel<T, NP, Walk>,
        cudaFuncAttributePreferredSharedMemoryCarveout,
        cudaSharedmemCarveoutMaxShared);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(mamba_scan_bwd_kernel<T, NP, Walk>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               Sm::bytes);
    return e;
  }();
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid(p.groups, batch);
  mamba_scan_bwd_kernel<T, NP, Walk>
      <<<grid, kBwdThreads, Sm::bytes, stream>>>(p);
  RT_RETURN_IF_ERROR();
  return 0;
}

template <typename T, bool Walk>
static int mamba_scan_bwd(const void* xc, const void* dt_lin,
                          const void* dt_bias, const void* bm, const void* cm,
                          long long bc_sb, long long bc_ss, const void* a,
                          const void* dskip, const void* z, const void* h0,
                          const void* dy, const void* dh_last, void* dx,
                          void* ddt_lin, void* dz, void* dh0, void* part_bc,
                          void* ckpt, void* part_d, int batch, int S, int di,
                          int N, void* stream) {
  if (batch < 1 || batch > 65535 || S < 0 || di < 1 || N < 1 ||
      N > kBwdMaxState)
    return (int)cudaErrorInvalidValue;
  const int groups = (di + kBwdChannels - 1) / kBwdChannels;
  BwdArgs p{xc, static_cast<const float*>(dt_lin),
            static_cast<const float*>(dt_bias), bm, cm, bc_sb, bc_ss,
            static_cast<const float*>(a), static_cast<const float*>(dskip),
            z, static_cast<const float*>(h0), dy,
            static_cast<const float*>(dh_last), dx,
            static_cast<float*>(ddt_lin), dz, static_cast<float*>(dh0),
            static_cast<float*>(part_bc), static_cast<float*>(ckpt),
            static_cast<float*>(part_d), S, di, N, groups};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto go = N <= 4 ? launch_bwd<T, 4, Walk> : N <= 8 ? launch_bwd<T, 8, Walk>
          : N <= 16 ? launch_bwd<T, 16, Walk> : launch_bwd<T, 32, Walk>;
  return go(p, batch, st);
}

#define RT_MAMBA_SCAN_BWD(name, T, walk)                                     \
  int name(const void* xc, const void* dt_lin, const void* dt_bias,         \
           const void* bm, const void* cm, long long bc_sb, long long bc_ss, \
           const void* a, const void* dskip, const void* z, const void* h0,  \
           const void* dy, const void* dh_last, void* dx, void* ddt_lin,     \
           void* dz, void* dh0, void* part_bc, void* ckpt, void* part_d,     \
           int batch, int S, int di, int N, void* stream) {                  \
    return mamba_scan_bwd<T, walk>(xc, dt_lin, dt_bias, bm, cm, bc_sb,       \
                                   bc_ss, a, dskip, z, h0, dy, dh_last, dx,  \
                                   ddt_lin, dz, dh0, part_bc, ckpt, part_d,  \
                                   batch, S, di, N, stream);                 \
  }

extern "C" {
// xc, z, dy, dx, dz: (batch, S, di) in the activation type, contiguous;
// dt_lin, ddt_lin: (batch, S, di) float32, contiguous; bm, cm: (batch, S,
// N) in the activation type, element (b, t, n) at b * bc_sb + t * bc_ss + n;
// dt_bias, dskip: (di,), a: (di, N), h0, dh_last, dh0 (each or null):
// (batch, di, N), float32, contiguous; part_bc: (batch, S, ceil(di/64),
// 2N), part_d: (batch, N + 2, di), float32 scratch; ckpt: (batch,
// ceil(S/8), di, N) float32, the states at the segment starts: scratch the
// walk writes (rt_mamba_scan_bwd_*), or the forward's `states`
// (rt_mamba_scan_bwd_ckpt_*).
RT_MAMBA_SCAN_BWD(rt_mamba_scan_bwd_f32, float, true)
RT_MAMBA_SCAN_BWD(rt_mamba_scan_bwd_bf16, __nv_bfloat16, true)
RT_MAMBA_SCAN_BWD(rt_mamba_scan_bwd_ckpt_f32, float, false)
RT_MAMBA_SCAN_BWD(rt_mamba_scan_bwd_ckpt_bf16, __nv_bfloat16, false)

// part_bc, part_d as above; db, dc: (batch, S, N), da: (di, N), dd, dbias:
// (di,), float32, contiguous.
int rt_mamba_scan_bwd_reduce(const void* part_bc, const void* part_d,
                             void* db, void* dc, void* da, void* dd,
                             void* dbias, int batch, int S, int di, int N,
                             int groups, void* stream) {
  const long long total = (long long)batch * S * 2 * N + (long long)di * (N + 2);
  if (total == 0) return 0;
  const long long blocks = (total + 255) / 256;
  const int grid = (int)(blocks < 65535 * 8 ? blocks : 65535 * 8);
  mamba_scan_bwd_reduce_kernel<<<grid, 256, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(part_bc), static_cast<const float*>(part_d),
      static_cast<float*>(db), static_cast<float*>(dc),
      static_cast<float*>(da), static_cast<float*>(dd),
      static_cast<float*>(dbias), batch, S, di, N, groups);
  RT_RETURN_IF_ERROR();
  return 0;
}
}
