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
// The design, simple first:
// - Four lanes per (batch row, channel), each with a quarter of the N
//   states in its registers; a block owns 64 channels of one batch row
//   (256 threads), so carried values never leave the block's loop and no
//   order between blocks is assumed.  The sums over n (y, du, d dt) are a
//   lane's own, then two shuffles within the channel's four lanes.  With
//   64 registers a lane, four blocks (32 warps) share an SM; one lane a
//   channel, all N states in it, ran eight warps an SM and was slower
//   (PERF.md §6).
// - Recompute, don't store.  The forward kept nothing per (t, d, n).  The
//   block walks time forward from h0 once, writing the state at the start
//   of every 8-step segment to a scratch tensor the wrapper allocates
//   ((batch, S/8, di, N) float32).  Then it takes the segments last first:
//   recomputes the segment's states into shared memory (with the gate's
//   backward of each step) and runs the adjoint back through them.  So each
//   exp(dt A) is formed three times (the walk, the recompute, the
//   adjoint).  A segment's x, dt_lin, z and dy are loaded by the whole
//   block, coalesced, before its first step, with dt, u = dt x and the
//   softplus derivative formed once per (t, d).  Shared memory bounds the
//   segment: 8 states of N floats a channel let four blocks share an SM.
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
// 16 a clock an SM, ~0.32 ms with the per-(t, d) ones).  This design forms
// each decay three times and moves the segment states' scratch besides
// (~0.54 GB written and read).

#include <cstdint>

#include "mixer.cuh"

constexpr int kBwdChannels = 64;  // channels per block
constexpr int kLanes = 4;         // lanes per channel
constexpr int kBwdThreads = kBwdChannels * kLanes;
constexpr int kBwdWarps = kBwdThreads / 32;
constexpr int kSeg = 8;           // time steps per segment
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

// A lane's states and values, and one block's shared memory in floats: the
// segment's states (slot s the state before its step s; [s][c][n]), B and
// C rows ([s][B | C], NP each, zero-padded), x, dt, u, the softplus
// derivative, z (then dy') and dy per step and channel, and the warps'
// dB | dC sums.
template <int NP>
struct BwdSmem {
  static constexpr int SPL = NP / kLanes;            // states a lane
  static constexpr int V = 2 * SPL > 8 ? 2 * SPL : 8;  // dB | dC a lane, padded
  static constexpr int VO = V / 8;                   // after the scatter
  static constexpr int sh = 0;
  static constexpr int sbc = sh + kSeg * kBwdChannels * NP;
  static constexpr int sx = sbc + kSeg * 2 * NP;
  static constexpr int sdt = sx + kSeg * kBwdChannels;
  static constexpr int su = sdt + kSeg * kBwdChannels;
  static constexpr int ssig = su + kSeg * kBwdChannels;
  static constexpr int sz = ssig + kSeg * kBwdChannels;
  static constexpr int sdy = sz + kSeg * kBwdChannels;
  static constexpr int sred = sdy + kSeg * kBwdChannels;
  static constexpr int floats = sred + kSeg * kBwdWarps * kLanes * V;
  static constexpr int bytes = floats * 4;
  static_assert(SPL >= 1 && NP % kLanes == 0, "N padded to whole lanes");
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

template <typename T, int NP>
__global__ void __launch_bounds__(kBwdThreads, NP <= 16 ? 4 : 2)
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
  float* sh = smem + Sm::sh;
  float* sbc = smem + Sm::sbc;
  float* sx = smem + Sm::sx;
  float* sdt = smem + Sm::sdt;
  float* su = smem + Sm::su;
  float* ssig = smem + Sm::ssig;
  float* sz = smem + Sm::sz;
  float* sdy = smem + Sm::sdy;
  float* sred = smem + Sm::sred;

  float a2[SPL], h[SPL];
#pragma unroll
  for (int i = 0; i < SPL; ++i) {
    const int n = n0 + i;
    const bool live = on && n < N;
    a2[i] = live ? p.a[(long long)d * N + n] * kLog2e : 0.f;
    h[i] = (live && p.h0) ? p.h0[(b * di + d) * N + n] : 0.f;
  }
  const float dsk = on ? p.dskip[d] : 0.f;

  // segment k into shared memory: B (and C) rows zero-padded to NP; per
  // (step, channel) x, dt = softplus(dt_lin + bias), u = dt x, the
  // softplus derivative (and z, dy), each formed once, loads coalesced
  // and all in flight before the first is used
  constexpr int kItems = kSeg * kBwdChannels / kBwdThreads;
  const auto stage = [&](int k, bool grad) {
    const int t0 = k * kSeg, tk = min(kSeg, S - t0);
    for (int e = tid; e < kSeg * 2 * NP; e += kBwdThreads) {
      const int s = e / (2 * NP), m = (e / NP) % 2, n = e % NP;
      float v = 0.f;
      if (s < tk && n < N && (m == 0 || grad))
        v = to_f32(static_cast<const T*>(m ? p.cm : p.bm)
                       [b * p.bc_sb + (long long)(t0 + s) * p.bc_ss + n]);
      sbc[e] = v;
    }
    float rx[kItems], rd[kItems], rz[kItems], ry[kItems], rb[kItems];
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int e = tid + j * kBwdThreads, s = e / kBwdChannels,
                cc = e % kBwdChannels;
      rx[j] = rd[j] = rz[j] = ry[j] = rb[j] = 0.f;
      if (c0 + cc < di) {
        rb[j] = p.dt_bias[c0 + cc];
        if (s < tk) {
          const long long row = (b * S + t0 + s) * di + c0 + cc;
          rx[j] = to_f32(static_cast<const T*>(p.x)[row]);
          rd[j] = p.dt_lin[row];
          if (grad) {
            rz[j] = to_f32(static_cast<const T*>(p.z)[row]);
            ry[j] = to_f32(static_cast<const T*>(p.dy)[row]);
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int e = tid + j * kBwdThreads;
      const float v = rb[j] + rd[j];
      const float dt = softplus_fast(v);
      sx[e] = rx[j];
      sdt[e] = dt;
      su[e] = dt * rx[j];
      if (grad) {
        ssig[e] = 1.f / (1.f + __expf(-v));
        sz[e] = rz[j];
        sdy[e] = ry[j];
      }
    }
  };
  // this lane's SPL values of row r of sbc (B: r = 2 s, C: r = 2 s + 1)
  const auto row_of = [&](int r, float (&out)[SPL]) {
#pragma unroll
    for (int i = 0; i < SPL; ++i) out[i] = sbc[r * NP + n0 + i];
  };

  // 1. the walk forward from h0: the state at every segment's start
  for (int k = 0; k < nseg - 1; ++k) {
    if (on) {
#pragma unroll
      for (int i = 0; i < SPL; ++i)
        if (n0 + i < N)
          p.ckpt[((b * nseg + k) * di + d) * N + n0 + i] = h[i];
    }
    __syncthreads();
    stage(k, false);
    __syncthreads();
#pragma unroll
    for (int s = 0; s < kSeg; ++s) {
      const float dt = sdt[s * kBwdChannels + c];
      const float u = su[s * kBwdChannels + c];
      float bq[SPL];
      row_of(2 * s, bq);
#pragma unroll
      for (int i = 0; i < SPL; ++i)
        h[i] = fmaf(ex2_approx(dt * a2[i]), h[i], u * bq[i]);
    }
  }
  if (nseg > 0 && on) {
#pragma unroll
    for (int i = 0; i < SPL; ++i)
      if (n0 + i < N)
        p.ckpt[((b * nseg + nseg - 1) * di + d) * N + n0 + i] = h[i];
  }

  // 2. the segments last first: recompute, then the adjoint back through
  float lam[SPL], da[SPL], ht[SPL];
#pragma unroll
  for (int i = 0; i < SPL; ++i) {
    const int n = n0 + i;
    lam[i] = (on && n < N && p.dh_last) ? p.dh_last[(b * di + d) * N + n]
                                        : 0.f;
    da[i] = 0.f;
  }
  float dd = 0.f, dbias = 0.f;
  for (int k = nseg - 1; k >= 0; --k) {
    const int t0 = k * kSeg, tk = min(kSeg, S - t0);
    __syncthreads();   // the previous segment's shared memory is free
    stage(k, true);
#pragma unroll
    for (int i = 0; i < SPL; ++i)
      h[i] = (on && n0 + i < N)
                 ? p.ckpt[((b * nseg + k) * di + d) * N + n0 + i] : 0.f;
    __syncthreads();
    for (int s = 0; s < tk; ++s) {
      // step s forward, the state before it into shared memory; y, then
      // the gate's backward (dz written, dy' kept in place of z)
      const int e = s * kBwdChannels + c;
      const float dt = sdt[e], u = su[e];
      float bq[SPL], cq[SPL];
      row_of(2 * s, bq);
      row_of(2 * s + 1, cq);
      float y = 0.f;
#pragma unroll
      for (int i = 0; i < SPL; ++i) {
        sh[e * NP + n0 + i] = h[i];
        h[i] = fmaf(ex2_approx(dt * a2[i]), h[i], u * bq[i]);
        y = fmaf(h[i], cq[i], y);
      }
      y = fmaf(dsk, sx[e], lanes_sum(y));
      const float zv = sz[e], dyo = sdy[e];
      const float dyp = round_to<T>(dyo * round_to<T>(silu_fast(zv)));
      const float ds = round_to<T>(dyo * round_to<T>(y));
      const float szv = 1.f / (1.f + __expf(-zv));
      __syncwarp();
      if (l == 0) {
        sz[e] = dyp;
        if (on)
          static_cast<T*>(p.dz)[(b * S + t0 + s) * di + d] =
              from_f32<T>(ds * szv * (1.f + zv * (1.f - szv)));
      }
    }
    __syncwarp();
#pragma unroll
    for (int i = 0; i < SPL; ++i) ht[i] = h[i];
    for (int s = tk - 1; s >= 0; --s) {
      // the adjoint back through step s; ht: the state after step s
      const int e = s * kBwdChannels + c;
      const float x = sx[e], dt = sdt[e], u = su[e], sig = ssig[e];
      const float dyp = sz[e];
      float bq[SPL], cq[SPL], vals[V];
      row_of(2 * s, bq);
      row_of(2 * s + 1, cq);
      float du = 0.f, ddt = 0.f;
#pragma unroll
      for (int i = 0; i < SPL; ++i) {
        const float lv = fmaf(cq[i], dyp, lam[i]);
        const float hprev = sh[e * NP + n0 + i];
        vals[i] = lv * u;              // dB
        vals[SPL + i] = ht[i] * dyp;   // dC
        ht[i] = hprev;
        du = fmaf(lv, bq[i], du);
        const float abar = ex2_approx(dt * a2[i]);
        const float gv = lv * hprev * abar;
        da[i] = fmaf(gv, dt, da[i]);
        ddt = fmaf(gv, a2[i], ddt);
        lam[i] = abar * lv;
      }
#pragma unroll
      for (int i = 2 * SPL; i < V; ++i) vals[i] = 0.f;
      du = lanes_sum(du);
      ddt = fmaf(du, x, lanes_sum(ddt) * kLn2);
      const float dtl = ddt * sig;
      dbias += dtl;
      dd = fmaf(dyp, x, dd);
      if (on && l == 0) {
        const long long row = (b * S + t0 + s) * di + d;
        static_cast<T*>(p.dx)[row] = from_f32<T>(fmaf(du, dt, dyp * dsk));
        p.ddt_lin[row] = dtl;
      }
      reduce_channels<V>(vals, lane);
      float* out = sred + ((s * kBwdWarps + warp) * kLanes + l) * V +
                   ((lane >> 2) & 7) * VO;
#pragma unroll
      for (int r = 0; r < VO; ++r) out[r] = vals[r];
    }
    __syncthreads();
    // the block's dB | dC of the segment: its warps' sums, in warp order
    for (int e = tid; e < tk * 2 * N; e += kBwdThreads) {
      const int s = e / (2 * N), j = e % (2 * N);
      const int n = j < N ? j : j - N;
      const int idx = (j < N ? 0 : SPL) + n % SPL;
      float v = 0.f;
#pragma unroll
      for (int w = 0; w < kBwdWarps; ++w)
        v += sred[((s * kBwdWarps + w) * kLanes + n / SPL) * V + idx];
      p.part_bc[((b * S + t0 + s) * p.groups + g) * 2 * N + j] = v;
    }
  }
  if (on) {
#pragma unroll
    for (int i = 0; i < SPL; ++i) {
      const int n = n0 + i;
      if (n < N) {
        p.part_d[(b * (N + 2) + n) * di + d] = da[i];
        if (p.dh0) p.dh0[(b * di + d) * N + n] = lam[i];
      }
    }
    if (l == 0) {
      p.part_d[(b * (N + 2) + N) * di + d] = dd;
      p.part_d[(b * (N + 2) + N + 1) * di + d] = dbias;
    }
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

template <typename T, int NP>
static int launch_bwd(const BwdArgs& p, int batch, cudaStream_t stream) {
  using Sm = BwdSmem<NP>;
  static const cudaError_t attr = [] {
    return cudaFuncSetAttribute(mamba_scan_bwd_kernel<T, NP>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                Sm::bytes);
  }();
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid(p.groups, batch);
  mamba_scan_bwd_kernel<T, NP><<<grid, kBwdThreads, Sm::bytes, stream>>>(p);
  RT_RETURN_IF_ERROR();
  return 0;
}

template <typename T>
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
  auto go = N <= 4 ? launch_bwd<T, 4> : N <= 8 ? launch_bwd<T, 8>
          : N <= 16 ? launch_bwd<T, 16> : launch_bwd<T, 32>;
  return go(p, batch, st);
}

extern "C" {
// xc, z, dy, dx, dz: (batch, S, di) in the activation type, contiguous;
// dt_lin, ddt_lin: (batch, S, di) float32, contiguous; bm, cm: (batch, S,
// N) in the activation type, element (b, t, n) at b * bc_sb + t * bc_ss + n;
// dt_bias, dskip: (di,), a: (di, N), h0, dh_last, dh0 (each or null):
// (batch, di, N), float32, contiguous; part_bc: (batch, S, ceil(di/64),
// 2N), ckpt: (batch, ceil(S/8), di, N), part_d: (batch, N + 2, di),
// float32 scratch.
int rt_mamba_scan_bwd_f32(const void* xc, const void* dt_lin,
                          const void* dt_bias, const void* bm, const void* cm,
                          long long bc_sb, long long bc_ss, const void* a,
                          const void* dskip, const void* z, const void* h0,
                          const void* dy, const void* dh_last, void* dx,
                          void* ddt_lin, void* dz, void* dh0, void* part_bc,
                          void* ckpt, void* part_d, int batch, int S, int di,
                          int N, void* stream) {
  return mamba_scan_bwd<float>(xc, dt_lin, dt_bias, bm, cm, bc_sb, bc_ss, a,
                               dskip, z, h0, dy, dh_last, dx, ddt_lin, dz,
                               dh0, part_bc, ckpt, part_d, batch, S, di, N,
                               stream);
}
int rt_mamba_scan_bwd_bf16(const void* xc, const void* dt_lin,
                           const void* dt_bias, const void* bm,
                           const void* cm, long long bc_sb, long long bc_ss,
                           const void* a, const void* dskip, const void* z,
                           const void* h0, const void* dy,
                           const void* dh_last, void* dx, void* ddt_lin,
                           void* dz, void* dh0, void* part_bc, void* ckpt,
                           void* part_d, int batch, int S, int di, int N,
                           void* stream) {
  return mamba_scan_bwd<__nv_bfloat16>(xc, dt_lin, dt_bias, bm, cm, bc_sb,
                                       bc_ss, a, dskip, z, h0, dy, dh_last,
                                       dx, ddt_lin, dz, dh0, part_bc, ckpt,
                                       part_d, batch, S, di, N, stream);
}
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
