// Mamba-1 selective scan for Hopper: the scan alone (float32), and the
// mixer's passes from softplus to the gate folded around it.
//
// Replaces the Pallas kernel of src/repro/kernels/ssm_scan.py:83 (ssm_scan,
// body _kernel :29).  Per batch row b, channel d and state index n:
//
//   h_t = exp(dt_t * A[d, n]) * h_{t-1} + (dt_t * x_t) * B_t[n]
//   y_t = sum_n h_t[n] * C_t[n] + D[d] * x_t
//
// and the final state h_S.  Two entry points share one kernel template:
//   rt_ssm_scan_f32     the Pallas signature: float32 in and out, dt already
//                       through softplus, zero initial state;
//   rt_mamba_scan_*     what the JAX mixer computes from the scan to the gate
//                       (src/repro/models/blocks.py:360-379 and :391; with h0
//                       the SSM step of mamba_decode, :402-426): dt =
//                       softplus(dt_lin + dt_bias) in float32, the scan in
//                       float32 from h0, y rounded to the activation type T,
//                       times silu(z) rounded to T, the product rounded to T.
//                       B and C are read in place from the x_proj output
//                       (row strides given), x and z in T, dt_lin float32.
//                       With a non-null `states` it also writes the float32
//                       state at the start of every 8-step chunk, (batch,
//                       ceil(S/8), di, N): the segment checkpoints of the
//                       backward (ssm_scan_bwd.cu), which then skips its own
//                       walk.  The training path asks for them only in
//                       remat's recompute, right before the layer's
//                       backward; a null pointer compiles the kernel without
//                       the stores (the template's States = false).
//
// The TPU kernel keeps h in VMEM scratch across a grid axis over S that runs
// in order; CUDA blocks run in no order, so the carry lives in registers of
// one block's loop over all S steps.
//
// Bound on this card, at B=4, S=2048, d_inner=8192, N=16: the exponentials
// on the special-function units (MUFU, 16 a clock an SM).  The scan alone
// needs N per (t, d), 1.07e9, ~0.26 ms at the 1.98 GHz boost clock, just
// above its bytes (x, dt read, y written in float32: ~0.81 GB, ~0.24 ms).
// The mixer entry adds two per softplus and two per silu (an ex2 and a
// reciprocal each): N + 4 per (t, d), 1.34e9, ~0.32 ms, above its ~0.67 GB
// of bytes (x, z, y in bf16, dt_lin float32).
//
// The design:
// - Parallelism.  A lane carries 4 states (of N padded to NP, a power of
//   two >= 4, with A = 0 and B = C = 0 on the padding, so those states stay
//   0) of two neighbouring channels; L = NP/4 lanes share a channel pair.
//   One load of B and C (float4 each) then serves two channels, which halves
//   the shared-memory bytes a state takes; at one channel a lane, those
//   loads, not the exponentials, held the scan.  A block owns 128 channels
//   of one batch row (256 threads at N = 16): the serve prefill's 32,768
//   chains are 256 blocks, two an SM at up to 128 registers a thread.
// - Overlap.  The block walks S in chunks of 8 steps with one barrier a
//   chunk.  Raw x, dt, z, B and C of chunk k+2 are fetched into registers
//   (16 bytes a load) before chunk k's scan and stored to their slot of a
//   four-slot ring after it, so the loads' latency hides behind the scan.
//   Between the barrier and the scan of chunk k, each thread stores its
//   share of chunk k-1 and prepares its share of chunk k+1, on buffers the
//   scan does not touch (double-buffered), so no pass waits on another.
// - Work done once per (t, d), not per lane.  The prep forms dt (softplus
//   in the mixer entry) and dt * x once per (t, d), and B, C in float32 once
//   per (t, n); the store sums the L partial y, adds D x, and in the mixer
//   entry rounds y, forms silu(z), gates and writes y in T.  The scan lane
//   issues per state one FMUL (dt A log2 e), one MUFU.EX2, one FMUL
//   (dt x B), one FFMA (h) and one FFMA (y); its two partial y go to shared
//   memory (padded rows: no bank conflict on either side), not through
//   shuffles.
// - Exponentials.  A log2(e) lives in registers, so each decay is one
//   ex2.approx.ftz; softplus and silu are written for the FMA pipe
//   (softplus_fast, silu_fast).
// scripts/probe_ssm_scan.py times the kernel against variants of this
// source (without the exponentials, without the loads, the math library's
// softplus and silu, 64 or 256 channels a block, 16-step chunks) and splits
// a chunk's cycles by clock stamps.
//
// Rejected, with the reason:
// - Chunking S over blocks (a chunked scan): it needs the cumulative decays
//   exp(A * sum dt) at every (t, n) besides the per-step ones, which doubles
//   the exponentials that bound the kernel.
// - ex2.approx.f16x2 (two decays per MUFU op): a 10-bit decay in a
//   recurrence that carries its error over about 1/(1 - decay) steps.
// - Staging by cp.async or by the bulk copy engine (cp.async.bulk on an
//   mbarrier): both were slower on this card than the register-staged loads;
//   the copies' issue stalled behind the block's shared-memory traffic.
// - The prep and store as phases of their own between barriers: the blocks
//   of an SM moved in step through them while the MUFU idled.

#include <cstdint>
#include <type_traits>

#include "mixer.cuh"

constexpr int kScanChannels = 128;  // channels per block, two a lane
constexpr int kScanSteps = 8;       // time steps per chunk of the ring
constexpr int kMaxState = 32;
struct ScanArgs {
  const void* x;         // (batch, S, di) T
  const float* dt;       // (batch, S, di): dt (scan) or dt_lin (mixer)
  const float* dt_bias;  // (di,), mixer only
  const void* bm;        // B: row (b, t) at b * bc_sb + t * bc_ss elements
  const void* cm;        // C: the same strides
  long long bc_sb, bc_ss;
  const float* a;        // (di, N), negative
  const float* dskip;    // (di,)
  const void* z;         // (batch, S, di) T, mixer only
  const float* h0;       // (batch, di, N) or null (zero state)
  void* y;               // (batch, S, di) T
  float* h_last;         // (batch, di, N)
  float* states;         // (batch, ceil(S/8), di, N) or null, mixer only
  int S, di, N;
  int vec;       // x, dt, z, y 16-byte aligned and di % 8 == 0
  int bc_words;  // B/C rows 4-byte aligned and N * sizeof(T) % 4 == 0
};


// Shared memory of one block, in bytes: a ring of four slots of raw inputs
// (chunk k-1 for its store, k for its scan, k+1 for its prep, k+2 from
// its registers; B and C as rows [t][B | C], each NP wide), then two
// buffers each (chunks k and k+1, or k-1 and k) of dt and dt*x, of B and C
// in float32 (bf16 only; float32 rows are read in the ring), and of the
// partial y.
template <typename T, bool Mixer, int NP>
struct ScanSmem {
  static constexpr int L = NP / 4;                  // lanes per channel pair
  static constexpr int kThreads = kScanChannels / 2 * L;
  static constexpr int kYpLd = kScanChannels + 8;   // padded partial-y row
  static constexpr bool kBcInRing = std::is_same<T, float>::value;
  static constexpr int x_off = 0;
  static constexpr int dt_off = x_off + kScanSteps * kScanChannels * sizeof(T);
  static constexpr int z_off = dt_off + kScanSteps * kScanChannels * 4;
  static constexpr int bc_off =
      z_off + (Mixer ? kScanSteps * kScanChannels * sizeof(T) : 0);
  static constexpr int slot = bc_off + 2 * kScanSteps * NP * sizeof(T);
  static constexpr int rec = kScanSteps * kScanChannels;       // float2s
  static constexpr int bcf = kBcInRing ? 0 : 2 * kScanSteps * NP;  // floats
  static constexpr int yp = kScanSteps * L * kYpLd;             // floats
  static constexpr int kBlocksPerSm = 512 / kThreads > 0 ? 512 / kThreads : 1;
  static constexpr int kRing = 4;
  static constexpr int rec_off = kRing * slot;
  static constexpr int bcf_off = rec_off + 2 * rec * 8;
  static constexpr int yp_off = bcf_off + 2 * bcf * 4;
  static constexpr int bytes = yp_off + 2 * yp * 4;
  static_assert(slot % 16 == 0 && bcf_off % 16 == 0 && yp_off % 16 == 0,
                "16-byte aligned regions");
};

// One chunk [t0, t0 + Tk) of batch row b, channels [c0, c0 + 128), raw.
// When p.vec, a thread fetches its share into registers, 16 bytes a load
// (B and C rows 4 bytes a load when p.bc_words), before the scan of the
// chunk two ahead and stores it to the chunk's slot after that scan, so
// the loads' latency hides behind the scan; otherwise the chunk is copied
// element by element at the fetch.
template <typename T, bool Mixer, int NP>
struct Staged {
  using Sm = ScanSmem<T, Mixer, NP>;
  static constexpr int NT = Sm::kThreads, es = sizeof(T);
  static constexpr int EX = 16 / es, PX = kScanChannels / EX;
  static constexpr int PD = kScanChannels / 4, W = NP * es / 4;
  static constexpr int IX = (kScanSteps * PX + NT - 1) / NT;
  static constexpr int ID = (kScanSteps * PD + NT - 1) / NT;
  static constexpr int IB = (2 * kScanSteps * W + NT - 1) / NT;
  uint4 x[IX], z[Mixer ? IX : 1], dt[ID];
  unsigned bc[IB];

  __device__ __forceinline__ void fetch(const ScanArgs& p, unsigned char* slot,
                                        long long b, int c0, int t0, int Tk,
                                        int tid) {
    const long long row0 = b * p.S + t0;
    const long long rb = b * p.bc_sb + (long long)t0 * p.bc_ss;
    if (p.vec) {
#pragma unroll
      for (int i = 0; i < IX; ++i) {
        const int e = tid + i * NT, t = e / PX, c = (e % PX) * EX;
        if (t < Tk && c0 + c < p.di) {
          const long long off = (row0 + t) * p.di + c0 + c;
          x[i] = __ldg(reinterpret_cast<const uint4*>(
              static_cast<const T*>(p.x) + off));
          if constexpr (Mixer)
            z[i] = __ldg(reinterpret_cast<const uint4*>(
                static_cast<const T*>(p.z) + off));
        }
      }
#pragma unroll
      for (int i = 0; i < ID; ++i) {
        const int e = tid + i * NT, t = e / PD, c = (e % PD) * 4;
        if (t < Tk && c0 + c < p.di)
          dt[i] = __ldg(reinterpret_cast<const uint4*>(
              p.dt + (row0 + t) * p.di + c0 + c));
      }
    } else {
      T* sx = reinterpret_cast<T*>(slot + Sm::x_off);
      float* sdt = reinterpret_cast<float*>(slot + Sm::dt_off);
      T* sz = reinterpret_cast<T*>(slot + Sm::z_off);
      for (int e = tid; e < Tk * kScanChannels; e += NT) {
        const int t = e / kScanChannels, c = e % kScanChannels;
        if (c0 + c < p.di) {
          const long long off = (row0 + t) * p.di + c0 + c;
          sx[e] = static_cast<const T*>(p.x)[off];
          sdt[e] = p.dt[off];
          if constexpr (Mixer) sz[e] = static_cast<const T*>(p.z)[off];
        }
      }
    }
    if (p.bc_words) {
      const int nw = p.N * es / 4;
#pragma unroll
      for (int i = 0; i < IB; ++i) {
        const int e = tid + i * NT, t = e / (2 * W), m = (e / W) % 2,
                  q = e % W;
        if (e < 2 * kScanSteps * W && t < Tk && q < nw)
          bc[i] = __ldg(reinterpret_cast<const unsigned*>(
              static_cast<const unsigned char*>(m ? p.cm : p.bm) +
              (rb + t * p.bc_ss) * es + q * 4));
      }
    } else {
      T* sbc = reinterpret_cast<T*>(slot + Sm::bc_off);
      for (int e = tid; e < 2 * kScanSteps * NP; e += NT) {
        const int t = e / (2 * NP), m = (e / NP) % 2, n = e % NP;
        if (t < Tk && n < p.N)
          sbc[e] =
              static_cast<const T*>(m ? p.cm : p.bm)[rb + t * p.bc_ss + n];
      }
    }
  }

  __device__ __forceinline__ void deposit(const ScanArgs& p,
                                          unsigned char* slot, int c0, int Tk,
                                          int tid) const {
    if (p.vec) {
#pragma unroll
      for (int i = 0; i < IX; ++i) {
        const int e = tid + i * NT, t = e / PX, c = (e % PX) * EX;
        if (t < Tk && c0 + c < p.di) {
          *reinterpret_cast<uint4*>(slot + Sm::x_off +
                                    (t * kScanChannels + c) * es) = x[i];
          if constexpr (Mixer)
            *reinterpret_cast<uint4*>(slot + Sm::z_off +
                                      (t * kScanChannels + c) * es) = z[i];
        }
      }
#pragma unroll
      for (int i = 0; i < ID; ++i) {
        const int e = tid + i * NT, t = e / PD, c = (e % PD) * 4;
        if (t < Tk && c0 + c < p.di)
          *reinterpret_cast<uint4*>(slot + Sm::dt_off +
                                    (t * kScanChannels + c) * 4) = dt[i];
      }
    }
    if (p.bc_words) {
      const int nw = p.N * es / 4;
#pragma unroll
      for (int i = 0; i < IB; ++i) {
        const int e = tid + i * NT, t = e / (2 * W), q = e % W;
        if (e < 2 * kScanSteps * W && t < Tk && q < nw)
          reinterpret_cast<unsigned*>(slot + Sm::bc_off)[e] = bc[i];
      }
    }
  }
};

template <typename T, bool Mixer, int NP, bool States>
__global__ void __launch_bounds__(ScanSmem<T, Mixer, NP>::kThreads,
                                  ScanSmem<T, Mixer, NP>::kBlocksPerSm)
ssm_scan_kernel(const ScanArgs p) {
  using Sm = ScanSmem<T, Mixer, NP>;
  constexpr int L = Sm::L, NT = Sm::kThreads;
  // prep and store items of a thread a chunk: (t, c) = divmod(tid + i NT,
  // kScanChannels); kCpt channels a thread (one when NT >= kScanChannels)
  constexpr int kItems = kScanSteps * kScanChannels / NT;
  constexpr int kCpt = NT >= kScanChannels ? 1 : kScanChannels / NT;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const int c0 = blockIdx.x * kScanChannels;
  const long long b = blockIdx.y;
  const int S = p.S, di = p.di, N = p.N;

  // the scan: channels 2 pi and 2 pi + 1, states 4 l .. 4 l + 3 of each
  const int pi = tid / L, l = tid % L;
  float a2[2][4], h[2][4];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int d = c0 + 2 * pi + j;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int n = 4 * l + k;
      const bool on = d < di && n < N;
      a2[j][k] = on ? p.a[(long long)d * N + n] * kLog2e : 0.f;
      h[j][k] = (on && p.h0) ? p.h0[(b * di + d) * N + n] : 0.f;
    }
  }
  // prep and store: channels (tid + i NT) % kScanChannels
  float bias[kCpt], dsk[kCpt];
#pragma unroll
  for (int i = 0; i < kCpt; ++i) {
    const int d = c0 + (tid + i * NT) % kScanChannels;
    bias[i] = (Mixer && d < di) ? p.dt_bias[d] : 0.f;
    dsk[i] = d < di ? p.dskip[d] : 0.f;
  }

  if constexpr (Sm::kBcInRing) {
    // float32 B and C rows are read in the ring: zero their padding once
    for (int e = tid; e < Sm::kRing * 2 * kScanSteps * NP; e += NT) {
      const int s = e / (2 * kScanSteps * NP), r = e % (2 * kScanSteps * NP);
      if (r % NP >= N)
        reinterpret_cast<float*>(smem + s * Sm::slot + Sm::bc_off)[r] = 0.f;
    }
  }

  const int n_chunks = (S + kScanSteps - 1) / kScanSteps;
  const auto slot_of = [&](int k) {
    return smem + (k % Sm::kRing) * Sm::slot;
  };
  const auto steps_of = [&](int k) {
    return min(kScanSteps, S - k * kScanSteps);
  };
  const auto rec_of = [&](int k) {
    return reinterpret_cast<float2*>(smem + Sm::rec_off) + (k & 1) * Sm::rec;
  };
  const auto bcf_of = [&](int k) {
    return reinterpret_cast<float*>(smem + Sm::bcf_off) + (k & 1) * Sm::bcf;
  };
  const auto yp_of = [&](int k) {
    return reinterpret_cast<float*>(smem + Sm::yp_off) + (k & 1) * Sm::yp;
  };
  // prep item i of chunk k: dt (softplus in the mixer entry) and dt * x
  const auto prep = [&](int k, int i) {
    const int e = tid + i * NT, t = e / kScanChannels, c = e % kScanChannels;
    if (t >= steps_of(k)) return;
    const unsigned char* slot = slot_of(k);
    float dtv = 0.f, dxv = 0.f;
    if (c0 + c < di) {
      const float v = reinterpret_cast<const float*>(slot + Sm::dt_off)[e];
      dtv = Mixer ? softplus_fast(v + bias[i % kCpt]) : v;
      dxv = dtv * to_f32(reinterpret_cast<const T*>(slot + Sm::x_off)[e]);
    }
    rec_of(k)[e] = make_float2(dtv, dxv);
  };
  // B and C of chunk k in float32, zero-padded to NP: item j of two
  const auto prep_bc = [&](int k, int j) {
    if constexpr (!Sm::kBcInRing) {
      const int e = tid + j * NT, t = e / (2 * NP), n = e % NP;
      if (t < steps_of(k))
        bcf_of(k)[e] = n < N ? to_f32(reinterpret_cast<const T*>(
                                   slot_of(k) + Sm::bc_off)[e])
                             : 0.f;
    }
  };
  // store item i of chunk k: y = the L partials + D x; in the mixer entry y
  // rounded to T, gated by silu(z) rounded to T, the product rounded to T
  const auto store = [&](int k, int i) {
    const int e = tid + i * NT, t = e / kScanChannels, c = e % kScanChannels;
    if (t >= steps_of(k) || c0 + c >= di) return;
    const unsigned char* slot = slot_of(k);
    const float* yp = yp_of(k);
    float v = yp[t * L * Sm::kYpLd + c];
#pragma unroll
    for (int q = 1; q < L; ++q) v += yp[(t * L + q) * Sm::kYpLd + c];
    const T* sx = reinterpret_cast<const T*>(slot + Sm::x_off);
    const T* sz = reinterpret_cast<const T*>(slot + Sm::z_off);
    v += dsk[i % kCpt] * to_f32(sx[e]);
    if constexpr (Mixer)
      v = round_to<T>(v) * round_to<T>(silu_fast(to_f32(sz[e])));
    static_cast<T*>(p.y)[(b * S + k * kScanSteps + t) * di + c0 + c] =
        from_f32<T>(v);
  };

  // chunks 0 and 1 into their slots, then chunk 0 prepared
  for (int k = 0; k < 2 && k < n_chunks; ++k) {
    Staged<T, Mixer, NP> st;
    st.fetch(p, slot_of(k), b, c0, k * kScanSteps, steps_of(k), tid);
    st.deposit(p, slot_of(k), c0, steps_of(k), tid);
  }
  __syncthreads();
  if (n_chunks > 0) {
#pragma unroll
    for (int i = 0; i < kItems; ++i) prep(0, i);
    prep_bc(0, 0);
    prep_bc(0, 1);
  }

  for (int k = 0; k < n_chunks; ++k) {
    // chunk k+1 is in its slot and chunk k is prepared; chunk k-1's scan
    // and chunk k-2's store are done, so chunk k-2's slot takes chunk k+2
    __syncthreads();
    Staged<T, Mixer, NP> ahead;
    if (k + 2 < n_chunks)
      ahead.fetch(p, slot_of(k + 2), b, c0, (k + 2) * kScanSteps,
                  steps_of(k + 2), tid);
    // the store of chunk k-1 and the prep of chunk k+1 (other buffers)
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      if (k > 0) store(k - 1, i);
      if (k + 1 < n_chunks) prep(k + 1, i);
    }
    if (k + 1 < n_chunks) {
      prep_bc(k + 1, 0);
      prep_bc(k + 1, 1);
    }

    if constexpr (States) {
      // the state before chunk k, a float4 a channel when N fills the lanes
      float* st = p.states + (b * n_chunks + k) * di * N;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int d = c0 + 2 * pi + j;
        if (d >= di) continue;
        if (N == NP) {
          *reinterpret_cast<float4*>(st + (long long)d * N + 4 * l) =
              make_float4(h[j][0], h[j][1], h[j][2], h[j][3]);
        } else {
#pragma unroll
          for (int k2 = 0; k2 < 4; ++k2)
            if (4 * l + k2 < N) st[(long long)d * N + 4 * l + k2] = h[j][k2];
        }
      }
    }

    // the scan of chunk k: a partial y of two channels a lane and step
    const int Tk = steps_of(k);
    const float4* rec = reinterpret_cast<const float4*>(rec_of(k));
    const float* sb = Sm::kBcInRing ? reinterpret_cast<const float*>(
                                          slot_of(k) + Sm::bc_off)
                                    : bcf_of(k);
    float* yp = yp_of(k);
#pragma unroll
    for (int t = 0; t < kScanSteps; ++t) {
      if (t < Tk) {
        // dt and dt x of both channels
        const float4 r = rec[t * (kScanChannels / 2) + pi];
        const float4 bq =
            *reinterpret_cast<const float4*>(sb + 2 * t * NP + 4 * l);
        const float4 cq =
            *reinterpret_cast<const float4*>(sb + (2 * t + 1) * NP + 4 * l);
        const float bv[4] = {bq.x, bq.y, bq.z, bq.w};
        const float cv[4] = {cq.x, cq.y, cq.z, cq.w};
        const float dtv[2] = {r.x, r.z}, dxv[2] = {r.y, r.w};
        float acc[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
#pragma unroll
          for (int k2 = 0; k2 < 4; ++k2) {
            h[j][k2] = fmaf(ex2_approx(dtv[j] * a2[j][k2]), h[j][k2],
                            dxv[j] * bv[k2]);
            acc[j] = k2 ? fmaf(h[j][k2], cv[k2], acc[j]) : h[j][k2] * cv[k2];
          }
        }
        *reinterpret_cast<float2*>(yp + (t * L + l) * Sm::kYpLd + 2 * pi) =
            make_float2(acc[0], acc[1]);
      }
    }
    if (k + 2 < n_chunks)
      ahead.deposit(p, slot_of(k + 2), c0, steps_of(k + 2), tid);
  }
  if (n_chunks > 0) {
    __syncthreads();   // the last chunk's partial y
#pragma unroll
    for (int i = 0; i < kItems; ++i) store(n_chunks - 1, i);
  }
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int d = c0 + 2 * pi + j;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int n = 4 * l + k;
      if (d < di && n < N) p.h_last[(b * di + d) * N + n] = h[j][k];
    }
  }
}

template <typename T, bool Mixer, int NP, bool States>
static int launch(const ScanArgs& p, int batch, cudaStream_t stream) {
  using Sm = ScanSmem<T, Mixer, NP>;
  // let the blocks of the main shape share an SM's shared memory (and the
  // float32 mixer take more than the 48 KB a launch gets by default)
  static const cudaError_t attr = [] {
    cudaError_t e = cudaFuncSetAttribute(
        ssm_scan_kernel<T, Mixer, NP, States>,
        cudaFuncAttributePreferredSharedMemoryCarveout,
        cudaSharedmemCarveoutMaxShared);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(ssm_scan_kernel<T, Mixer, NP, States>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               Sm::bytes);
    return e;
  }();
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((p.di + kScanChannels - 1) / kScanChannels, batch);
  ssm_scan_kernel<T, Mixer, NP, States>
      <<<grid, Sm::kThreads, Sm::bytes, stream>>>(p);
  RT_RETURN_IF_ERROR();
  return 0;
}

template <typename T, bool Mixer>
static int run(ScanArgs p, int batch, void* stream) {
  if (batch < 1 || batch > 65535 || p.S < 0 || p.di < 1 || p.N < 1 ||
      p.N > kMaxState)
    return (int)cudaErrorInvalidValue;
  const auto aligned = [](const void* q, int n) {
    return reinterpret_cast<uintptr_t>(q) % n == 0;
  };
  p.vec = p.di % 8 == 0 && aligned(p.x, 16) && aligned(p.dt, 16) &&
          aligned(p.y, 16) && (!Mixer || aligned(p.z, 16));
  constexpr int es = sizeof(T);
  const auto rows = [&](int n) {
    return aligned(p.bm, n) && aligned(p.cm, n) && (p.bc_sb * es) % n == 0 &&
           (p.bc_ss * es) % n == 0 && (p.N * es) % n == 0;
  };
  p.bc_words = rows(4);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if constexpr (Mixer) {
    if (p.states) {
      auto go = p.N <= 4 ? launch<T, Mixer, 4, true>
              : p.N <= 8 ? launch<T, Mixer, 8, true>
              : p.N <= 16 ? launch<T, Mixer, 16, true>
                          : launch<T, Mixer, 32, true>;
      return go(p, batch, st);
    }
  }
  auto go = p.N <= 4 ? launch<T, Mixer, 4, false>
          : p.N <= 8 ? launch<T, Mixer, 8, false>
          : p.N <= 16 ? launch<T, Mixer, 16, false>
                      : launch<T, Mixer, 32, false>;
  return go(p, batch, st);
}

template <typename T>
static int mamba_scan(const void* xc, const void* dt_lin, const void* dt_bias,
                      const void* bm, const void* cm, long long bc_sb,
                      long long bc_ss, const void* a, const void* dskip,
                      const void* z, const void* h0, void* y, void* h_last,
                      void* states, int batch, int S, int di, int N,
                      void* stream) {
  ScanArgs p{xc, static_cast<const float*>(dt_lin),
             static_cast<const float*>(dt_bias), bm, cm, bc_sb, bc_ss,
             static_cast<const float*>(a), static_cast<const float*>(dskip),
             z, static_cast<const float*>(h0), y,
             static_cast<float*>(h_last), static_cast<float*>(states), S, di,
             N, 0, 0};
  return run<T, true>(p, batch, stream);
}

extern "C" {
// xc, dt, y: (batch, S, di); bm, cm: (batch, S, N); a: (di, N);
// dskip: (di,); h_last: (batch, di, N).  All float32, contiguous.
int rt_ssm_scan_f32(const void* xc, const void* dt, const void* bm,
                    const void* cm, const void* a, const void* dskip,
                    void* y, void* h_last, int batch, int S, int di, int N,
                    void* stream) {
  ScanArgs p{xc, static_cast<const float*>(dt), nullptr, bm, cm,
             (long long)S * N, N, static_cast<const float*>(a),
             static_cast<const float*>(dskip), nullptr, nullptr, y,
             static_cast<float*>(h_last), nullptr, S, di, N, 0, 0};
  return run<float, false>(p, batch, stream);
}

// xc, z, y: (batch, S, di) in the activation type, contiguous; dt_lin:
// (batch, S, di) float32, contiguous; bm, cm: (batch, S, N) in the
// activation type, element (b, t, n) at b * bc_sb + t * bc_ss + n;
// dt_bias, dskip: (di,), a: (di, N), h0 (or null), h_last: (batch, di, N),
// states (or null): (batch, ceil(S/8), di, N), float32, contiguous.
int rt_mamba_scan_f32(const void* xc, const void* dt_lin, const void* dt_bias,
                      const void* bm, const void* cm, long long bc_sb,
                      long long bc_ss, const void* a, const void* dskip,
                      const void* z, const void* h0, void* y, void* h_last,
                      void* states, int batch, int S, int di, int N,
                      void* stream) {
  return mamba_scan<float>(xc, dt_lin, dt_bias, bm, cm, bc_sb, bc_ss, a,
                           dskip, z, h0, y, h_last, states, batch, S, di, N,
                           stream);
}
int rt_mamba_scan_bf16(const void* xc, const void* dt_lin,
                       const void* dt_bias, const void* bm, const void* cm,
                       long long bc_sb, long long bc_ss, const void* a,
                       const void* dskip, const void* z, const void* h0,
                       void* y, void* h_last, void* states, int batch, int S,
                       int di, int N, void* stream) {
  return mamba_scan<__nv_bfloat16>(xc, dt_lin, dt_bias, bm, cm, bc_sb, bc_ss,
                                   a, dskip, z, h0, y, h_last, states, batch,
                                   S, di, N, stream);
}
}
