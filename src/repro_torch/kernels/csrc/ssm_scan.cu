// Mamba-1 selective scan (forward) for Hopper, float32.
//
// Replaces the Pallas kernel of src/repro/kernels/ssm_scan.py:83 (ssm_scan,
// body _kernel :29).  Per batch row b, channel d and state index n:
//
//   h_t = exp(dt_t * A[d, n]) * h_{t-1} + (dt_t * x_t) * B_t[n]
//   y_t = sum_n h_t[n] * C_t[n] + D[d] * x_t
//
// and the final state h_S.  The TPU kernel keeps h in VMEM scratch across a
// grid axis over S that runs in order; CUDA blocks run in no order, so the
// carry lives in one thread's loop instead.  One thread per (b, d) holds all
// N states of its channel in registers for all S steps, so the reduction
// over n that forms y is a register sum, with no shuffles and no shared
// memory traffic per state.  A block of 64 consecutive channels stages x
// and dt for 32 time steps in shared memory (one coalesced 256-byte row per
// step) together with the 32 steps' B and C rows (shared by every channel
// of the batch row), then writes y back the same way; y reuses x's slot.
// N is padded to NP, a power of two of at least 4, with A = 0 and B = C = 0
// on the padding, so those states stay 0 and add nothing to y.
//
// Bound on this card, at B=4, S=2048, d_inner=8192, N=16: the exponentials
// (B*S*d_inner*N = 1.07e9 on the special-function units, 16 per clock per
// SM) at ~0.26 ms, just above the bytes (read x and dt, write y: ~0.81 GB,
// ~0.24 ms at 3.35 TB/s); the other float32 work is ~4 operations per
// (step, channel, state), ~0.06 ms.  exp is one ex2.approx of dt*A*log2(e),
// with A*log2(e) formed once per thread.

#include "common.cuh"

constexpr int kScanChannels = 64;   // channels per block = threads per block
constexpr int kScanSteps = 32;      // time steps staged per chunk
constexpr int kMaxState = 32;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <int NP>
__global__ void __launch_bounds__(kScanChannels)
ssm_scan_kernel(const float* __restrict__ xc, const float* __restrict__ dt,
                const float* __restrict__ bm, const float* __restrict__ cm,
                const float* __restrict__ a, const float* __restrict__ dskip,
                float* __restrict__ y, float* __restrict__ h_last, int S,
                int di, int N) {
  __shared__ float sx[kScanSteps][kScanChannels];   // x, then y in place
  __shared__ float sdt[kScanSteps][kScanChannels];
  __shared__ __align__(16) float sb[kScanSteps][NP];
  __shared__ __align__(16) float sc[kScanSteps][NP];
  const int tid = threadIdx.x;
  const long long b = blockIdx.y;
  const int d = blockIdx.x * kScanChannels + tid;
  const bool live = d < di;

  float a2[NP], h[NP];
#pragma unroll
  for (int n = 0; n < NP; ++n) {
    a2[n] = (live && n < N) ? a[(long long)d * N + n] * kLog2e : 0.f;
    h[n] = 0.f;
  }
  const float dsk = live ? dskip[d] : 0.f;
  const long long row0 = b * S;

  for (int t0 = 0; t0 < S; t0 += kScanSteps) {
    const int T = min(kScanSteps, S - t0);
    // x and dt: each thread its own channel's column, a warp one row
#pragma unroll 8
    for (int t = 0; t < T; ++t) {
      const long long off = (row0 + t0 + t) * di + d;
      sx[t][tid] = live ? xc[off] : 0.f;
      sdt[t][tid] = live ? dt[off] : 0.f;
    }
    // B and C: T*N contiguous values each, zero-padded to NP
    for (int e = tid; e < T * NP; e += kScanChannels) {
      const int t = e / NP, n = e % NP;
      const long long off = (row0 + t0 + t) * N + n;
      sb[t][n] = n < N ? bm[off] : 0.f;
      sc[t][n] = n < N ? cm[off] : 0.f;
    }
    __syncthreads();
    for (int t = 0; t < T; ++t) {
      const float x = sx[t][tid], dtt = sdt[t][tid];
      const float dx = dtt * x;
      const float4* b4 = reinterpret_cast<const float4*>(sb[t]);
      const float4* c4 = reinterpret_cast<const float4*>(sc[t]);
      float acc = dsk * x;
#pragma unroll
      for (int q = 0; q < NP / 4; ++q) {
        const float4 bq = b4[q], cq = c4[q];
        const float bv[4] = {bq.x, bq.y, bq.z, bq.w};
        const float cv[4] = {cq.x, cq.y, cq.z, cq.w};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int n = 4 * q + k;
          h[n] = fmaf(ex2_approx(dtt * a2[n]), h[n], dx * bv[k]);
          acc = fmaf(h[n], cv[k], acc);
        }
      }
      sx[t][tid] = acc;
    }
    __syncthreads();   // B and C are read by every thread before restaging
    if (live) {
#pragma unroll 8
      for (int t = 0; t < T; ++t) y[(row0 + t0 + t) * di + d] = sx[t][tid];
    }
  }
  if (live) {
#pragma unroll
    for (int n = 0; n < NP; ++n)   // unrolled: h stays in registers
      if (n < N) h_last[(b * di + d) * N + n] = h[n];
  }
}

template <int NP>
static int launch(const void* xc, const void* dt, const void* bm,
                  const void* cm, const void* a, const void* dskip, void* y,
                  void* h_last, int batch, int S, int di, int N,
                  cudaStream_t stream) {
  const dim3 grid((di + kScanChannels - 1) / kScanChannels, batch);
  ssm_scan_kernel<NP><<<grid, kScanChannels, 0, stream>>>(
      static_cast<const float*>(xc), static_cast<const float*>(dt),
      static_cast<const float*>(bm), static_cast<const float*>(cm),
      static_cast<const float*>(a), static_cast<const float*>(dskip),
      static_cast<float*>(y), static_cast<float*>(h_last), S, di, N);
  RT_RETURN_IF_ERROR();
  return 0;
}

extern "C" {
// xc, dt, y: (batch, S, di); bm, cm: (batch, S, N); a: (di, N);
// dskip: (di,); h_last: (batch, di, N).  All float32, contiguous.
int rt_ssm_scan_f32(const void* xc, const void* dt, const void* bm,
                    const void* cm, const void* a, const void* dskip,
                    void* y, void* h_last, int batch, int S, int di, int N,
                    void* stream) {
  if (batch < 1 || batch > 65535 || S < 0 || di < 1 || N < 1 ||
      N > kMaxState)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto go = N <= 4 ? launch<4> : N <= 8 ? launch<8>
          : N <= 16 ? launch<16> : launch<32>;
  return go(xc, dt, bm, cm, a, dskip, y, h_last, batch, S, di, N, st);
}
}
