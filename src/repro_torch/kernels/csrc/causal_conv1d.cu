// Depthwise causal convolution, bias and silu of the Mamba-1 mixer in one
// pass, from the wx GEMM's output to the post-conv activations xc.
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
// the new state xp[S : S+K-1].  Rounded so, the kernel can equal its plain
// version bit for bit.
//
// Bound on this card: bytes.  At the serve prefill (B=4, S=2048, C=8192,
// bf16) it reads x once and writes xc once, 2 x 134 MB, ~0.080 ms at
// 3.35 TB/s; K products and sums and a silu per element are far below the
// FP32 and MUFU rates.  The design moves those bytes once, in 16-byte
// accesses: one thread per (batch row, 16 bytes of channels: 8 in bf16, 4 in
// float32, neighbouring threads on neighbouring channels, so a warp reads
// 512 contiguous bytes a step), walking a strip of 32 steps with the K-1
// previous inputs in registers; it reloads only the K-1 inputs before its
// strip (a few percent more reads, from L2).  The pointers are restrict-
// qualified, so the loads of later steps are not held behind this step's
// store.  (Measured on this card: loading a whole strip into registers
// first, 8 or 16 steps, took 168 to 230 registers a thread and was slower.)
// The weights and bias of its
// channels are read once, into registers.  Replaces the plain version's
// cat, casts, K products into temporaries and K-1 in-place adds (~42 reads
// and writes of the activation tensor), then the bias add and silu.

#include <cstdint>

#include "mixer.cuh"

constexpr int kConvThreads = 128;
constexpr int kConvStrip = 32;   // steps a thread walks
constexpr int kBwdStrip = 64;    // output rows a thread of the backward owns
constexpr int kWidth = 4;        // K, d_conv of every configuration

struct ConvArgs {
  const void* x;      // (batch, S, C)
  const void* w;      // (C, K)
  const void* bias;   // (C,)
  const void* state;  // (batch, K-1, C) or null (zeros)
  void* out;          // (batch, S, C)
  void* new_state;    // (batch, K-1, C)
  int S, C, vec;      // vec: x, state, out, new_state 16-byte aligned, C % V == 0
};

// V channels of row r of xp = [state, x] as float32 (nv of them live)
template <typename T, int K, int V>
__device__ __forceinline__ void load_xp(const T* __restrict__ x,
                                        const T* __restrict__ state,
                                        const ConvArgs& p, long long b, int r,
                                        int c0, int nv, float (&v)[V]) {
  const T* src;
  if (r < K - 1) {
    if (!state) {
#pragma unroll
      for (int j = 0; j < V; ++j) v[j] = 0.f;
      return;
    }
    src = state + (b * (K - 1) + r) * p.C + c0;
  } else {
    src = x + (b * p.S + r - (K - 1)) * p.C + c0;
  }
  if (p.vec) {
    load_packed<T, V>(src, v);
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) v[j] = j < nv ? to_f32(src[j]) : 0.f;
  }
}

template <typename T, int V>
__device__ __forceinline__ void store_row(const ConvArgs& p,
                                          T* __restrict__ dst, int nv,
                                          const float (&v)[V]) {
  if (p.vec) {
    store_packed<T, V>(dst, v);
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j)
      if (j < nv) dst[j] = from_f32<T>(v[j]);
  }
}

template <typename T, int K>
__global__ void __launch_bounds__(kConvThreads)
causal_conv1d_silu_kernel(const ConvArgs p) {
  constexpr int V = 16 / sizeof(T);
  const int c0 = (blockIdx.x * kConvThreads + threadIdx.x) * V;
  if (c0 >= p.C) return;
  const int nv = min(V, p.C - c0);
  const long long b = blockIdx.z;
  const int t_begin = blockIdx.y * kConvStrip;
  const int t_end = min(p.S, t_begin + kConvStrip);
  // read-only inputs and a distinct output: the loads of later steps may
  // run ahead of this step's store
  const T* __restrict__ xg = static_cast<const T*>(p.x);
  const T* __restrict__ sg = static_cast<const T*>(p.state);
  T* __restrict__ og = static_cast<T*>(p.out);

  float w[K][V], bias[V];
  const T* wg = static_cast<const T*>(p.w);
  const T* bg = static_cast<const T*>(p.bias);
#pragma unroll
  for (int j = 0; j < V; ++j) {
#pragma unroll
    for (int k = 0; k < K; ++k)
      w[k][j] = j < nv ? to_f32(wg[(long long)(c0 + j) * K + k]) : 0.f;
    bias[j] = j < nv ? to_f32(bg[c0 + j]) : 0.f;
  }
  // win[i]: xp row t + i for the next step t
  float win[K - 1][V];
#pragma unroll
  for (int i = 0; i < K - 1; ++i)
    load_xp<T, K, V>(xg, sg, p, b, t_begin + i, c0, nv, win[i]);

#pragma unroll 4
  for (int t = t_begin; t < t_end; ++t) {
    float cur[V], y[V];
    load_xp<T, K, V>(xg, sg, p, b, t + K - 1, c0, nv, cur);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      float acc = __fmul_rn(win[0][j], w[0][j]);
#pragma unroll
      for (int k = 1; k < K - 1; ++k)
        acc = __fadd_rn(acc, __fmul_rn(win[k][j], w[k][j]));
      acc = __fadd_rn(acc, __fmul_rn(cur[j], w[K - 1][j]));
      y[j] = silu_f32(round_to<T>(round_to<T>(acc) + bias[j]));
    }
    store_row<T, V>(p, og + (b * p.S + t) * p.C + c0, nv, y);
#pragma unroll
    for (int i = 0; i < K - 2; ++i)
#pragma unroll
      for (int j = 0; j < V; ++j) win[i][j] = win[i + 1][j];
#pragma unroll
    for (int j = 0; j < V; ++j) win[K - 2][j] = cur[j];
  }
  // the last strip's window is xp[S : S+K-1], the new state
  if (blockIdx.y == gridDim.y - 1) {
    T* ns = static_cast<T*>(p.new_state);
#pragma unroll
    for (int i = 0; i < K - 1; ++i)
      store_row<T, V>(p, ns + (b * (K - 1) + i) * p.C + c0, nv, win[i]);
  }
}

struct ConvBwdArgs {
  ConvArgs f;         // x, w, bias, state, S, C, vec (out, new_state unused)
  const void* dout;   // (batch, S, C)
  void* dx;           // (batch, S, C)
  void* dstate;       // (batch, K-1, C) or null
  float* part;        // (batch * strips, C, K + 1): dw_0..dw_{K-1}, db
};

// silu's backward as PyTorch's kernel writes it, each operation rounded
// (no contraction): dout * s * (1 + v * (1 - s)), s = 1 / (1 + exp(-v))
__device__ __forceinline__ float silu_grad_f32(float dout, float v) {
  const float s = __fdiv_rn(1.f, __fadd_rn(1.f, expf(-v)));
  return __fmul_rn(__fmul_rn(dout, s),
                   __fadd_rn(1.f, __fmul_rn(v, __fsub_rn(1.f, s))));
}

template <typename T, int K>
__global__ void __launch_bounds__(kConvThreads)
causal_conv1d_silu_bwd_kernel(const ConvBwdArgs p) {
  constexpr int V = 16 / sizeof(T);
  const ConvArgs& f = p.f;
  const int c0 = (blockIdx.x * kConvThreads + threadIdx.x) * V;
  if (c0 >= f.C) return;
  const int nv = min(V, f.C - c0);
  const long long b = blockIdx.z;
  const int s0 = blockIdx.y * kBwdStrip;
  const int s1 = min(f.S, s0 + kBwdStrip);
  const T* __restrict__ xg = static_cast<const T*>(f.x);
  const T* __restrict__ sg = static_cast<const T*>(f.state);
  const T* __restrict__ dg = static_cast<const T*>(p.dout);
  T* __restrict__ dxg = static_cast<T*>(p.dx);

  float w[K][V], bias[V];
  const T* wg = static_cast<const T*>(f.w);
  const T* bg = static_cast<const T*>(f.bias);
#pragma unroll
  for (int j = 0; j < V; ++j) {
#pragma unroll
    for (int k = 0; k < K; ++k)
      w[k][j] = j < nv ? to_f32(wg[(long long)(c0 + j) * K + k]) : 0.f;
    bias[j] = j < nv ? to_f32(bg[c0 + j]) : 0.f;
  }
  // win[i]: xp row t + i for the next step t; dq[i]: dpre of step
  // t - K + 1 + i (zeros before the strip: no output of the strip reads them)
  float win[K - 1][V], dq[K][V], dw[K][V], db[V];
#pragma unroll
  for (int i = 0; i < K - 1; ++i)
    load_xp<T, K, V>(xg, sg, f, b, s0 + i, c0, nv, win[i]);
#pragma unroll
  for (int j = 0; j < V; ++j) {
    db[j] = 0.f;
#pragma unroll
    for (int k = 0; k < K; ++k) dw[k][j] = dq[k][j] = 0.f;
  }

  for (int t = s0; t < s1 + K - 1; ++t) {
    float dnew[V];
    if (t < f.S) {
      float cur[V], dov[V];
      load_xp<T, K, V>(xg, sg, f, b, t + K - 1, c0, nv, cur);
      load_xp<T, K, V>(dg, nullptr, f, b, t + K - 1, c0, nv, dov);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        float acc = __fmul_rn(win[0][j], w[0][j]);
#pragma unroll
        for (int k = 1; k < K - 1; ++k)
          acc = __fadd_rn(acc, __fmul_rn(win[k][j], w[k][j]));
        acc = __fadd_rn(acc, __fmul_rn(cur[j], w[K - 1][j]));
        const float pre = round_to<T>(round_to<T>(acc) + bias[j]);
        dnew[j] = round_to<T>(silu_grad_f32(dov[j], pre));
        if (t < s1) {   // a step of this strip: its share of dw and db
          db[j] += dnew[j];
#pragma unroll
          for (int k = 0; k < K - 1; ++k) dw[k][j] += dnew[j] * win[k][j];
          dw[K - 1][j] += dnew[j] * cur[j];
        }
      }
#pragma unroll
      for (int i = 0; i < K - 2; ++i)
#pragma unroll
        for (int j = 0; j < V; ++j) win[i][j] = win[i + 1][j];
#pragma unroll
      for (int j = 0; j < V; ++j) win[K - 2][j] = cur[j];
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) dnew[j] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < K - 1; ++i)
#pragma unroll
      for (int j = 0; j < V; ++j) dq[i][j] = dq[i + 1][j];
#pragma unroll
    for (int j = 0; j < V; ++j) dq[K - 1][j] = dnew[j];
    // dxp row r = t: sum_k dpre_{r-k} w_k, k = 0 first
    const int s = t - (K - 1);   // x row of xp row t + ... : dx_s = dxp[s + K - 1]
    const bool own = s >= s0 && s < s1;
    const bool head = s < 0 && p.dstate;
    if (own || head) {
      float v[V];
#pragma unroll
      for (int j = 0; j < V; ++j) {
        float acc = 0.f;
#pragma unroll
        for (int k = 0; k < K; ++k)
          acc = __fadd_rn(acc, __fmul_rn(dq[K - 1 - k][j], w[k][j]));
        v[j] = acc;
      }
      if (own)
        store_row<T, V>(f, dxg + (b * f.S + s) * f.C + c0, nv, v);
      else
        store_row<T, V>(f, static_cast<T*>(p.dstate) +
                               (b * (K - 1) + s + K - 1) * f.C + c0, nv, v);
    }
  }
  float* part = p.part + ((b * gridDim.y + blockIdx.y) * f.C + c0) * (K + 1);
#pragma unroll
  for (int j = 0; j < V; ++j) {
    if (j < nv) {
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

template <typename T, int K>
static int launch(const ConvArgs& p, int batch, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const int groups = (p.C + V - 1) / V;
  const int strips = p.S > 0 ? (p.S + kConvStrip - 1) / kConvStrip : 1;
  if (strips > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((groups + kConvThreads - 1) / kConvThreads, strips, batch);
  causal_conv1d_silu_kernel<T, K><<<grid, kConvThreads, 0, stream>>>(p);
  RT_RETURN_IF_ERROR();
  return 0;
}

template <typename T>
static int conv(const void* x, const void* w, const void* bias,
                const void* state, void* out, void* new_state, int batch,
                int S, int C, int K, void* stream) {
  if (batch < 1 || batch > 65535 || S < 0 || C < 1 || K != kWidth)
    return (int)cudaErrorInvalidValue;
  const auto aligned = [](const void* q) {
    return reinterpret_cast<uintptr_t>(q) % 16 == 0;
  };
  ConvArgs p{x, w, bias, state, out, new_state, S, C, 0};
  p.vec = C % (16 / (int)sizeof(T)) == 0 && aligned(x) && aligned(out) &&
          aligned(new_state) && (!state || aligned(state));
  return launch<T, kWidth>(p, batch, static_cast<cudaStream_t>(stream));
}

template <typename T>
static int conv_bwd(const void* x, const void* w, const void* bias,
                    const void* state, const void* dout, void* dx,
                    void* dstate, void* part, int batch, int S, int C, int K,
                    void* stream) {
  if (batch < 1 || batch > 65535 || S < 0 || C < 1 || K != kWidth)
    return (int)cudaErrorInvalidValue;
  const auto aligned = [](const void* q) {
    return reinterpret_cast<uintptr_t>(q) % 16 == 0;
  };
  constexpr int V = 16 / (int)sizeof(T);
  ConvBwdArgs p{{x, w, bias, state, nullptr, nullptr, S, C, 0}, dout, dx,
                dstate, static_cast<float*>(part)};
  p.f.vec = C % V == 0 && aligned(x) && aligned(dout) && aligned(dx) &&
            (!state || aligned(state)) && (!dstate || aligned(dstate));
  const int groups = (C + V - 1) / V;
  const int strips = S > 0 ? (S + kBwdStrip - 1) / kBwdStrip : 1;
  if (strips > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((groups + kConvThreads - 1) / kConvThreads, strips, batch);
  causal_conv1d_silu_bwd_kernel<T, kWidth>
      <<<grid, kConvThreads, 0, static_cast<cudaStream_t>(stream)>>>(p);
  RT_RETURN_IF_ERROR();
  return 0;
}

extern "C" {
// x, out: (batch, S, C); w: (C, K); bias: (C,); state (or null), new_state:
// (batch, K-1, C); all in one type (float32 or bf16), contiguous.
int rt_causal_conv1d_silu_f32(const void* x, const void* w, const void* bias,
                              const void* state, void* out, void* new_state,
                              int batch, int S, int C, int K, void* stream) {
  return conv<float>(x, w, bias, state, out, new_state, batch, S, C, K,
                     stream);
}
int rt_causal_conv1d_silu_bf16(const void* x, const void* w, const void* bias,
                               const void* state, void* out, void* new_state,
                               int batch, int S, int C, int K, void* stream) {
  return conv<__nv_bfloat16>(x, w, bias, state, out, new_state, batch, S, C,
                             K, stream);
}
// x, dout, dx: (batch, S, C); w: (C, K); bias: (C,); state, dstate (each
// or null): (batch, K-1, C); all in one type, contiguous; part: (batch *
// ceil(S/64), C, K + 1) float32 scratch (S = 0: batch rows of it).
int rt_causal_conv1d_silu_bwd_f32(const void* x, const void* w,
                                  const void* bias, const void* state,
                                  const void* dout, void* dx, void* dstate,
                                  void* part, int batch, int S, int C, int K,
                                  void* stream) {
  return conv_bwd<float>(x, w, bias, state, dout, dx, dstate, part, batch, S,
                         C, K, stream);
}
int rt_causal_conv1d_silu_bwd_bf16(const void* x, const void* w,
                                   const void* bias, const void* state,
                                   const void* dout, void* dx, void* dstate,
                                   void* part, int batch, int S, int C, int K,
                                   void* stream) {
  return conv_bwd<__nv_bfloat16>(x, w, bias, state, dout, dx, dstate, part,
                                 batch, S, C, K, stream);
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
