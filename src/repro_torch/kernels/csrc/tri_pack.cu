// Tile-major triangular packing and unpacking, batched over matrices, for
// Hopper.
//
// pack: replaces the Pallas kernel of src/repro/kernels/tri_pack.py:73
// (pack_tril, body _pack_kernel :25).  The TPU version reads its (i, j) tile
// coordinates from a scalar-prefetched map; here each block decodes them from
// its packed tile index (tile-column-major: column j holds nt - j tiles and
// starts at j nt - j (j - 1) / 2), so no map is copied to the card per call.
// One block per (packed tile, matrix) copies one B x B tile (B a template
// parameter: 16, 32, 64, 128) of the (h, h) matrix into its slot of the (P,)
// packed vector.  Each thread moves 16 bytes per access and issues four
// loads before its four stores.  The upper half of a diagonal tile and the
// ragged edge (h % B != 0) are written as zeros without being read, so no
// padded copy of the input is ever made.  When a matrix row is not 16-byte
// aligned (h * itemsize % 16 != 0, or a misaligned base pointer) the same
// block copies element by element.
//
// unpack: replaces the Pallas kernel of src/repro/kernels/tri_pack.py:104
// (unpack_tril, body _unpack_kernel :38).  The TPU version walks an (nt, nt)
// grid of output tiles, reading each lower tile through the scalar-prefetched
// (i, j) -> packed-index map and zeroing the upper ones, into a padded
// (hp, hp) buffer that is then cropped.  Here the map is an int32 tensor
// (nt, nt), one block per (output tile, matrix) writes its tile of the
// unpadded (h, h) output directly: lower tiles copied from the packed vector
// (upper half of a diagonal tile written as 0), upper tiles written as 0,
// rows and columns past h never written.
//
// Bound on this card: bytes (each packed or dense value read once, each
// output value written once, no arithmetic).  Consecutive threads touch
// consecutive columns of a tile row, so reads and writes are coalesced.

#include <cstdint>

#include "common.cuh"

// The VN values of tile row r from column c on, as a 16-byte vector: zeros
// past the ragged edge and above the diagonal of a diagonal tile, read only
// where they are kept.
template <typename T, typename V, int VN>
__device__ __forceinline__ V tile_vec(const T* __restrict__ src, int h,
                                      int r, int c, int rows, int cols,
                                      bool diag) {
  V v{};
  if (r >= rows || c >= cols || (diag && c > r)) return v;
  if (c + VN <= cols && !(diag && c + VN - 1 > r))
    return *reinterpret_cast<const V*>(src + (long long)r * h + c);
  T* e = reinterpret_cast<T*>(&v);
#pragma unroll
  for (int k = 0; k < VN; ++k)
    if (c + k < cols && !(diag && c + k > r)) e[k] = src[(long long)r * h + c + k];
  return v;
}

template <typename T, int B, bool VEC>
__global__ void __launch_bounds__(kThreads)
pack_kernel(const T* __restrict__ mat, T* __restrict__ out, int nt, int h) {
  const int p = blockIdx.x;
  const long long b = blockIdx.y;
  int j = 0;
  while ((j + 1) * nt - (j + 1) * j / 2 <= p) ++j;
  const int i = j + p - (j * nt - j * (j - 1) / 2);
  const long long n_blocks = (long long)nt * (nt + 1) / 2;
  const T* src = mat + b * h * h + (long long)i * B * h + j * B;
  T* dst = out + (b * n_blocks + p) * B * B;
  const int rows = min(B, h - i * B), cols = min(B, h - j * B);
  const bool diag = i == j;
  if (VEC) {
    using V = typename Vec16<T>::type;
    constexpr int VN = 16 / sizeof(T), NV = B * B / VN, U = 4;
    for (int e0 = threadIdx.x; e0 < NV; e0 += U * kThreads) {
      V buf[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int e = e0 + u * kThreads;
        if (e < NV)
          buf[u] = tile_vec<T, V, VN>(src, h, e / (B / VN), e % (B / VN) * VN,
                                      rows, cols, diag);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int e = e0 + u * kThreads;
        if (e < NV) reinterpret_cast<V*>(dst)[e] = buf[u];
      }
    }
  } else {
    for (int e = threadIdx.x; e < B * B; e += kThreads) {
      const int r = e / B, c = e % B;
      T v = T(0);
      if (r < rows && c < cols && !(diag && c > r))
        v = src[(long long)r * h + c];
      dst[e] = v;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
unpack_kernel(const T* __restrict__ vec, T* __restrict__ out,
              const int* __restrict__ pmap, int nt, long long P, int h, int B) {
  const int i = blockIdx.x / nt, j = blockIdx.x % nt;
  const long long b = blockIdx.y;
  const T* src = vec + b * P + (long long)pmap[i * nt + j] * B * B;
  T* dst = out + b * h * h;
  const int rows = min(B, h - i * B), cols = min(B, h - j * B);
  for (int e = threadIdx.x; e < rows * cols; e += kThreads) {
    const int r = e / cols, c = e % cols;
    T v = T(0);
    if (i > j || (i == j && c <= r)) v = src[r * B + c];
    dst[(long long)(i * B + r) * h + j * B + c] = v;
  }
}

template <typename T, int B>
static int pack_b(const T* mat, T* out, int batch, int h, cudaStream_t s) {
  const int nt = (h + B - 1) / B;
  const bool vec = h % (16 / sizeof(T)) == 0 &&
                   (reinterpret_cast<uintptr_t>(mat) |
                    reinterpret_cast<uintptr_t>(out)) % 16 == 0;
  const dim3 grid(nt * (nt + 1) / 2, batch);
  if (vec)
    pack_kernel<T, B, true><<<grid, kThreads, 0, s>>>(mat, out, nt, h);
  else
    pack_kernel<T, B, false><<<grid, kThreads, 0, s>>>(mat, out, nt, h);
  RT_RETURN_IF_ERROR();
  return 0;
}

template <typename T>
static int pack(const void* mat, void* out, int batch, int h, int B,
                void* stream) {
  if (batch > 65535 || h <= 0) return (int)cudaErrorInvalidValue;
  const T* m = static_cast<const T*>(mat);
  T* o = static_cast<T*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (B) {
    case 16: return pack_b<T, 16>(m, o, batch, h, s);
    case 32: return pack_b<T, 32>(m, o, batch, h, s);
    case 64: return pack_b<T, 64>(m, o, batch, h, s);
    case 128: return pack_b<T, 128>(m, o, batch, h, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
static int unpack(const void* vec, void* out, const void* pmap, int batch,
                  int h, int B, void* stream) {
  if (batch > 65535) return (int)cudaErrorInvalidValue;
  const int nt = (h + B - 1) / B;
  const long long P = (long long)nt * (nt + 1) / 2 * B * B;
  unpack_kernel<T><<<dim3(nt * nt, batch), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(vec), static_cast<T*>(out),
      static_cast<const int*>(pmap), nt, P, h, B);
  RT_RETURN_IF_ERROR();
  return 0;
}

extern "C" {
// mat: (batch, h, h); out: (batch, n_blocks * B * B), n_blocks = nt (nt +
// 1) / 2 lower tiles in tile-column-major order; B is 16, 32, 64 or 128.
int rt_pack_tril_f64(const void* mat, void* out, int batch, int h, int B,
                     void* stream) {
  return pack<double>(mat, out, batch, h, B, stream);
}
int rt_pack_tril_f32(const void* mat, void* out, int batch, int h, int B,
                     void* stream) {
  return pack<float>(mat, out, batch, h, B, stream);
}
// vec: (batch, P) packed factors; out: (batch, h, h); pmap: (nt, nt)
// dense tile -> packed tile index (read for lower tiles only).
int rt_unpack_tril_f64(const void* vec, void* out, const void* pmap, int batch,
                       int h, int B, void* stream) {
  return unpack<double>(vec, out, pmap, batch, h, B, stream);
}
int rt_unpack_tril_f32(const void* vec, void* out, const void* pmap, int batch,
                       int h, int B, void* stream) {
  return unpack<float>(vec, out, pmap, batch, h, B, stream);
}
}
