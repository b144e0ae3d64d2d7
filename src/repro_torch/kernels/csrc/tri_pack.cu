// Tile-major triangular packing and unpacking, batched over matrices, for
// Hopper.
//
// pack: replaces the Pallas kernel of src/repro/kernels/tri_pack.py:73
// (pack_tril, body _pack_kernel :25).  The TPU version reads its (i, j) tile
// coordinates from a scalar-prefetched map; here the wrapper passes the same
// map as an int32 tensor (2, n_blocks) and each block reads its own pair.
// One block per (packed tile, matrix) copies one B x B tile of the (h, h)
// matrix into its slot of the (P,) packed vector, zeroing the upper half of
// diagonal tiles.  The ragged edge (h % B != 0) is masked here, so no padded
// copy of the input is ever made.
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

#include "common.cuh"

template <typename T>
__global__ void __launch_bounds__(kThreads)
pack_kernel(const T* __restrict__ mat, T* __restrict__ out,
            const int* __restrict__ pairs, int n_blocks, int h, int B) {
  const int p = blockIdx.x;
  const long long b = blockIdx.y;
  const int i = pairs[p], j = pairs[n_blocks + p];
  const T* src = mat + b * h * h;
  T* dst = out + (b * n_blocks + p) * B * B;
  for (int e = threadIdx.x; e < B * B; e += kThreads) {
    const int r = e / B, c = e % B;
    const int row = i * B + r, col = j * B + c;
    T v = T(0);
    if (row < h && col < h && !(i == j && c > r))
      v = src[(long long)row * h + col];
    dst[e] = v;
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

template <typename T>
static int pack(const void* mat, void* out, const void* pairs, int n_blocks,
                int batch, int h, int B, void* stream) {
  if (batch > 65535) return (int)cudaErrorInvalidValue;
  pack_kernel<T><<<dim3(n_blocks, batch), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(mat), static_cast<T*>(out),
      static_cast<const int*>(pairs), n_blocks, h, B);
  RT_RETURN_IF_ERROR();
  return 0;
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
// mat: (batch, h, h); out: (batch, n_blocks * B * B); pairs: (2, n_blocks)
// tile rows then tile columns of the lower tiles, tile-column-major.
int rt_pack_tril_f64(const void* mat, void* out, const void* pairs,
                     int n_blocks, int batch, int h, int B, void* stream) {
  return pack<double>(mat, out, pairs, n_blocks, batch, h, B, stream);
}
int rt_pack_tril_f32(const void* mat, void* out, const void* pairs,
                     int n_blocks, int batch, int h, int B, void* stream) {
  return pack<float>(mat, out, pairs, n_blocks, batch, h, B, stream);
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
