// Triangular solves L w = g, L^T w = g and L L^T w = g read directly from
// tile-packed factors, batched over factors, for Hopper.
//
// Replaces the Pallas kernel of src/repro/kernels/packed_trsm.py:166
// (solve_lower_packed, body _make_kernel :42, tile map _step_tile_indices
// :83) and solve_packed (:176, the forward call followed by the transposed
// one).  The TPU version walks a sequential (nt, nt) grid: the outer step is
// the tile row being solved, the inner step streams that row's tiles
// through a scalar-prefetched (s, u) -> packed-tile map, solved rows are
// read back from the revisited output ref, and the diagonal tiles are
// inverted outside the kernel (:112).  A packed factor is a degree-0
// interpolant (one coefficient plane, no λ), so here it is the cluster
// solve of tri_solve.cuh with the packed tile source (kPacked): a cluster
// of up to 8 blocks per (factor, RHS column), right-looking, tile (i, j)
// found at (j nt - j (j - 1) / 2 + i - j) B^2 of the factor (no map), the
// solved segments passed between the blocks through distributed shared
// memory, the tiles staged by cp.async ahead of the barriers, and the
// diagonal tiles read, identity-padded past h and inverted in the kernel's
// prologue.  solve_packed is one launch for both sweeps (sweeps = 3).
//
// The packed factor is zero on its padding, g is zero-padded to the tile
// multiple, and the identity tail keeps the padded solution rows at 0.
//
// Bound on this card: bytes (each packed value read once per sweep; 2 flops
// per value read), and the chain of nt dependent solves per sweep.
//
// The mixed-precision variants (packed_trsm.py under a bf16 compute dtype,
// :17-24, :61-80, :112-123): every product runs on the bf16 tensor cores
// with fp32 sums, the tiles, the solved segments, the inverses and
// g_i - acc_i rounded to bf16; the inverses (formed at fp32 from the
// factor's own values), g, the sums and the solution are float32.
// rt_packed_trsm_bf16 reads a bf16-stored factor (staged in bf16 by bulk
// copies, half the bytes); rt_packed_trsm_f32_bf16 a float32 factor, each
// staged chunk rounded once into a bf16 tile (tri_solve.cuh,
// tri_solve_mixed_kernel).

#include <cstdint>

#include "tri_solve.cuh"

template <typename T, typename CT = T, typename Src = T>
static int packed_trsm(const void* vec, const void* g, void* scratch,
                       void* out, int batch, int h, int B, int nrhs,
                       int sweeps, int* plan, void* stream) {
  if (sweeps < 1 || sweeps > 3) return (int)cudaErrorInvalidValue;
  SolveArgs<T, Src> a = {};
  a.src = static_cast<const Src*>(vec);
  a.scratch = static_cast<T*>(scratch);
  a.g = static_cast<const T*>(g);
  a.out = static_cast<T*>(out);
  a.h = h;
  a.nt = (h + B - 1) / B;
  a.P = (long long)a.nt * (a.nt + 1) / 2 * B * B;
  a.nc = 1;
  a.n_lam = 1;
  a.nrhs = nrhs;
  a.g_per_lam = 0;
  a.sweeps = sweeps;
  a.vec = reinterpret_cast<uintptr_t>(vec) % 16 == 0;   // P % 8 == 0
  if (sizeof(Src) < 4 && !a.vec) return (int)cudaErrorMisalignedAddress;
  return tri_solve_launch<T, kPacked, CT, Src>(a, B, (long long)batch * nrhs,
                                               plan,
                                               static_cast<cudaStream_t>(stream));
}

extern "C" {
// vec: (batch, P) packed factors; g, out: (batch, nt * B, nrhs), g
// zero-padded past h; sweeps: 1 L w = g, 2 L^T w = g, 3 both in turn
// (L L^T w = g); scratch: (batch * nrhs, nt, B, inv_ld) for the formed
// inverses of the diagonal tiles when they do not fit in shared memory, or
// null (then a launch that needs it returns kNeedsScratch and launches
// nothing); plan: null, or kPlanInts ints that receive the launch plan (as
// for rt_trsm_f64).
int rt_packed_trsm_f64(const void* vec, const void* g, void* scratch,
                       void* out, int batch, int h, int B, int nrhs,
                       int sweeps, int* plan, void* stream) {
  return packed_trsm<double>(vec, g, scratch, out, batch, h, B, nrhs, sweeps,
                             plan, stream);
}
int rt_packed_trsm_f32(const void* vec, const void* g, void* scratch,
                       void* out, int batch, int h, int B, int nrhs,
                       int sweeps, int* plan, void* stream) {
  return packed_trsm<float>(vec, g, scratch, out, batch, h, B, nrhs, sweeps,
                            plan, stream);
}
// a float32 factor, the products in bf16; g, scratch, out float32
int rt_packed_trsm_f32_bf16(const void* vec, const void* g, void* scratch,
                            void* out, int batch, int h, int B, int nrhs,
                            int sweeps, int* plan, void* stream) {
  return packed_trsm<float, __nv_bfloat16>(vec, g, scratch, out, batch, h, B,
                                           nrhs, sweeps, plan, stream);
}
// a bf16 factor (16-byte aligned), the products in bf16; g, scratch, out
// float32
int rt_packed_trsm_bf16(const void* vec, const void* g, void* scratch,
                        void* out, int batch, int h, int B, int nrhs,
                        int sweeps, int* plan, void* stream) {
  return packed_trsm<float, __nv_bfloat16, __nv_bfloat16>(
      vec, g, scratch, out, batch, h, B, nrhs, sweeps, plan, stream);
}
}
