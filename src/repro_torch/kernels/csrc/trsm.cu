// Blocked triangular solve L w = g / L^T w = g on dense factors, batched
// over factors, for Hopper.
//
// Replaces the Pallas kernel of src/repro/kernels/trsm.py:102
// (solve_lower_blocked, body _make_solve_kernel :24).  The TPU version
// revisits its output ref as solved state across a sequential grid over
// tile rows, with the diagonal tiles inverted outside the kernel
// (trsm.py:89-94).  Here the cluster solve of tri_solve.cuh runs one sweep
// per launch: a cluster of up to 8 blocks per (factor, RHS column), each
// block owning every C-th tile row, right-looking updates (a warp per row
// of L for the forward sweep; consecutive threads on consecutive columns
// of L for the transposed one), the solved segments passed between the
// blocks through distributed shared memory, L's tiles staged by cp.async
// ahead of the barriers, and the diagonal tiles read and inverted in the
// kernel's prologue.
//
// The factor is read unpadded (h, h); rows and columns past h are
// zero-filled in shared memory, and the identity tail of the last diagonal
// tile keeps the padded rows at zero.
//
// Bound on this card: bytes (the lower triangle of each factor read once
// per sweep; 2 flops per value read), and the chain of nt dependent solves.
//
// rt_trsm_f32_bf16 is the mixed-precision variant (trsm.py:42-51 under a
// bf16 compute dtype): L and the solution are float32, and every product
// runs on the bf16 tensor cores with fp32 sums, L_ji and the solved w_i,
// the inverse and g_i - acc_i rounded to bf16 (tri_solve.cuh,
// tri_solve_mixed_kernel: each staged chunk of L rounded once into a bf16
// tile, the inverses formed at fp32 and kept in bf16, two blocks an SM).
// It reads the float32 factor as the float32 kernel does, so its bound
// (bytes) and its chain are that kernel's.

#include <cstdint>

#include "tri_solve.cuh"

template <typename T, typename CT = T>
static int trsm(const void* l, const void* g, void* scratch, void* out,
                int batch, int h, int B, int nrhs, int transpose, int* plan,
                void* stream) {
  SolveArgs<T> a = {};
  a.src = static_cast<const T*>(l);
  a.scratch = static_cast<T*>(scratch);
  a.g = static_cast<const T*>(g);
  a.out = static_cast<T*>(out);
  a.h = h;
  a.nt = (h + B - 1) / B;
  a.nc = 1;
  a.n_lam = 1;
  a.nrhs = nrhs;
  a.sweeps = transpose ? 2 : 1;
  a.vec = reinterpret_cast<uintptr_t>(l) % 16 == 0 && h % (16 / sizeof(T)) == 0;
  return tri_solve_launch<T, kDense, CT>(a, B, (long long)batch * nrhs, plan,
                                         static_cast<cudaStream_t>(stream));
}

extern "C" {
// l: (batch, h, h) lower factors; g, out: (batch, h, nrhs); scratch:
// (batch * nrhs, nt, B, inv_ld) for the formed inverses of the diagonal
// tiles when they do not fit in shared memory, or null (then a launch that
// needs it returns kNeedsScratch and launches nothing); plan: null, or
// kPlanInts ints that receive the launch plan (cluster size, the
// occupancy's active clusters at it, rows per block, inverses in shared
// memory, shared bytes, ring stages, rows per chunk).
int rt_trsm_f64(const void* l, const void* g, void* scratch, void* out,
                int batch, int h, int B, int nrhs, int transpose, int* plan,
                void* stream) {
  return trsm<double>(l, g, scratch, out, batch, h, B, nrhs, transpose, plan,
                      stream);
}
int rt_trsm_f32(const void* l, const void* g, void* scratch, void* out,
                int batch, int h, int B, int nrhs, int transpose, int* plan,
                void* stream) {
  return trsm<float>(l, g, scratch, out, batch, h, B, nrhs, transpose, plan,
                     stream);
}
// the same arguments, float32 throughout; the products in bf16
int rt_trsm_f32_bf16(const void* l, const void* g, void* scratch, void* out,
                     int batch, int h, int B, int nrhs, int transpose,
                     int* plan, void* stream) {
  return trsm<float, __nv_bfloat16>(l, g, scratch, out, batch, h, B, nrhs,
                                    transpose, plan, stream);
}
}
