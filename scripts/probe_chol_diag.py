#!/usr/bin/env python3
"""Probes of the blocked Cholesky's diagonal step on one CUDA card.

    python3 scripts/probe_chol_diag.py [mma] [potf2] [stamps]

``mma``     rate of the FP64 tensor-core ``mma.sync`` shapes m8n8k4,
            m16n8k4 and m16n8k8: 8 warps per block, 2 to 8 blocks per SM,
            independent accumulators, TFLOP/s.
``potf2``   cycles per call of ``warp_potf2_inv`` (one warp factors and
            inverts a 16 x 16 block, ``csrc/tri_solve.cuh``) and of three
            variants: without the inverse, with ``sqrt`` and a divide in
            place of ``rsqrt``, with the shuffles issued after the ``rsqrt``;
            then the latency of a dependent ``__shfl_sync``, ``rsqrt`` (+ an
            add) and DFMA in cycles.
``stamps``  ``clock64`` at every block barrier (and around the look-ahead
            potf2) of the diagonal step at B = 128, block 0, second tile
            column (the one that applies the look-ahead update), in a
            20 x 1024² call: cycles since the first stamp.  Two
            instantiations, one line each: ``<double, 128>`` (float64) and
            ``<float, 128, __nv_bfloat16>`` (the mixed variant: float32
            state, bf16 products), its scratch as the wrapper allocates it.

Each probe compiles a patched copy of the kernel source with the port's
nvcc flags into ``build/probe/`` and prints JSON lines; the card's
``nvidia-smi`` name and power limit come first.  No argument runs all
three.
"""
from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import _build  # noqa: E402

OUT = ROOT / "build" / "probe"
SRC = (_build.CSRC / "chol_blocked.cu").read_text()


def compile_lib(name: str, code: str) -> ctypes.CDLL:
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / f"{name}.cu").write_text(code)
    lib = OUT / f"lib{name}.so"
    r = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I",
                        str(_build.CSRC), "-o", str(lib),
                        str(OUT / f"{name}.cu")], capture_output=True,
                       text=True)
    if r.returncode:
        raise SystemExit(f"nvcc failed for {name}:\n{r.stderr[-4000:]}")
    return ctypes.CDLL(str(lib))


def stream() -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def timed_ms(fn, reps: int = 3) -> float:
    fn()
    torch.cuda.synchronize()
    s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    s.record()
    for _ in range(reps):
        fn()
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e) / reps


MMA = r"""
#include <cuda_runtime.h>
#define MMA884 "mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0,%1}, {%2}, {%3}, {%0,%1};\n"
#define MMA1684 "mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};\n"
#define MMA1688 "mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
__global__ void k884(double* out, int iters) {
  double a = threadIdx.x * 1e-3, b = 1.0 + threadIdx.x * 1e-4, d[8][2] = {};
  for (int it = 0; it < iters; ++it)
#pragma unroll
    for (int j = 0; j < 8; ++j)
      asm volatile(MMA884 : "+d"(d[j][0]), "+d"(d[j][1]) : "d"(a), "d"(b));
  double s = 0;
  for (int j = 0; j < 8; ++j) s += d[j][0] + d[j][1];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
__global__ void k1684(double* out, int iters) {
  double a0 = threadIdx.x * 1e-3, a1 = 0.5, b = 1.0 + threadIdx.x * 1e-4, d[4][4] = {};
  for (int it = 0; it < iters; ++it)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      asm volatile(MMA1684 : "+d"(d[j][0]), "+d"(d[j][1]), "+d"(d[j][2]), "+d"(d[j][3])
                   : "d"(a0), "d"(a1), "d"(b));
  double s = 0;
  for (int j = 0; j < 4; ++j) s += d[j][0] + d[j][1] + d[j][2] + d[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
__global__ void k1688(double* out, int iters) {
  double a0 = threadIdx.x * 1e-3, a1 = 0.5, a2 = 0.25, a3 = 0.125;
  double b0 = 1.0 + threadIdx.x * 1e-4, b1 = 0.75, d[4][4] = {};
  for (int it = 0; it < iters; ++it)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      asm volatile(MMA1688 : "+d"(d[j][0]), "+d"(d[j][1]), "+d"(d[j][2]), "+d"(d[j][3])
                   : "d"(a0), "d"(a1), "d"(a2), "d"(a3), "d"(b0), "d"(b1));
  double s = 0;
  for (int j = 0; j < 4; ++j) s += d[j][0] + d[j][1] + d[j][2] + d[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int rt_mma(int which, double* out, int blocks, int iters, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (which == 0) k884<<<blocks, 256, 0, s>>>(out, iters);
  if (which == 1) k1684<<<blocks, 256, 0, s>>>(out, iters);
  if (which == 2) k1688<<<blocks, 256, 0, s>>>(out, iters);
  return (int)cudaGetLastError();
}
"""


def probe_mma() -> None:
    lib = compile_lib("mma_rate", MMA)
    lib.rt_mma.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                           ctypes.c_int, ctypes.c_void_p]
    out = torch.empty(132 * 8 * 256, dtype=torch.float64, device="cuda")
    iters = 4096
    # flops per warp per iteration: (independent mmas) x m x n x k x 2
    shapes = (("m8n8k4", 8 * 8 * 8 * 4 * 2), ("m16n8k4", 4 * 16 * 8 * 4 * 2),
              ("m16n8k8", 4 * 16 * 8 * 8 * 2))
    for which, (name, flop) in enumerate(shapes):
        for blocks in (132 * 2, 132 * 4, 132 * 8):
            ms = timed_ms(lambda: lib.rt_mma(which, ctypes.c_void_p(
                out.data_ptr()), blocks, iters, stream()))
            print(json.dumps(dict(probe="mma", shape=name, blocks=blocks,
                                  ms=ms, tflops=blocks * 8 * iters * flop
                                  / ms / 1e9)), flush=True)


def potf2_variants() -> dict:
    tri = (_build.CSRC / "tri_solve.cuh").read_text()
    head = "template <typename T, int LD, bool Factor = true>\n__device__ void " \
        "warp_potf2_inv("
    fn = tri[tri.index(head):tri.index("// =====", tri.index(head))]
    shuffles_first = fn[fn.index("    // every shuffle first"):
                        fn.index("      for (int q = k / 2; q < 8; ++q) "
                                 "lr[q] *= rp;")]
    shuffles_after = """    const T d = __shfl_sync(0xffffffffu, v[k >> 1], k + 16 * (k & 1));
    const T xk0 = T(0);
    T lr[8];
    if constexpr (Factor) {
      const T rp = rsqrt(d), piv = d * rp;
      const T lc = __shfl_sync(0xffffffffu, v[k >> 1], owner) * rp;
      const T xk = __shfl_sync(0xffffffffu, w[k >> 1], owner) * rp;
#pragma unroll
      for (int q = k / 2; q < 8; ++q)
        lr[q] = __shfl_sync(0xffffffffu, v[q], k + 16 * half);
"""
    rsq = "const T rp = rsqrt(d), piv = d * rp;"
    out = {"kernel": fn,
           "no_inverse": fn.replace("          w[q] -= lr[q] * xk;\n", "")
           .replace("          w[q] = xk;\n", ""),
           "sqrt_divide": fn.replace(rsq, "const T piv = sqrt(d); "
                                          "const T rp = T(1) / piv;"),
           "shuffles_after_rsqrt": fn.replace(shuffles_first,
                                              shuffles_after)}
    for name, body in out.items():
        if name != "kernel" and body == fn:
            raise SystemExit(f"potf2 variant {name}: the source changed")
        out[name] = body.replace("warp_potf2_inv(", f"potf2_{name}(")
    return out


def probe_potf2() -> None:
    variants = potf2_variants()
    code = ('#include "tri_solve.cuh"\nnamespace {\n'
            + "".join(variants.values()) + "}\n")
    for name in variants:
        code += f"""
__global__ void bench_{name}(const double* in, long long* cyc, double* out,
                             int reps) {{
  __shared__ double s[16 * 20], b[16 * 20], x[16 * 20];
  for (int e = threadIdx.x; e < 256; e += 32) b[e / 16 * 20 + e % 16] = in[e];
  __syncwarp();
  long long t0 = 0;
  for (int it = 0; it <= reps; ++it) {{
    if (it == 1) t0 = clock64();
    for (int e = threadIdx.x; e < 256; e += 32)
      s[e / 16 * 20 + e % 16] = b[e / 16 * 20 + e % 16];
    __syncwarp();
    potf2_{name}<double, 20>(s, x);
    __syncwarp();
  }}
  const long long t1 = clock64();
  if (threadIdx.x == 0) cyc[0] = (t1 - t0) / reps;
  for (int e = threadIdx.x; e < 256; e += 32) {{
    out[e] = s[e / 16 * 20 + e % 16];
    out[256 + e] = x[e / 16 * 20 + e % 16];
  }}
}}
extern "C" int run_{name}(const double* in, long long* cyc, double* out,
                          int reps) {{
  bench_{name}<<<1, 32>>>(in, cyc, out, reps);
  return (int)cudaDeviceSynchronize();
}}
"""
    code += r"""
__global__ void latency(double* out, long long* cyc, int n, int which) {
  double x = 1.0 + threadIdx.x * 1e-9;
  const long long t0 = clock64();
  for (int i = 0; i < n; ++i) {
    if (which == 0) x = __shfl_sync(0xffffffffu, x, (threadIdx.x + 1) & 31);
    else if (which == 1) x = rsqrt(x) + 0.5;
    else x = fma(x, 0.999999, 1e-7);
  }
  const long long t1 = clock64();
  out[threadIdx.x] = x;
  if (threadIdx.x == 0) cyc[0] = (t1 - t0) / n;
}
extern "C" int run_latency(double* out, long long* cyc, int n, int which) {
  latency<<<1, 32>>>(out, cyc, n, which);
  return (int)cudaDeviceSynchronize();
}
"""
    lib = compile_lib("potf2", code)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(32, 16, generator=gen, dtype=torch.float64, device=dev)
    a = (x.T @ x / 16 + torch.eye(16, dtype=torch.float64, device=dev)
         ).contiguous()
    l_ref = torch.linalg.cholesky(a)
    eye = torch.eye(16, dtype=torch.float64, device=dev)
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())  # noqa: E731
    for name in variants:
        cyc = torch.zeros(1, dtype=torch.int64, device=dev)
        out = torch.zeros(512, dtype=torch.float64, device=dev)
        f = getattr(lib, f"run_{name}")
        f.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int]
        rc = f(ptr(a), ptr(cyc), ptr(out), 200)
        l, xi = out[:256].view(16, 16), out[256:].view(16, 16)
        rec = dict(probe="potf2", variant=name, rc=rc,
                   cycles_per_call=int(cyc.item()),
                   l_err=float((l - l_ref).abs().max()))
        if name != "no_inverse":
            rec["x_l_minus_i"] = float((xi @ l_ref - eye).abs().max())
        print(json.dumps(rec), flush=True)
    lib.run_latency.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                ctypes.c_int, ctypes.c_int]
    for which, name in enumerate(("shfl", "rsqrt_add", "dfma")):
        cyc = torch.zeros(1, dtype=torch.int64, device=dev)
        out = torch.zeros(32, dtype=torch.float64, device=dev)
        lib.run_latency(ptr(out), ptr(cyc), 1000, which)
        print(json.dumps(dict(probe="latency", op=name,
                              cycles=int(cyc.item()))), flush=True)


#: the instantiations ``stamps`` runs: C entry, input dtype, compute dtype,
#: and the kernel's (T, CT) as the stamp's condition tests them
STAMPED = (("rt_chol_blocked_f64", torch.float64, None,
            "sizeof(T) == 8"),
           ("rt_chol_blocked_f32_bf16", torch.float32, torch.bfloat16,
            "sizeof(T) == 4 && sizeof(CT) == 2"))


def probe_stamps() -> None:
    from repro_torch.kernels import chol_blocked, ref
    head, rest = SRC.split("diag_kernel(const T* src", 1)
    body, tail = rest.split("// ----", 1)
    body = re.sub(r"__syncthreads\(\);",
                  lambda m: m.group(0) + f" STAMP({m.start()});", body)
    look = "warp_potf2_inv<T, LD>(col + kNb * LD + kNb, xpp + kNb * kLdSub);"
    if look not in body:
        raise SystemExit("stamps: the source changed")
    body = body.replace(look, "STAMP(-1); " + look + " STAMP(-2);")
    want = " : ".join(f"g_want == {i} ? ({cond})"
                      for i, (*_, cond) in enumerate(STAMPED)) + " : false"
    stamp = (
        "__device__ long long g_stamp[256][2];\n__device__ int g_count;\n"
        "__device__ int g_want;\n"
        "#define STAMP(tag) do { if (threadIdx.x == 0 && blockIdx.x == 0 && "
        f"lo == B && B == 128 && ({want})) {{ const int n_ = g_count++; "
        "if (n_ < 256) { g_stamp[n_][0] = clock64(); g_stamp[n_][1] = tag; } "
        "} } while (0)\n")
    code = (head.replace("namespace {", stamp + "namespace {", 1)
            + "diag_kernel(const T* src" + body + "// ----" + tail + r"""
extern "C" int rt_reset_stamps(int want) {
  const int zero = 0;
  cudaMemcpyToSymbol(g_count, &zero, sizeof(int));
  cudaMemcpyToSymbol(g_want, &want, sizeof(int));
  return (int)cudaDeviceSynchronize();
}
extern "C" int rt_read_stamps(long long* out, int* count) {
  cudaMemcpyFromSymbol(out, g_stamp, sizeof(g_stamp));
  cudaMemcpyFromSymbol(count, g_count, sizeof(int));
  return (int)cudaDeviceSynchronize();
}
""")
    # barrier sites, in source order, named by what finishes there
    sites = sorted(int(m.group(1)) for m in re.finditer(r"STAMP\((\d+)\)",
                                                       body))
    lib = compile_lib("chol_stamps", code)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(20, 2048, 1024, generator=gen, device=dev,
                    dtype=torch.float64)
    a64 = (x.mT @ x / 1024 + torch.eye(1024, device=dev, dtype=torch.float64)
           ).contiguous()
    del x
    for i, (entry, dtype, cd, _) in enumerate(STAMPED):
        a = a64.to(dtype)
        work = torch.empty_like(a)
        # the scratch the wrapper gives this variant at B = 128 (float32
        # where the wrapper has no ``scratch``: the design before wgmma)
        if hasattr(chol_blocked, "scratch"):
            inv, w = chol_blocked.scratch(a, 20, 1024, 128, cd)
        else:
            inv, w = a.new_empty((20, 128, 128)), a.new_empty((20, 1024, 128))
        fn = getattr(lib, entry)
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
                       + [ctypes.POINTER(ctypes.c_int), ctypes.c_void_p])
        lib.rt_reset_stamps(i)
        launched = ctypes.c_int(0)
        rc = fn(*(ctypes.c_void_p(t.data_ptr()) for t in (a, work, inv, w)),
                20, 1024, 128, ctypes.byref(launched), stream())
        torch.cuda.synchronize()
        err = float((work - ref.cholesky_blocked(a, 128, cd)).abs().max())
        st = (ctypes.c_longlong * 512)()
        count = ctypes.c_int(0)
        lib.rt_read_stamps(st, ctypes.byref(count))
        n = min(count.value, 256)
        t0 = st[0]
        seq = [(sites.index(st[2 * k + 1]) if st[2 * k + 1] >= 0
                else ("potf2_start" if st[2 * k + 1] == -1 else "potf2_end"),
                st[2 * k] - t0) for k in range(n)]
        print(json.dumps(dict(probe="stamps", entry=entry, rc=rc,
                              launches=launched.value,
                              max_abs_err_vs_plain=err,
                              barrier_sites=len(sites), stamps=seq)),
              flush=True)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("probe_chol_diag.py needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0],
          flush=True)
    probes = dict(mma=probe_mma, potf2=probe_potf2, stamps=probe_stamps)
    for name in sys.argv[1:] or list(probes):
        probes[name]()


if __name__ == "__main__":
    main()
