#!/usr/bin/env python3
"""Probes of the cluster triangular solve (``csrc/tri_solve.cuh``) on one
CUDA card.

    python3 scripts/probe_tri_solve.py [barrier] [stamps]

``barrier`` the cost of one cluster barrier (``barrier.cluster.arrive`` +
            ``wait``) for clusters of 1, 2, 4 and 8 blocks of 256 threads,
            15 clusters at once, alone and after each block has stored 128
            float64 values into every block of its cluster through
            distributed shared memory (one solved tile row): ns per
            barrier from ``%globaltimer`` over 2000 barriers.
``stamps``  ``%globaltimer`` and ``clock64`` at every phase of the kernel
            for the 8 blocks of the first system: start, end of the
            prologue, and per step s before and after the cluster wait,
            after the look-ahead update, after the look-ahead solve and
            after the step's other updates; for the dense trsm (forward,
            15 × 1024², the kernel inverting the diagonal tiles) and
            ``interp_solve`` (Θ (5, 3, P), 3 λ), float64, B = 128: ns since
            the first stamp, per block, and the per-step summary (the
            owner's wait, update and solve).

Each probe compiles its source with the port's nvcc flags and headers into
``build/probe/`` (``stamps``: the kernels' own sources with the kernel's
``TRI_SOLVE_STAMP`` hook defined) and prints JSON lines; the card's
``nvidia-smi`` name and power limit come first.  No argument runs both.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.core import packing  # noqa: E402
from repro_torch.kernels import _build, poly_interp, trsm  # noqa: E402

OUT = ROOT / "build" / "probe"


def compile_lib(name: str, code: str) -> ctypes.CDLL:
    """``code`` as ``build/probe/<name>.cu``, compiled against the port's
    headers with its nvcc flags."""
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


BARRIER = r"""
#include <cooperative_groups.h>
#include "tri_solve.cuh"
__global__ void __launch_bounds__(kThreads, 1)
barrier_kernel(int n, int remote, unsigned long long* ns) {
  __shared__ double slot[128];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  cluster.sync();
  unsigned long long t0, t1;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t0));
  for (int k = 0; k < n; ++k) {
    if (remote && threadIdx.x < 128)
      for (int b = 0; b < C; ++b)
        *cluster.map_shared_rank(slot + threadIdx.x, b) = k + threadIdx.x;
    cluster_arrive();
    cluster_wait();
  }
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t1));
  if (threadIdx.x == 0) ns[blockIdx.x] = t1 - t0;
}
extern "C" int run(int C, int clusters, int n, int remote, void* ns, void* stream) {
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = C; attr.val.clusterDim.y = 1; attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C * clusters); cfg.blockDim = dim3(kThreads);
  cfg.stream = (cudaStream_t)stream; cfg.attrs = &attr; cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, barrier_kernel, n, remote,
                                 (unsigned long long*)ns);
}
"""


def stream() -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def probe_barrier() -> None:
    lib = compile_lib("barrier", BARRIER)
    lib.run.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2
    n = 2000
    for c in (1, 2, 4, 8):
        for remote in (0, 1):
            ns = torch.zeros(15 * c, dtype=torch.int64, device="cuda")
            for _ in range(2):                      # warm, then measured
                rc = lib.run(c, 15, n, remote, ctypes.c_void_p(ns.data_ptr()),
                             stream())
                torch.cuda.synchronize()
                if rc:
                    raise SystemExit(f"barrier probe: CUDA error {rc}")
            print(json.dumps(dict(probe="barrier", cluster=c, clusters=15,
                                  remote_stores=bool(remote),
                                  ns_per_barrier=float(ns.double().mean()) / n)),
                  flush=True)


# the kernel's stamp hook (TRI_SOLVE_STAMP in tri_solve.cuh), defined ahead
# of the source: thread 0 of each of the first 8 blocks records
# %globaltimer, clock64 and the tag
STAMP_DEFS = r"""
__device__ unsigned long long g_stamp[8][512][3];
__device__ int g_nstamp[8];
#define TRI_SOLVE_STAMP(tag) do { if (threadIdx.x == 0 && blockIdx.x < 8) { \
  unsigned long long gt_; asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(gt_)); \
  const int n_ = g_nstamp[blockIdx.x]++; if (n_ < 512) { \
    g_stamp[blockIdx.x][n_][0] = gt_; g_stamp[blockIdx.x][n_][1] = clock64(); \
    g_stamp[blockIdx.x][n_][2] = (tag); } } } while (0)
"""


STAMP_READ = r"""
extern "C" int read_stamps(void* dst, void* counts) {
  cudaError_t e = cudaMemcpyFromSymbol(dst, g_stamp, sizeof(g_stamp));
  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(counts, g_nstamp, sizeof(g_nstamp));
  return (int)e;
}
extern "C" int reset_stamps() {
  int zero[8] = {0};
  return (int)cudaMemcpyToSymbol(g_nstamp, zero, sizeof(zero));
}
"""


def summary(stamps: dict, nt: int, steps: range) -> list:
    """Per step: the owner of the next row's wait (ns), its look-ahead
    update and solve, and the slowest block's other updates."""
    rows = []
    for s in steps:
        def t(b, tag):
            return stamps[b].get(tag)
        nxt = (s + 1 if s + 1 < nt else 2 * nt - 2 - s) % 8
        wait = [t(b, 200 + s) - t(b, 100 + s) for b in stamps
                if t(b, 200 + s) is not None and t(b, 100 + s) is not None]
        row = dict(step=s, wait_ns_max=max(wait) if wait else None)
        if t(nxt, 400 + s) is not None:
            start = t(nxt, 200 + s)
            upd = t(nxt, 300 + s)
            row["lookahead_update_ns"] = None if upd is None else upd - start
            row["lookahead_solve_ns"] = t(nxt, 400 + s) - (upd or start)
        rest = [t(b, 500 + s) - t(b, 200 + s) for b in stamps
                if t(b, 500 + s) is not None and t(b, 200 + s) is not None]
        row["step_ns_max"] = max(rest) if rest else None
        rows.append(row)
    return rows


def probe_stamps() -> None:
    libs = {}
    for name in ("trsm", "poly_interp"):
        code = (STAMP_DEFS + (_build.CSRC / f"{name}.cu").read_text()
                + STAMP_READ)
        libs[name] = compile_lib(f"stamped_{name}", code)
        libs[name].read_stamps.argtypes = [ctypes.c_void_p] * 2
    dev = torch.device("cuda")
    h, block = 1024, 128
    nt = packing.num_tiles(h, block)
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(15, 2 * h, h, generator=gen, device=dev, dtype=torch.float64)
    l = torch.linalg.cholesky(x.mT @ x / h + torch.eye(h, device=dev,
                                                      dtype=torch.float64))
    del x
    g = torch.randn(15, h, 1, generator=gen, device=dev, dtype=torch.float64)
    v = packing.pack_tril(l, block)
    theta = torch.stack([v[:5], 0.1 * v[5:10], 0.01 * v[10:15]], 1).contiguous()
    lams = torch.tensor([1e-3, 3.2e-3, 1e-2], device=dev, dtype=torch.float64)
    x5 = lams.clone()
    hp = nt * block
    g5 = torch.randn(5, hp, 1, generator=gen, device=dev, dtype=torch.float64)
    # room for inverses out of shared memory, whichever plan is taken
    scratch = torch.empty(15, nt, block, block + 2, device=dev,
                          dtype=torch.float64)

    def launcher(fn, args, out):
        """The call (which keeps ``out`` alive), and the plan its first
        launch reports."""
        plan = (ctypes.c_int * len(_build.PLAN_KEYS))()

        def call(_out=out):
            return fn(*args, plan, stream())
        rc = call()
        torch.cuda.synchronize()
        if rc:
            raise SystemExit(f"stamps: CUDA error {rc}")
        return dict(zip(_build.PLAN_KEYS, plan)), call

    def trsm_call():
        fn = libs["trsm"].rt_trsm_f64
        fn.argtypes = trsm._ARGS
        out = torch.empty_like(g)
        return launcher(fn, (_build.ptr(l), _build.ptr(g),
                             _build.ptr(scratch), _build.ptr(out), 15, h,
                             block, 1, 0), out)

    def interp_call():
        fn = libs["poly_interp"].rt_interp_solve_f64
        fn.argtypes = poly_interp._ARGS
        out = torch.empty(5, 3, hp, 1, device=dev, dtype=torch.float64)
        return launcher(fn, (_build.ptr(theta), _build.ptr(x5),
                             _build.ptr(g5), _build.ptr(scratch),
                             _build.ptr(out), 5, 3, 2, nt, block,
                             theta.shape[-1], 1, 0, h), out)

    for tag, lib, (plan, call), steps in (
            ("trsm_forward", libs["trsm"], trsm_call(), range(nt)),
            ("interp_solve", libs["poly_interp"], interp_call(),
             range(2 * nt))):
        for _ in range(2):                       # warm, then stamped
            lib.reset_stamps()
            rc = call()
            torch.cuda.synchronize()
            if rc:
                raise SystemExit(f"{tag}: CUDA error {rc}")
        buf = torch.zeros(8, 512, 3, dtype=torch.int64)
        cnt = torch.zeros(8, dtype=torch.int32)
        lib.read_stamps(ctypes.c_void_p(buf.data_ptr()),
                        ctypes.c_void_p(cnt.data_ptr()))
        t0 = min(int(buf[b, 0, 0]) for b in range(8) if cnt[b] > 0)
        stamps = {b: {int(buf[b, k, 2]): int(buf[b, k, 0]) - t0
                      for k in range(min(int(cnt[b]), 512))}
                  for b in range(8) if cnt[b] > 0}
        print(json.dumps(dict(probe="stamps", kernel=tag, plan=plan,
                              prologue_end_ns={b: s.get(2) for b, s in
                                               stamps.items()},
                              end_ns=max(max(s.values()) for s in
                                         stamps.values()),
                              steps=summary(stamps, nt, steps))), flush=True)
        print(json.dumps(dict(probe="stamps_raw", kernel=tag,
                              stamps={b: sorted(s.items(), key=lambda kv: kv[1])
                                      for b, s in stamps.items()})), flush=True)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("probe_tri_solve.py needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    which = sys.argv[1:] or ["barrier", "stamps"]
    if "barrier" in which:
        probe_barrier()
    if "stamps" in which:
        probe_stamps()


if __name__ == "__main__":
    main()
