#!/usr/bin/env python3
"""Probes of the cluster triangular solve (``csrc/tri_solve.cuh``) on one
CUDA card.

    python3 scripts/probe_tri_solve.py [barrier] [stamps] [--csrc DIR]
                                       [--only NAME,...]

``barrier`` the cost of one cluster barrier (``barrier.cluster.arrive`` +
            ``wait``) for clusters of 1, 2, 4 and 8 blocks of 256 threads,
            15 clusters at once, alone and after each block has stored 128
            float64 values into every block of its cluster through
            distributed shared memory (one solved tile row): ns per
            barrier from ``%globaltimer`` over 2000 barriers.
``stamps``  ``%globaltimer`` and ``clock64`` at every phase of the kernel
            for the blocks of the first system: start, end of the
            prologue, and per step s before and after the cluster wait,
            after the look-ahead update, after the look-ahead solve and
            after the step's other updates; B = 128, h = 1024, for the
            one-dtype kernels in float64 (the dense trsm's forward launch,
            15 × 1024², the kernel inverting the diagonal tiles;
            ``interp_solve`` on Θ (5, 3, P) at 3 λ) and for the mixed
            (bf16 products, float32 sums) instantiations at the main
            path's bf16 shapes (``interp_solve`` on a bf16 Θ (5, 3, P) at
            14 λ, row 6m; the dense trsm's forward and transposed launch
            on 70 float32 factors of 1024², row 8m): ns since the first
            stamp, per block, the prologue's share of the run, and the
            per-step summary (the owner's wait, update and solve; every
            block's other updates per tile).

``--csrc DIR`` stamps the kernel sources in DIR (e.g. the parent's
``build/parent/src/repro_torch/kernels/csrc`` from ``git archive``) in
place of this checkout's, and ``--only NAME,...`` keeps some of the cases
(``trsm_forward``, ``interp_solve``, ``interp_solve_bf16``,
``trsm_bf16_forward``, ``trsm_bf16_transposed``); every line carries the
sources it ran (``source``).

Each probe compiles its source with the port's nvcc flags and headers into
``build/probe/`` (``stamps``: the kernels' own sources with the kernel's
``TRI_SOLVE_STAMP`` hook defined) and prints JSON lines; the card's
``nvidia-smi`` name and power limit come first.  No argument runs both.
"""
from __future__ import annotations

import argparse
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


def compile_lib(name: str, code: str, csrc: Path = _build.CSRC
                ) -> ctypes.CDLL:
    """``code`` as ``build/probe/<name>.cu``, compiled against the headers
    in ``csrc`` (the port's own by default) with the port's nvcc flags."""
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / f"{name}.cu").write_text(code)
    lib = OUT / f"lib{name}.so"
    r = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I",
                        str(csrc), "-o", str(lib),
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
constexpr int kStamps = 2048;
__device__ unsigned long long g_stamp[8][kStamps][3];
__device__ int g_nstamp[8];
#define TRI_SOLVE_STAMP(tag) do { if (threadIdx.x == 0 && blockIdx.x < 8) { \
  unsigned long long gt_; asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(gt_)); \
  const int n_ = g_nstamp[blockIdx.x]++; if (n_ < kStamps) { \
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


def summary(stamps: dict, nt: int, steps: range, cluster: int) -> list:
    """Per step: the owner of the next row's wait (ns), its look-ahead
    update and solve, the slowest block's other updates, and the other
    updates per tile (every block that updated a tile at that step but
    was not the next row's owner)."""
    rows = []
    for s in steps:
        def t(b, tag):
            return stamps[b].get(tag)
        i = s if s < nt else 2 * nt - 1 - s
        nxt = (s + 1 if s + 1 < nt else 2 * nt - 2 - s) % cluster
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
        per_tile = []
        for b in stamps:
            if b == nxt or t(b, 500 + s) is None or t(b, 200 + s) is None:
                continue
            mine = [j for j in range(b, nt, cluster)
                    if (j > i if s < nt - 1 else s >= nt and j < i)]
            if mine:
                per_tile.append((t(b, 500 + s) - t(b, 200 + s)) / len(mine))
        row["other_update_ns_per_tile"] = (sum(per_tile) / len(per_tile)
                                           if per_tile else None)
        rows.append(row)
    return rows


N_STAMPS = 2048


def prologue_rows(stamps: dict) -> list:
    """Block 0's prologue per diagonal tile it owns (the mixed kernel's
    stamps 10 + 3k, 11 + 3k, 12 + 3k): ns to read, invert and store it."""
    s, out, prev = stamps.get(0, {}), [], stamps.get(0, {}).get(1)
    for k in range(8):
        if 10 + 3 * k not in s:
            break
        out.append(dict(read_ns=s[10 + 3 * k] - prev,
                        invert_ns=s[11 + 3 * k] - s[10 + 3 * k],
                        store_ns=s[12 + 3 * k] - s[11 + 3 * k]))
        prev = s[12 + 3 * k]
    return out


def chunk_phases(seq: dict) -> dict:
    """The mixed kernel's chunks (stamps 600, 601, 602, 603 in turn), over
    every stamped block: their count and mean ns waiting for the chunk,
    turning it into a tile (with the barrier) and refilling the stage and
    multiplying (warp 0)."""
    tot, n = {"wait": 0, "to_tile": 0, "multiply": 0}, 0
    for s in seq.values():
        for k in range(len(s) - 3):
            tags = [s[k + u][0] for u in range(4)]
            if tags == [600, 601, 602, 603]:
                tot["wait"] += s[k + 1][1] - s[k][1]
                tot["to_tile"] += s[k + 2][1] - s[k + 1][1]
                tot["multiply"] += s[k + 3][1] - s[k + 2][1]
                n += 1
    return dict(count=n, **{f"{k}_ns": v / n for k, v in tot.items()}) \
        if n else {}


CASES = ("trsm_forward", "interp_solve", "interp_solve_bf16",
         "trsm_bf16_forward", "trsm_bf16_transposed")


def probe_stamps(csrc: Path, only) -> None:
    libs = {}
    for name in ("trsm", "poly_interp"):
        code = STAMP_DEFS + (csrc / f"{name}.cu").read_text() + STAMP_READ
        libs[name] = compile_lib(f"stamped_{name}", code, csrc)
        libs[name].read_stamps.argtypes = [ctypes.c_void_p] * 2
    dev = torch.device("cuda")
    f64, f32, bf = torch.float64, torch.float32, torch.bfloat16
    h, block = 1024, 128
    nt = packing.num_tiles(h, block)
    hp = nt * block
    gen = torch.Generator(device=dev).manual_seed(0)
    eye = torch.eye(h, device=dev, dtype=f64)
    # 70 SPD matrices (the bf16 exact sweep's chunk), their factors; the
    # first 15 are the float64 cases'
    ls = []
    for _ in range(5):
        x = torch.randn(14, 2 * h, h, generator=gen, device=dev, dtype=f64)
        ls.append(torch.linalg.cholesky(x.mT @ x / h + eye))
        del x
    l70 = torch.cat(ls).contiguous()
    del ls
    l = l70[:15].contiguous()
    l32 = l70.float().contiguous()
    g = torch.randn(15, h, 1, generator=gen, device=dev, dtype=f64)
    g70 = torch.randn(70, h, 1, generator=gen, device=dev, dtype=f32)
    v = packing.pack_tril(l, block)
    theta = torch.stack([v[:5], 0.1 * v[5:10], 0.01 * v[10:15]], 1).contiguous()
    theta_bf = theta.to(bf)
    lams = torch.tensor([1e-3, 3.2e-3, 1e-2], device=dev, dtype=f64)
    x5 = lams.clone()
    x14 = torch.logspace(-3, -1, 14, device=dev, dtype=f32)
    g5 = torch.randn(5, hp, 1, generator=gen, device=dev, dtype=f64)
    g5_32 = g5.float()
    # room for inverses out of shared memory, whichever plan is taken
    scratch = torch.empty(70, nt, block, block + 4, device=dev, dtype=f64)

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

    def trsm_call(entry, lf, rhs, transpose):
        fn = getattr(libs["trsm"], entry)
        fn.argtypes = trsm._ARGS
        out = torch.empty_like(rhs)
        return launcher(fn, (_build.ptr(lf), _build.ptr(rhs),
                             _build.ptr(scratch), _build.ptr(out),
                             lf.shape[0], h, block, 1, transpose), out)

    def interp_call(entry, th, xs, rhs):
        fn = getattr(libs["poly_interp"], entry)
        fn.argtypes = poly_interp._ARGS
        out = torch.empty(5, xs.numel(), hp, 1, device=dev, dtype=rhs.dtype)
        return launcher(fn, (_build.ptr(th), _build.ptr(xs),
                             _build.ptr(rhs), _build.ptr(scratch),
                             _build.ptr(out), 5, xs.numel(), 2, nt, block,
                             th.shape[-1], 1, 0, h), out)

    cases = dict(
        trsm_forward=("trsm", lambda: trsm_call("rt_trsm_f64", l, g, 0),
                      range(nt)),
        interp_solve=("poly_interp",
                      lambda: interp_call("rt_interp_solve_f64", theta, x5,
                                          g5), range(2 * nt)),
        interp_solve_bf16=("poly_interp",
                           lambda: interp_call("rt_interp_solve_f32_bf16",
                                               theta_bf, x14, g5_32),
                           range(2 * nt)),
        trsm_bf16_forward=("trsm",
                           lambda: trsm_call("rt_trsm_f32_bf16", l32, g70, 0),
                           range(nt)),
        trsm_bf16_transposed=("trsm",
                              lambda: trsm_call("rt_trsm_f32_bf16", l32, g70,
                                                1), range(nt, 2 * nt)))
    for tag, (lib_name, make, steps) in cases.items():
        if only and tag not in only:
            continue
        lib = libs[lib_name]
        plan, call = make()
        for _ in range(2):                       # warm, then stamped
            lib.reset_stamps()
            rc = call()
            torch.cuda.synchronize()
            if rc:
                raise SystemExit(f"{tag}: CUDA error {rc}")
        buf = torch.zeros(8, N_STAMPS, 3, dtype=torch.int64)
        cnt = torch.zeros(8, dtype=torch.int32)
        lib.read_stamps(ctypes.c_void_p(buf.data_ptr()),
                        ctypes.c_void_p(cnt.data_ptr()))
        C = plan["cluster"]
        t0 = min(int(buf[b, 0, 0]) for b in range(C) if cnt[b] > 0)
        seq = {b: [(int(buf[b, k, 2]), int(buf[b, k, 0]) - t0)
                   for k in range(min(int(cnt[b]), N_STAMPS))]
               for b in range(C) if cnt[b] > 0}
        stamps = {b: dict(s) for b, s in seq.items()}
        end = max(max(s.values()) for s in stamps.values())
        pro = [s[2] for s in stamps.values() if 2 in s]
        print(json.dumps(dict(probe="stamps", kernel=tag, source=str(csrc),
                              plan=plan,
                              prologue_end_ns={b: s.get(2) for b, s in
                                               stamps.items()},
                              end_ns=end,
                              prologue_share=max(pro) / end if pro else None,
                              prologue_rows=prologue_rows(stamps),
                              chunks=chunk_phases(seq),
                              steps=summary(stamps, nt, steps, C))),
              flush=True)
        print(json.dumps(dict(probe="stamps_raw", kernel=tag,
                              source=str(csrc),
                              stamps={b: sorted(s.items(), key=lambda kv: kv[1])
                                      for b, s in stamps.items()})), flush=True)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("probe_tri_solve.py needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    ap = argparse.ArgumentParser()
    ap.add_argument("which", nargs="*", default=["barrier", "stamps"])
    ap.add_argument("--csrc", type=Path, default=_build.CSRC)
    ap.add_argument("--only", default="")
    args = ap.parse_args()
    only = {c for c in args.only.split(",") if c}
    if only - set(CASES):
        raise SystemExit(f"--only: unknown cases {sorted(only - set(CASES))}")
    if "barrier" in args.which:
        probe_barrier()
    if "stamps" in args.which:
        probe_stamps(args.csrc.resolve(), only)


if __name__ == "__main__":
    main()
