#!/usr/bin/env python3
"""A/B of the mixed-precision blocked Cholesky's designs on one CUDA card.

    python3 scripts/ab_chol_mixed.py [--rounds N] [--only NAME,...]

The mixed variant (``rt_chol_blocked_f32_bf16``: float32 state, bf16
products) built from this checkout's ``csrc/chol_blocked.cu`` with the
port's nvcc flags into ``build/ab_chol_mixed/``, in several designs:

``wgmma``     the source as it is: at B = 64 and 128 every operand rounded
              to bf16 once where it is stored, the strips brought in by the
              tensor memory accelerator and multiplied by ``wgmma``
              (``mma_sync`` at B = 16, 32);
``mma_sync``  the same source built with ``-DCHOL_MIXED_MMA_SYNC=1``: the
              design before wgmma at every B (float32 operands staged 16
              columns at a time, rounded as each ``mma.sync`` fragment is
              formed);
and the variants of :data:`VARIANTS`, each the wgmma design with a text
substitution of the source: ``diag_16_warps`` (the diagonal step on 16
warps), ``diag_tf32x3`` (its in-tile float32 products as a three-term TF32
split on ``mma.sync`` m16n8k8), ``inverse_doubling`` (its inverse by
recursive doubling in place of block rows: fewer barriers, other float32
roundings), ``no_prefetch`` (the trailing update's C not asked into L2
ahead), ``panel_tile_rows`` (a panel block a whole tile row) and
``diag_on_side`` (the diagonal step on the high-priority look-ahead stream
after an event, the trailing update on the caller's stream, as the
one-dtype kernels run them); ``first_wgmma`` (the design as first built)
is ``no_prefetch``, ``panel_tile_rows`` and ``diag_on_side`` together.

Shapes: 20 × 1024², B = 128 (the main path's anchor batch) and 20 × 144²,
B = 32 (the Table-4 fixture's anchors, ragged), SPD float32 matrices
(xᵀx/h + I from a seeded generator).  Each design is first held to the
plain version (``kernels.ref.cholesky_blocked`` with bf16 products, on the
card): max |Δ| / max |plain| within ``chip_smoke.MIXED_TOL`` and the same
bits on two calls (``bits_as_mma_sync`` says whether it gives the
``mma_sync`` build's bits); and its diagonal step alone (one 128 × 128 tile): the
float32 factor within ``chip_smoke.TOL[float32]`` of
``kernels.ref.factor_diag_tile`` (float64), the inverse it stores within
2^-8 (a bf16 rounding).  A design that fails is not timed.  Then every design is
timed in turns (CUDA events, mean of 20 calls after a warm-up), the order
reversed every other round.  Output, one JSON line each: the card's
``nvidia-smi`` name and power limit first (a plain line); per design and
shape its check; per timed run its ms; per design and shape the
``by_kernel`` split of one profiled call (``diag_kernel``, ``panel_kernel``,
``syrk_kernel``: device ms and launches), the ``ptxas`` lines
(registers, spills) of its mixed kernels at that block and the call's
``timeline`` (each kernel's start and end in µs from the first start);
last the median ms per design and shape.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

from repro_torch.core import packing  # noqa: E402
from repro_torch.kernels import _build, chol_blocked, ref  # noqa: E402

OUT = ROOT / "build" / "ab_chol_mixed"
SRC = (_build.CSRC / "chol_blocked.cu").read_text()
SHAPES = ((20, 1024, 128), (20, 144, 32))
CHOL_KERNELS = ("diag_kernel", "panel_kernel", "syrk_kernel")


def in_diag(old: str, new: str):
    """A substitution inside ``diag_kernel``'s body only."""
    def sub(code: str) -> str:
        head, rest = code.split("diag_kernel(const T* src", 1)
        body, tail = rest.split("// ----", 1)
        if old not in body:
            raise SystemExit(f"the source changed: {old[:60]!r}")
        return head + "diag_kernel(const T* src" + body.replace(old, new) \
            + "// ----" + tail
    return sub


# 16 warps for the diagonal step of the wgmma design (B = 128: 8 sub-block
# columns; the look-ahead product on the first two warpgroups)
WARPS16 = [
    ("__global__ void __launch_bounds__(kThreads)\ndiag_kernel(",
     "__global__ void __launch_bounds__(kWgmma<T, B, CT> ? 2 * kThreads : "
     "kThreads)\ndiag_kernel("),
    in_diag("kThreads", "kDT"),
    in_diag("kWarps", "(kDT / 32)"),
    in_diag("  constexpr int LD = B + 4,",
            "  constexpr int kDT = kTc ? 2 * kThreads : kThreads;\n"
            "  constexpr int LD = B + 4,"),
    in_diag("      tile_product<B>(acc, sW, sW);\n",
            "      if (tid < kThreads) tile_product<B>(acc, sW, sW);\n"),
    in_diag("      for_each_tc<B>(acc, [&](int r, int c, float v0, float v1) {",
            "      if (tid < kThreads)\n"
            "      for_each_tc<B>(acc, [&](int r, int c, float v0, float v1) {"),
    ("diag_kernel<float, B, bf16><<<batch, kThreads, smem_d, s>>>(",
     "diag_kernel<float, B, bf16><<<batch, 2 * kThreads, smem_d, s>>>("),
]

# the wgmma design's diagonal step forming X by recursive doubling (pairs of
# inverted diagonal blocks joined level by level: 6 barriers at B = 128,
# not 14) in place of block rows; X's float32 roundings then differ, so
# its bf16 values, and the factor's bits, differ from mma_sync's
DOUBLING = [in_diag(
    "  // X_ij = -X_ii sum_{k=j}^{i-1} L_ik X_kj, block row by block row, in "
    "place\n  for (int i = 1; i < NS; ++i) {",
    r"""  if constexpr (kTc) {
    // the wgmma design: X by recursive doubling, a level a doubling of the
    // inverted diagonal blocks.  At n = 16 nb rows each pair of blocks D1,
    // D2 (inverted) gives M = L_21 X_11 into Xd, then X_21 = -X_22 M over
    // L_21: two barriers a level (6 at B = 128, against 14 block rows), the
    // 16 x 16 output blocks over the warps, a deep one paired with a
    // shallow one where a warp takes two (X_11 and X_22 are lower).
    T* M = Xd;
    for (int nb = 1; nb < NS; nb *= 2) {
      const int n = nb * kNb, LDM = n + 4, blocks = NS / 2 * nb;
      for (int e = warp, q = 0; e < blocks; e += kWarps, ++q) {
        const int pair = e / (nb * nb), rem = e % (nb * nb), r = rem / nb;
        const int c = q & 1 ? nb - 1 - rem % nb : rem % nb;
        const int d1 = pair * 2 * n, d2 = d1 + n;
        T acc[2][2][2];
        zero(acc);
        warp_mma<2, 2>(acc, S + (d2 + r * kNb) * LD + d1 + c * kNb, LD,
                       S + (d1 + c * kNb) * LD + d1 + c * kNb, LD, 1,
                       (nb - c) * kNb);
        T* m = M + (pair * n + r * kNb) * LDM + c * kNb;
        for_each_acc(acc, [&](int rr, int cc, T v) { m[rr * LDM + cc] = v; });
      }
      __syncthreads();
      for (int e = warp, q = 0; e < blocks; e += kWarps, ++q) {
        const int pair = e / (nb * nb), rem = e % (nb * nb), c = rem / nb;
        const int r = q & 1 ? nb - 1 - rem % nb : rem % nb;
        const int d1 = pair * 2 * n, d2 = d1 + n;
        T acc[2][2][2];
        zero(acc);
        warp_mma<2, 2>(acc, S + (d2 + r * kNb) * LD + d2, LD,
                       M + pair * n * LDM + c * kNb, LDM, 1, (r + 1) * kNb);
        T* x = S + (d2 + r * kNb) * LD + d1 + c * kNb;
        for_each_acc(acc, [&](int rr, int cc, T v) { x[rr * LD + cc] = -v; });
      }
      __syncthreads();
    }
    for (int i = 0; i + 1 < NS; ++i) store_row(i, tid, kThreads);
  } else
  for (int i = 1; i < NS; ++i) {""")]

# the diagonal step's in-tile float32 products of the mixed variant as a
# three-term TF32 split (hi·hi + hi·lo + lo·hi) on mma.sync m16n8k8
TF32X3 = [
    ("// (a) the diagonal step: factor and inverse", r"""
__device__ __forceinline__ void tf32_split(float x, unsigned& hi,
                                           unsigned& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(x - __uint_as_float(hi)));
}
__device__ __forceinline__ void tmma(float (&lo)[2], float (&hi)[2],
                                     const unsigned (&a)[4],
                                     const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(lo[0]), "+f"(lo[1]), "+f"(hi[0]), "+f"(hi[1])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
template <int MI, int NI>
__device__ __forceinline__ void warp_mma_tf32x3(float (&acc)[MI][NI][2],
                                                const float* a, int lda,
                                                const float* b, int bk,
                                                int bn, int K) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  for (int k0 = 0; k0 < K; k0 += 8) {
    unsigned ah[MI / 2][4], al[MI / 2][4], bh[NI][2], bl[NI][2];
#pragma unroll
    for (int i = 0; i < MI / 2; ++i) {
      const float* r = a + (i * 16 + g) * lda + k0 + t;
      tf32_split(r[0], ah[i][0], al[i][0]);
      tf32_split(r[8 * lda], ah[i][1], al[i][1]);
      tf32_split(r[4], ah[i][2], al[i][2]);
      tf32_split(r[8 * lda + 4], ah[i][3], al[i][3]);
    }
#pragma unroll
    for (int j = 0; j < NI; ++j) {
      const float* c = b + (k0 + t) * bk + (j * 8 + g) * bn;
      tf32_split(c[0], bh[j][0], bl[j][0]);
      tf32_split(c[4 * bk], bh[j][1], bl[j][1]);
    }
#pragma unroll
    for (int i = 0; i < MI / 2; ++i)
#pragma unroll
      for (int j = 0; j < NI; ++j) {
        tmma(acc[2 * i][j], acc[2 * i + 1][j], al[i], bh[j]);
        tmma(acc[2 * i][j], acc[2 * i + 1][j], ah[i], bl[j]);
        tmma(acc[2 * i][j], acc[2 * i + 1][j], ah[i], bh[j]);
      }
  }
}
template <typename CT, int MI, int NI, typename T>
__device__ __forceinline__ void diag_mma(T (&acc)[MI][NI][2], const T* a,
                                         int lda, const T* b, int bk, int bn,
                                         int K) {
  if constexpr (std::is_same<T, float>::value &&
                !std::is_same<CT, float>::value)
    warp_mma_tf32x3<MI, NI>(acc, a, lda, b, bk, bn, K);
  else
    warp_mma<MI, NI>(acc, a, lda, b, bk, bn, K);
}

// (a) the diagonal step: factor and inverse"""),
    in_diag("warp_mma<2, 2>(", "diag_mma<CT, 2, 2>("),
]

# the trailing update without its C tile asked into L2 ahead
NO_PREFETCH = [
    ("""  for (int e = threadIdx.x; e < B * B / 32; e += kThreads)
    asm volatile("prefetch.global.L2 [%0];\\n" ::"l"(
        src + at + (long long)(e / (B / 32)) * hp + e % (B / 32) * 32));
""", ""),
]

PANEL_START = "// (b) of the wgmma design: one block a half tile row,"
# (b) one block a whole tile row (128 rows at B = 128, two warpgroups on
# the row halves), as the first wgmma design ran it
PANEL_TILE_ROWS = r'''// (b) of the wgmma design: one block a tile row i of the panel, 128 rows
// at B = 128 (the first wgmma design)
template <int B>
__global__ void __launch_bounds__(kThreads)
panel_kernel_tc(const float* src, float* a, bf16* __restrict__ wb,
                const __grid_constant__ CUtensorMap xmap, int hp, int lo) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* base = align_1024(smem_raw);
  bf16* sA = reinterpret_cast<bf16*>(base);
  bf16* sX = sA + B * B;
  uint64_t* bar = reinterpret_cast<uint64_t*>(sX + B * B);
  const int tid = threadIdx.x, i = blockIdx.x, mat = blockIdx.y;
  if (tid == 0) {
    mbar_init(bar, 1);
    mbar_expect_tx(bar, B * B * sizeof(bf16));
    for (int c = 0; c < B / 64; ++c)
      tma_load(sX + c * B * 64, &xmap, c * 64, 0, mat, bar);
  }
  const long long at = (long long)mat * hp * hp +
                       (long long)(lo + B + i * B) * hp + lo;
  constexpr int U = B * B / 8 / kThreads;
  float4 v[U][2];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int e = tid + u * kThreads, r = e / (B / 8), k = e % (B / 8) * 8;
    const float4* row = reinterpret_cast<const float4*>(src + at +
                                                        (long long)r * hp + k);
    v[u][0] = row[0];
    v[u][1] = row[1];
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int e = tid + u * kThreads, r = e / (B / 8), k = e % (B / 8) * 8;
    *reinterpret_cast<uint4*>(base + sw128_unit<B>(r, k)) =
        make_uint4(bf16x2(v[u][0].x, v[u][0].y), bf16x2(v[u][0].z, v[u][0].w),
                   bf16x2(v[u][1].x, v[u][1].y), bf16x2(v[u][1].z, v[u][1].w));
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  mbar_wait(bar, 0);
  float acc[TcShape<B>::kAcc];
  tile_product<B>(acc, sA, sX);
  float* W = a + at;
  bf16* Wb = wb + (long long)mat * hp * B + (long long)i * B * B;
  for_each_tc<B>(acc, [&](int r, int c, float v0, float v1) {
    *reinterpret_cast<float2*>(W + (long long)r * hp + c) = make_float2(v0, v1);
    *reinterpret_cast<unsigned*>(Wb + r * B + c) = bf16x2(v0, v1);
  });
}

'''


def panel_tile_rows(code: str) -> str:
    i = code.index(PANEL_START)
    j = code.index("// (c) of the wgmma design:", i)
    old = ("panel_kernel_tc<B><<<dim3(m * (B / 64), batch), kThreads, "
           "kTcSmem<B>,\n                         s>>>(")
    if old not in code:
        raise SystemExit("panel_tile_rows: the source changed")
    code = code[:i] + PANEL_TILE_ROWS + code[j:]
    return code.replace(old, "panel_kernel_tc<B><<<dim3(m, batch), kThreads, "
                        "kTcSmem<B>, s>>>(")


# the streams of a tile column: the source's (the diagonal step on the
# caller's stream right after the panel, the trailing update on the
# look-ahead stream) and the one-dtype kernels' order
STREAMS = """    RT_RETURN_IF(cudaEventRecord(la->panel_done, s));
    diag_kernel<float, B, bf16><<<batch, kThreads, smem_d, s>>>(
        in, a, xb, wb, hp, lo + B, wmap);
    RT_RETURN_IF_ERROR();
    ++*launches;
    RT_RETURN_IF(cudaStreamWaitEvent(la->side, la->panel_done, 0));
    syrk_kernel_tc<B><<<dim3(m * (m + 1) / 2 - 1 + m, batch), kThreads,
                        kTcSmem<B>, la->side>>>(in, a, wmap, hp, lo, m);
    RT_RETURN_IF_ERROR();
    ++*launches;
    RT_RETURN_IF(cudaEventRecord(la->diag_done, la->side));
    RT_RETURN_IF(cudaStreamWaitEvent(s, la->diag_done, 0));"""
# the diagonal step on the look-ahead stream after an event, the trailing
# update on the caller's stream (the one-dtype kernels' order)
DIAG_ON_SIDE = [(STREAMS, """    RT_RETURN_IF(cudaEventRecord(la->panel_done, s));
    RT_RETURN_IF(cudaStreamWaitEvent(la->side, la->panel_done, 0));
    diag_kernel<float, B, bf16><<<batch, kThreads, smem_d, la->side>>>(
        in, a, xb, wb, hp, lo + B, wmap);
    RT_RETURN_IF_ERROR();
    ++*launches;
    RT_RETURN_IF(cudaEventRecord(la->diag_done, la->side));
    syrk_kernel_tc<B><<<dim3(m * (m + 1) / 2 - 1 + m, batch), kThreads,
                        kTcSmem<B>, s>>>(in, a, wmap, hp, lo, m);
    RT_RETURN_IF_ERROR();
    ++*launches;
    RT_RETURN_IF(cudaStreamWaitEvent(s, la->diag_done, 0));""")]

#: the variants: name → (the design whose scratch it takes, -D flags,
#: substitutions: (old, new) pairs or functions of the source)
VARIANTS: dict = {
    "diag_16_warps": ("wgmma", [], WARPS16),
    "diag_tf32x3": ("wgmma", [], TF32X3),
    "inverse_doubling": ("wgmma", [], DOUBLING),
    "no_prefetch": ("wgmma", [], NO_PREFETCH),
    "panel_tile_rows": ("wgmma", [], [panel_tile_rows]),
    "diag_on_side": ("wgmma", [], DIAG_ON_SIDE),
    # the first wgmma design
    "first_wgmma": ("wgmma", [], [panel_tile_rows, *DIAG_ON_SIDE,
                                  *NO_PREFETCH]),
}

DESIGNS = {"wgmma": ("wgmma", [], []),
           "mma_sync": ("mma_sync", ["-DCHOL_MIXED_MMA_SYNC=1"], [])}


def smi() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]


def build(names) -> dict:
    """One nvcc per design, started together; name → (CDLL, ptxas log)."""
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        _, flags, subs = {**DESIGNS, **VARIANTS}[name]
        code = SRC
        for sub in subs:
            if callable(sub):
                code = sub(code)
                continue
            old, new = sub
            if old not in code:
                raise SystemExit(f"{name}: the source changed ({old[:60]!r})")
            code = code.replace(old, new)
        (OUT / f"{name}.cu").write_text(code)
        lib = OUT / f"lib{name}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, *flags, "-I",
               str(_build.CSRC), "-o", str(lib), str(OUT / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       lib)
    out = {}
    for name, (proc, lib) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{log[-4000:]}")
        out[name] = (ctypes.CDLL(str(lib)), log)
    return out


def ptxas(log: str, block: int) -> list:
    """The compiler's lines for the mixed variant's kernels at ``block``."""
    rows, cur = [], None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            cur = line.split("'")[1]
        elif cur and "Used" in line:
            mixed = "bfloat16" in cur or "_tc" in cur
            if mixed and f"Li{block}E" in cur:
                kind = next((k for k in CHOL_KERNELS if k in cur), cur)
                rows.append(f"{kind}{'_tc' if '_tc' in cur else ''}: "
                            f"{line.split(':', 1)[1].strip()}")
            cur = None
    return rows


def caller(lib, design: str):
    """``cholesky_blocked(a, block, compute_dtype=bf16)`` through ``lib``:
    the wrapper's padding and scratch, the design's scratch dtype."""
    fn = lib.rt_chol_blocked_f32_bf16
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
                   + [ctypes.POINTER(ctypes.c_int), ctypes.c_void_p])
    fn.restype = ctypes.c_int
    stored = design != "mma_sync"

    def call(a: torch.Tensor, block: int, keep=None) -> torch.Tensor:
        batch, h = a.shape[0], a.shape[-1]
        hp = packing.num_tiles(h, block) * block
        if hp == h:
            src, work = a, torch.empty_like(a)
        else:
            work = a.new_zeros((batch, hp, hp))
            work[:, :h, :h] = a
            idx = torch.arange(h, hp, device=a.device)
            work[:, idx, idx] = 1
            src = work
        inv, w = chol_blocked.scratch(a, batch, hp, block,
                                      torch.bfloat16 if stored else None)
        n = ctypes.c_int(0)
        rc = fn(*(ctypes.c_void_p(t.data_ptr()) for t in (src, work, inv, w)),
                batch, hp, block, ctypes.byref(n),
                ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
        _build.check(rc, design)
        if keep is not None:
            keep.append(inv)
        return work[:, :h, :h] if hp != h else work

    return call


def timed_ms(fn, reps: int = 20) -> float:
    fn()
    torch.cuda.synchronize()
    s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    s.record()
    for _ in range(reps):
        fn()
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e) / reps


def split(fn) -> tuple[dict, list]:
    """Device ms and launches of the three kernels in one profiled call, and
    its timeline: (kernel, start µs, end µs) from the first kernel's start,
    in order of start."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {k: dict(ms=0.0, launches=0) for k in CHOL_KERNELS}
    spans = []
    for ev in prof.events():
        if ev.device_type != DeviceType.CUDA:
            continue
        for k in CHOL_KERNELS:
            if k in ev.name:
                out[k]["ms"] += ev.time_range.elapsed_us() / 1e3
                out[k]["launches"] += 1
                spans.append((k.split("_")[0], ev.time_range.start,
                              ev.time_range.end))
    spans.sort(key=lambda e: e[1])
    t0 = spans[0][1] if spans else 0
    return out, [(k, round(a - t0, 1), round(b - t0, 1)) for k, a, b in spans]


def inputs(dev, batch: int, h: int) -> torch.Tensor:
    gen = torch.Generator(device=dev).manual_seed(h)
    x = torch.randn(batch, 2 * h, h, generator=gen, device=dev,
                    dtype=torch.float64)
    return (x.mT @ x / h + torch.eye(h, device=dev, dtype=torch.float64)
            ).float().contiguous()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--only", default="",
                    help="comma-separated designs (default: all)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("ab_chol_mixed.py needs a CUDA device")
    import chip_smoke
    tol = chip_smoke.MIXED_TOL["cholesky_blocked_bf16"]
    print(smi(), flush=True)
    names = [n for n in args.only.split(",") if n] or [*DESIGNS, *VARIANTS]
    libs = build(sorted({*names, "mma_sync"}))
    dev = torch.device("cuda")
    cases = {shape: inputs(dev, *shape[:2]) for shape in SHAPES}
    ok = []
    base = caller(libs["mma_sync"][0], "mma_sync")
    for name in names:
        lib, log = libs[name]
        call = caller(lib, {**DESIGNS, **VARIANTS}[name][0])
        good = True
        for (batch, h, block), a in cases.items():
            plain = ref.cholesky_blocked(a, block, torch.bfloat16)
            got, again = call(a, block), call(a, block)
            torch.cuda.synchronize()
            rel = float((got - plain).abs().max() / plain.abs().max())
            rec = dict(design=name, shape=[batch, h, block], rel_err=rel,
                       tol=tol, same_bits=bool(torch.equal(got, again)),
                       finite=bool(torch.isfinite(got).all()),
                       bits_as_mma_sync=bool(torch.equal(got,
                                                         base(a, block))))
            rec["ok"] = rec["same_bits"] and rec["finite"] and rel <= tol
            good &= rec["ok"]
            print(json.dumps(dict(check=rec)), flush=True)
        # the diagonal step alone (one tile, nt = 1): its float32 factor
        # within TOL[float32] of ref.factor_diag_tile, the inverse it
        # stores (bf16 in the wgmma design) within a bf16 rounding
        tile = cases[SHAPES[0]][:, :128, :128].contiguous()
        keep = []
        got = call(tile, 128, keep)
        torch.cuda.synchronize()
        l_p, x_p = ref.factor_diag_tile(tile.double())
        rec = dict(design=name, diag_tile=128,
                   l_rel_err=float((got.double() - l_p).abs().max()
                                   / l_p.abs().max()),
                   x_rel_err=float((keep[0].double() - x_p).abs().max()
                                   / x_p.abs().max()),
                   l_tol=chip_smoke.TOL[torch.float32], x_tol=2.0 ** -8)
        rec["ok"] = (rec["l_rel_err"] <= rec["l_tol"]
                     and rec["x_rel_err"] <= rec["x_tol"])
        good &= rec["ok"]
        print(json.dumps(dict(check=rec)), flush=True)
        if good:
            ok.append(name)
    times = {(n, s): [] for n in ok for s in SHAPES}
    for r in range(args.rounds):
        order = ok if r % 2 == 0 else ok[::-1]
        for name in order:
            call = caller(libs[name][0], {**DESIGNS, **VARIANTS}[name][0])
            for shape, a in cases.items():
                ms = timed_ms(lambda: call(a, shape[2]))
                times[(name, shape)].append(ms)
                print(json.dumps(dict(design=name, shape=list(shape),
                                      round=r, ms=ms)), flush=True)
    for name in ok:
        call = caller(libs[name][0], {**DESIGNS, **VARIANTS}[name][0])
        for shape, a in cases.items():
            by_kernel, timeline = split(lambda: call(a, shape[2]))
            print(json.dumps(dict(
                design=name, shape=list(shape), by_kernel=by_kernel,
                ptxas=ptxas(libs[name][1], shape[2]), timeline=timeline)),
                flush=True)
    print(json.dumps(dict(median_ms={
        f"{n}@{s[1]}/{s[2]}": statistics.median(v)
        for (n, s), v in times.items()}, failed=[n for n in names
                                                 if n not in ok])),
          flush=True)


if __name__ == "__main__":
    main()
