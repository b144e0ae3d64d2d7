#!/usr/bin/env python3
"""A/B of the mixed-precision cluster solve's designs on one CUDA card.

    python3 scripts/ab_tri_solve_mixed.py [--parent DIR] [--rounds 3]
                                          [--only NAME,...]

The mixed instantiations of ``csrc/tri_solve.cuh`` (float32 state, bf16
products): ``interp_solve`` on a bf16 Θ (row 6m,
``rt_interp_solve_f32_bf16``), the dense trsm's forward and transposed
launch (row 8m, ``rt_trsm_f32_bf16``, timed as the pair) and the packed
trsm's both sweeps on bf16 and on float32 packed factors (row 7m,
``rt_packed_trsm_bf16``, ``rt_packed_trsm_f32_bf16``), each built from
``trsm.cu``, ``poly_interp.cu`` and ``packed_trsm.cu`` with the port's nvcc
flags into ``build/ab_tri_solve_mixed/<design>/``, in these designs:

``new``           this checkout's sources;
``parent``        the sources of ``--parent DIR`` (a checkout, e.g. ``git
                  archive HEAD~1 | tar -x -C build/parent``): the design
                  before (operands rounded to bf16 as each fragment is
                  formed, float32 inverses, a ring fed by the threads'
                  cp.async, one block an SM);

and the variants of :data:`VARIANTS`, each ``new`` with a text
substitution of ``csrc/tri_solve.cuh`` (the other sources copied as they
are), each undoing one element of the design or building one that was
tried and not kept:

``thread_ring``   every ring fed by the threads' cp.async, 16 bytes each
                  (``new`` feeds Θ's and the packed factors' by bulk
                  copies, the dense factor's by the threads);
``bulk_ring``     every ring fed by bulk copies, the dense factor's one a
                  row (not kept);
``tile_reduce``   the forward update's partials of a tile's chunks kept
                  and summed once a tile, in the same order (``new`` sums
                  them every chunk; not kept);
``waves_score``   planned by the one-dtype plan's score (waves x 8 / C)
                  in place of the model of one system's time;
``one_block``     one block an SM (``__launch_bounds__(256, 1)``);
``no_prefetch``   the prologue reads and inverts the diagonal tiles as the
                  one-dtype kernels do (each plane's load after the
                  previous Horner step).

Shapes: the main path's bf16 shapes at h = 1024, B = 128 (Θ (5, 3, P) at 14
λ; 70 factors; 31 packed factors of one fold) and the Table-4 fixture's
h = 144, B = 32 (Θ (5, 3, P) at 14 λ; 20 factors; 14 packed factors), from
seeded SPD matrices (xᵀx/h + I).  Each design is first held, per case, to
the plain version (``kernels.ref`` with bf16 products, on the card): max
|Δ| / max |plain| within ``chip_smoke.MIXED_TOL``, the same bits on two
calls, and a SHA-256 of its output (``same_bits_as_new``: whether it gives
``new``'s bits).  A design that fails is not timed.  Then every design is
timed in turns (CUDA events, mean of 20 calls after a warm-up, the order
reversed every other round).  Output, one JSON line each: the card's
``nvidia-smi`` name and power limit first (a plain line); per design its
build seconds and the ``ptxas`` lines of its cluster-solve kernels; per
design and case its check and plan; per timed run its ms; last the median
ms per design and case, and its ratio to ``new``'s.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

from repro_torch.core import packing  # noqa: E402
from repro_torch.kernels import (_build, packed_trsm, poly_interp,  # noqa
                                 ref, trsm)

OUT = ROOT / "build" / "ab_tri_solve_mixed"
LIBS = ("trsm", "poly_interp", "packed_trsm")
HEADER = "tri_solve.cuh"

BULK = "const bool bulk = a.vec && kTiles;    // the ring fed by bulk copies"
BULK_ISSUE = """        const uint32_t bytes = plane * sizeof(Src);
        if (lane == 0) mbar_expect_tx(&full[stage], a.nc * bytes);
        __syncwarp();
        for (int k = lane; k < a.nc; k += 32)
          bulk_copy(dst + k * bytes, tile_at(ti, tj, k) + (long long)r0 * B,
                    bytes, &full[stage]);
"""
# the dense factor's chunk by one bulk copy a row (its zeros past h are
# written when the chunk becomes a tile)
BULK_ROWS = """        if (kTiles) {
""" + BULK_ISSUE + """        } else {
          const int vr = max(0, min(cr, inside(ti) - r0));
          const uint32_t bytes = inside(tj) * sizeof(Src);
          if (lane == 0) mbar_expect_tx(&full[stage], vr * bytes);
          __syncwarp();
          for (int r = lane; r < vr; r += 32)
            bulk_copy(dst + (long long)r * B * sizeof(Src),
                      tile_at(ti, tj, 0) + (long long)(r0 + r) * ld, bytes,
                      &full[stage]);
        }
"""
CHUNK_SUM = """        __syncthreads();
        if (tid < cr) {
          T s = T(0);
          for (int p = 0; p < kf; ++p) s += red[p * B + r0 + tid];
          aj[r0 + tid] += s;
        }
"""
TILE_SUM = """    if (!fwd) {                       // one sum a tile, in order
      warp_mv_store(racc, red + warp / (B / 16) * B + warp % (B / 16) * 16);
      __syncthreads();
      if (tid < B) {
        T s = T(0);
        for (int p = 0; p < KQ; ++p) s += red[p * B + tid];
"""
TILE_SUM_BOTH = """    if (!fwd)
      warp_mv_store(racc, red + warp / (B / 16) * B + warp % (B / 16) * 16);
    {                                 // one sum a tile, in order
      __syncthreads();
      if (tid < B) {
        T s = T(0);
        for (int p = 0; p < (fwd ? kf : KQ); ++p) s += red[p * B + tid];
"""
SCORE = "const double score = (double)((n_sys + n - 1) / n) * one;"
WAVES_SCORE = ("const double score = (double)((n_sys + n - 1) / n * "
               "(kMaxCluster / C));")
TWO_BLOCKS = "constexpr int kMixedBlocksPerSm = 2;"

#: name -> the (old, new) substitutions of tri_solve.cuh
VARIANTS: dict = {
    "thread_ring": [(BULK, "const bool bulk = false;")],
    "bulk_ring": [(BULK, "const bool bulk = a.vec;"), (BULK_ISSUE, BULK_ROWS)],
    "tile_reduce": [(CHUNK_SUM, ""), (TILE_SUM, TILE_SUM_BOTH)],
    "waves_score": [(SCORE, WAVES_SCORE)],
    "one_block": [(TWO_BLOCKS, "constexpr int kMixedBlocksPerSm = 1;")],
    "no_prefetch": [("constexpr int kMixedDiagPlanes = 4;",
                     "constexpr int kMixedDiagPlanes = 0;")],
}


def sources(name: str, csrc: Path) -> Path:
    """The csrc directory a design builds from: ``csrc`` itself, or a copy
    under ``OUT/<name>/csrc`` with the variant's substitutions made."""
    if name not in VARIANTS:
        return csrc
    dst = OUT / name / "csrc"
    if dst.exists():
        shutil.rmtree(dst)
    shutil.copytree(csrc, dst)
    code = (csrc / HEADER).read_text()
    for old, new in VARIANTS[name]:
        if old not in code:
            raise SystemExit(f"{name}: the source changed ({old[:60]!r})")
        code = code.replace(old, new)
    (dst / HEADER).write_text(code)
    return dst


def build(designs: dict) -> dict:
    """Every (design, library) at once, one nvcc each; the ptxas lines of
    the cluster-solve kernels per design."""
    procs = {}
    for name, csrc in designs.items():
        d = OUT / name
        d.mkdir(parents=True, exist_ok=True)
        src = sources(name, csrc)
        for lib in LIBS:
            cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(src),
                   "-o", str(d / f"lib{lib}.so"), str(src / f"{lib}.cu")]
            procs[name, lib] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), time.perf_counter())
    out = {}
    for (name, lib), (proc, t0) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name}/{lib}:\n{log[-4000:]}")
        row = out.setdefault(name, dict(build_s=0.0, ptxas=[]))
        row["build_s"] = max(row["build_s"], time.perf_counter() - t0)
        fn = None
        for line in log.splitlines():
            if "Compiling entry function" in line:
                fn = line.split("'")[1] if "'" in line else line
            elif "Used" in line and fn and "tri_solve" in fn:
                row["ptxas"].append(dict(lib=lib, kernel=fn,
                                         used=line.split(":", 1)[-1].strip()))
    return out


def digest(t: torch.Tensor) -> str:
    return hashlib.sha256(t.detach().contiguous().cpu().numpy().tobytes()
                          ).hexdigest()[:16]


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("ab_tri_solve_mixed.py needs a CUDA device")
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", type=Path)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--only", default="")
    args = ap.parse_args()
    import chip_smoke
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    designs = {k: _build.CSRC for k in ("new", *VARIANTS)}
    if args.parent:
        designs["parent"] = (args.parent.resolve() / "src" / "repro_torch"
                             / "kernels" / "csrc")
    only = {c for c in args.only.split(",") if c}
    if only:
        designs = {k: v for k, v in designs.items() if k in only or k == "new"}
    built = build(designs)
    libs = {}
    for name in designs:
        print(json.dumps(dict(design=name, **built[name])), flush=True)
        libs[name] = {lib: ctypes.CDLL(str(OUT / name / f"lib{lib}.so"))
                      for lib in LIBS}

    dev = torch.device("cuda")
    f64, f32, bf = torch.float64, torch.float32, torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(26)

    def factors(n, h):
        out = []
        for k in range(0, n, 10):
            x = torch.randn(min(10, n - k), 2 * h, h, generator=gen,
                            device=dev, dtype=f64)
            out.append(torch.linalg.cholesky(
                x.mT @ x / h + torch.eye(h, device=dev, dtype=f64)))
            del x
        return torch.cat(out)

    def stream():
        return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)

    cases = {}
    for h, block, n_exact, n_packed in ((1024, 128, 70, 31), (144, 32, 20, 14)):
        nt = packing.num_tiles(h, block)
        hp = nt * block
        l64 = factors(max(n_exact, 15, n_packed), h)
        l32 = l64[:n_exact].float().contiguous()
        v = packing.pack_tril(l64[:15], block)
        theta = torch.stack([v[:5], 0.1 * v[5:10], 0.01 * v[10:15]], 1
                            ).to(bf).contiguous()
        x14 = torch.logspace(-3, -1, 14, device=dev, dtype=f32)
        g5 = torch.randn(5, hp, 1, generator=gen, device=dev, dtype=f32)
        g5[:, h:] = 0
        rhs = torch.randn(n_exact, h, 1, generator=gen, device=dev, dtype=f32)
        pk32 = packing.pack_tril(l64[:n_packed], block).float().contiguous()
        pk16 = pk32.to(bf).contiguous()
        gp = torch.randn(n_packed, hp, 1, generator=gen, device=dev, dtype=f32)
        gp[:, h:] = 0
        n_sys = max(70, n_exact, n_packed)
        scratch = torch.empty(n_sys, nt, block, block + 4, device=dev,
                              dtype=f32)
        tag = f"h{h}_b{block}"

        def interp(lib, theta=theta, x14=x14, g5=g5, nt=nt, hp=hp, h=h,
                   block=block, scratch=scratch):
            fn = lib["poly_interp"].rt_interp_solve_f32_bf16
            fn.argtypes = poly_interp._ARGS
            out = torch.empty(5, 14, hp, 1, device=dev, dtype=f32)
            plan = (ctypes.c_int * len(_build.PLAN_KEYS))()
            rc = fn(_build.ptr(theta), _build.ptr(x14), _build.ptr(g5),
                    _build.ptr(scratch), _build.ptr(out), 5, 14, 2, nt, block,
                    theta.shape[-1], 1, 0, h, plan, stream())
            return rc, out, [dict(zip(_build.PLAN_KEYS, plan))]

        def trsm_pair(lib, l32=l32, rhs=rhs, h=h, block=block,
                      scratch=scratch):
            fn = lib["trsm"].rt_trsm_f32_bf16
            fn.argtypes = trsm._ARGS
            w = torch.empty_like(rhs)
            out = torch.empty_like(rhs)
            plans = []
            for src, dst, transpose in ((rhs, w, 0), (w, out, 1)):
                plan = (ctypes.c_int * len(_build.PLAN_KEYS))()
                rc = fn(_build.ptr(l32), _build.ptr(src), _build.ptr(scratch),
                        _build.ptr(dst), l32.shape[0], h, block, 1, transpose,
                        plan, stream())
                plans.append(dict(zip(_build.PLAN_KEYS, plan)))
                if rc:
                    return rc, out, plans
            return 0, out, plans

        def packed(lib, entry, vec, gp=gp, h=h, block=block,
                   scratch=scratch):
            fn = getattr(lib["packed_trsm"], entry)
            fn.argtypes = packed_trsm._ARGS
            out = torch.empty_like(gp)
            plan = (ctypes.c_int * len(_build.PLAN_KEYS))()
            rc = fn(_build.ptr(vec), _build.ptr(gp), _build.ptr(scratch),
                    _build.ptr(out), vec.shape[0], h, block, 1, 3, plan,
                    stream())
            return rc, out, [dict(zip(_build.PLAN_KEYS, plan))]

        def plain_interp(theta=theta, x14=x14, g5=g5, h=h, block=block):
            inv = ref.interp_diag_inverses(theta, x14, h, block, f32)
            return ref.interp_solve(theta, x14, inv, g5, h, block, bf)

        def plain_trsm(l32=l32, rhs=rhs, block=block):
            w = ref.solve_lower_blocked(l32, rhs, block, compute_dtype=bf)
            return ref.solve_lower_blocked(l32, w, block, transpose=True,
                                           compute_dtype=bf)

        def plain_packed(vec, gp=gp, h=h, block=block):
            return ref.solve_packed(vec, gp[:, :h], h, block, bf)

        cases[f"interp_solve_bf16_{tag}"] = (interp, plain_interp, None)
        cases[f"trsm_bf16_pair_{tag}"] = (trsm_pair, plain_trsm, None)
        cases[f"packed_bf16_{tag}"] = (
            lambda lib, f=packed, v=pk16: f(lib, "rt_packed_trsm_bf16", v),
            lambda f=plain_packed, v=pk16: f(v), h)
        cases[f"packed_f32_factor_{tag}"] = (
            lambda lib, f=packed, v=pk32: f(lib, "rt_packed_trsm_f32_bf16", v),
            lambda f=plain_packed, v=pk32: f(v), h)

    ok_designs = []
    new_bits = {}
    for name in ["new"] + [d for d in designs if d != "new"]:
        good = True
        for case, (run, plain, h_cut) in cases.items():
            rc, out, plans = run(libs[name])
            torch.cuda.synchronize()
            if rc:
                print(json.dumps(dict(design=name, case=case, ok=False,
                                      cuda_error=rc)), flush=True)
                good = False
                continue
            rc2, again, _ = run(libs[name])
            torch.cuda.synchronize()
            want = plain()
            got = out if h_cut is None else out[:, :h_cut]
            err = float((got - want).abs().max() / want.abs().max())
            bits = digest(out)
            if name == "new":
                new_bits[case] = bits
            tol = chip_smoke.MIXED_TOL["interp_solve_bf16"]
            row = dict(design=name, case=case, max_rel_err=err, tol_rel=tol,
                       same_bits_twice=bool(rc2 == 0 and torch.equal(out,
                                                                     again)),
                       sha256=bits, same_bits_as_new=bits == new_bits.get(case),
                       plans=plans)
            row["ok"] = err <= tol and row["same_bits_twice"]
            good &= row["ok"]
            print(json.dumps(row), flush=True)
        if good:
            ok_designs.append(name)

    times = {}
    order = list(ok_designs)
    for r in range(args.rounds):
        for name in (order if r % 2 == 0 else order[::-1]):
            for case, (run, _, _) in cases.items():
                lib = libs[name]
                run(lib)
                torch.cuda.synchronize()
                s, e = (torch.cuda.Event(enable_timing=True),
                        torch.cuda.Event(enable_timing=True))
                s.record()
                for _ in range(20):
                    run(lib)
                e.record()
                torch.cuda.synchronize()
                ms = s.elapsed_time(e) / 20
                times.setdefault((name, case), []).append(ms)
                print(json.dumps(dict(design=name, case=case, round=r, ms=ms)),
                      flush=True)
    med = {k: statistics.median(v) for k, v in times.items()}
    print(json.dumps(dict(
        median_ms={f"{n}/{c}": t for (n, c), t in med.items()},
        vs_new={f"{n}/{c}": t / med["new", c] for (n, c), t in med.items()
                if n != "new" and ("new", c) in med})), flush=True)


if __name__ == "__main__":
    main()
