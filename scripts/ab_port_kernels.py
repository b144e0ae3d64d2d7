#!/usr/bin/env python3
"""Time the port's two CV engine sweeps, ``cholesky_blocked``,
``pack_tril``, dense trsm, ``interp_solve`` and the packed trsm in this
checkout against another checkout of the repo, in turns, on one CUDA
card.

    python3 scripts/ab_port_kernels.py OTHER_CHECKOUT [--rounds 2]

Each run is its own process importing one checkout's ``src`` (so each side
uses its own kernels, built into its own ``build/``).  Runs alternate
other, this, this, other, … for ``--rounds`` rounds.  Inputs: 20 SPD
matrices of 1024² in float64 from a seeded generator (the main path's
anchor batch, ``chip_smoke.py``'s timed shape), block 128.  The trsm: the
forward and the transposed solve of 15 of their factors, one right-hand
side, as the exact sweep runs them (``CudaBackend.solve_from_factor``).
``interp_solve``: Θ (5, 3, P) from the packed factors, 3 λ, g (5, 1024),
the main path's λ chunk; also in float32 at 14 λ (the chunk under a bf16
store).  The packed trsm: ``solve_packed`` (both sweeps)
of the 20 packed factors, one right-hand side each (its output is not in
the digest: it may change between checkouts).  The engines: ``cv_picholesky`` and ``cv_exact_cholesky`` on the
``cuda`` backend at the repo's configuration (h=1024, n=4096, k=5, q=31
over [1e-3, 1], g=4, r=2, block=128, float64, ``chip_smoke.py``'s phase
``main``), host clock to a synchronize, median of 5 after a warm run.
Each run prints one JSON line: the card's name and power limit, the two
engines' wall ms, the mean ms of each wrapper over 10 calls after a
warm-up (CUDA events), the Cholesky's launches per call, and a SHA-256
digest of the wrappers' outputs in float64 and float32 and of both
engines' curves; the last line gives the median per side and whether
every run of both sides gave one digest (the same bits).  Then, per
one-dtype instantiation of the cluster solve (``tri_solve_kernel`` at
float64 and float32, every block and tile source, in the libraries of
``trsm.cu``, ``poly_interp.cu`` and ``packed_trsm.cu`` each side built),
whether the two sides compiled it to the same machine code (``cuobjdump
-sass``, addresses and encodings stripped), its instruction count on each
side and how many instructions the two differ by when counted per opcode
(0: the same instructions, scheduled or allocated otherwise); one JSON
line.
"""
from __future__ import annotations

import argparse
import collections
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

CHILD = r"""
import hashlib, json, statistics, subprocess, sys, time
sys.path.insert(0, "src")
import torch
from repro_torch.core import packing
from repro_torch.core.backends import CudaBackend
from repro_torch.kernels import (LAUNCHES, chol_blocked, packed_trsm,
                                 poly_interp, reset_launches, tri_pack)
dev = torch.device("cuda")
gen = torch.Generator(device=dev).manual_seed(0)
x = torch.randn(20, 2048, 1024, generator=gen, device=dev, dtype=torch.float64)
a = (x.mT @ x / 1024 + torch.eye(1024, device=dev, dtype=torch.float64)).contiguous()
l = torch.linalg.cholesky(a).contiguous()
l15 = l[:15].contiguous()
g15 = torch.randn(15, 1024, generator=gen, device=dev, dtype=torch.float64)
v = packing.pack_tril(l, 128)
g20 = torch.randn(20, 1024, generator=gen, device=dev, dtype=torch.float64)
theta = torch.stack([v[:5], 0.1 * v[5:10], 0.01 * v[10:15]], 1).contiguous()
lams = torch.tensor([1e-3, 3.2e-3, 1e-2], device=dev, dtype=torch.float64)
g5 = torch.randn(5, 1024, generator=gen, device=dev, dtype=torch.float64)
theta32, g5_32 = theta.float(), g5.float()
lams14 = torch.logspace(-3, -1, 14, device=dev, dtype=torch.float64)
bk = CudaBackend()


def timed(fn, reps=10):
    fn()
    torch.cuda.synchronize()
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(reps):
        fn()
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e) / reps

reset_launches()
chol_blocked.cholesky_blocked(a, 128)
torch.cuda.synchronize()
launches = LAUNCHES["cholesky_blocked"]
smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                      "--format=csv,noheader"], capture_output=True,
                     text=True).stdout.strip().splitlines()[0]

# the main path's two sweeps at the repo's configuration (chip_smoke.py's
# phase main): host clock to a synchronize, median of 5 after a warm run
from repro_torch.core import cv
from repro_torch.data import make_regression_dataset
del x
xs, ys = make_regression_dataset(4096, 1024, seed=0, dtype=torch.float64,
                                 device=dev)
folds = cv.make_folds(xs, ys, 5, device=dev)
grid = torch.logspace(-3, 0, 31, dtype=torch.float64, device=dev)


def wall(fn, reps=5):
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(out)


engines = dict(
    picholesky_engine_ms=wall(lambda: cv.cv_picholesky(
        folds, grid, g=4, degree=2, block=128, backend="cuda", device=dev)),
    exact_engine_ms=wall(lambda: cv.cv_exact_cholesky(
        folds, grid, backend="cuda", device=dev)))

# the bits of every output, float64 and float32, and of both curves
digest = hashlib.sha256()
for dt in (torch.float64, torch.float32):
    outs = (chol_blocked.cholesky_blocked(a.to(dt), 128),
            tri_pack.pack_tril(l.to(dt), 128),
            bk.solve_from_factor(l15.to(dt), g15.to(dt)),
            poly_interp.interp_solve(theta.to(dt), lams, g5.to(dt), 1024, 128))
    for t in outs:
        digest.update(t.cpu().numpy().tobytes())
for run in (cv.cv_picholesky(folds, grid, g=4, degree=2, block=128,
                             backend="cuda", device=dev),
            cv.cv_exact_cholesky(folds, grid, backend="cuda", device=dev)):
    digest.update(run.errors.tobytes())
print(json.dumps(dict(
    card=smi, **engines,
    cholesky_blocked_ms=timed(lambda: chol_blocked.cholesky_blocked(a, 128)),
    pack_tril_ms=timed(lambda: tri_pack.pack_tril(l, 128)),
    trsm_pair_ms=timed(lambda: bk.solve_from_factor(l15, g15)),
    packed_solve_ms=timed(lambda: packed_trsm.solve_packed(v, g20, 1024, 128)),
    interp_solve_ms=timed(lambda: poly_interp.interp_solve(theta, lams, g5, 1024, 128)),
    interp_solve_f32_ms=timed(lambda: poly_interp.interp_solve(theta32, lams14, g5_32, 1024, 128)),
    cholesky_launches=launches, digest=digest.hexdigest())))
"""


TIMED = ("picholesky_engine_ms", "exact_engine_ms", "cholesky_blocked_ms",
         "pack_tril_ms", "trsm_pair_ms", "interp_solve_ms",
         "interp_solve_f32_ms", "packed_solve_ms")


def run(side: str, root: Path) -> dict:
    out = subprocess.run([sys.executable, "-c", CHILD], cwd=root,
                         capture_output=True, text=True)
    if out.returncode:
        raise SystemExit(f"{side} ({root}) failed:\n{out.stderr[-3000:]}")
    rec = dict(json.loads(out.stdout.strip().splitlines()[-1]), side=side)
    print(json.dumps(rec), flush=True)
    return rec


# a one-dtype tri_solve_kernel<T, B, Source> (this tree's mangling, or the
# earlier <T, B, Source, T, T>): T, B, Source
ONE_DTYPE = re.compile(r"tri_solve_kernelI([df])Li(\d+)ELi(\d+)E(?:\1\1)?E")


def sass(root: Path) -> dict:
    """(T, B, Source) -> the instructions of that one-dtype cluster-solve
    kernel in the newest libraries ``root`` built, addresses and
    encodings stripped."""
    tool = shutil.which("cuobjdump") or str(
        Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin"
        / "cuobjdump")
    out = {}
    for lib in ("trsm", "poly_interp", "packed_trsm"):
        built = sorted((root / "build" / "repro_torch_kernels").glob(
            f"lib{lib}-*.so"), key=lambda f: f.stat().st_mtime)
        if not built:
            raise SystemExit(f"{root}: no lib{lib} built")
        text = subprocess.run([tool, "-sass", str(built[-1])],
                              capture_output=True, text=True,
                              check=True).stdout
        key = None
        for line in text.splitlines():
            if "Function :" in line:
                m = ONE_DTYPE.search(line)
                key = m.groups() if m else None
                if key:
                    out[key] = []
                continue
            ins = re.sub(r"/\*.*?\*/", "", line).strip()
            if key and ins and not ins.startswith("."):
                out[key].append(ins)
    return out


def opcodes(code: list) -> collections.Counter:
    """How many times each opcode (predicate dropped) occurs."""
    return collections.Counter(
        next(t for t in ins.split() if not t.startswith("@")) for ins in code)


def same_code(other: Path) -> dict:
    mine, theirs = sass(ROOT), sass(other)
    rows = {}
    for key in sorted(set(mine) | set(theirs)):
        a, b = mine.get(key, []), theirs.get(key, [])
        ca, cb = opcodes(a), opcodes(b)
        rows["%s_B%s_src%s" % key] = dict(
            same=a == b, this=len(a), other=len(b),
            opcodes_moved=sum(((ca - cb) + (cb - ca)).values()))
    return dict(sass=rows, all_same=all(r["same"] for r in rows.values()))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", type=Path)
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    recs = []
    for _ in range(args.rounds):
        for side in ("other", "this", "this", "other"):
            recs.append(run(side, ROOT if side == "this" else args.other))
    summary = {side: {k: statistics.median(r[k] for r in recs
                                           if r["side"] == side)
                      for k in TIMED}
               for side in ("other", "this")}
    print(json.dumps(dict(median=summary, same_outputs=len(
        {r["digest"] for r in recs}) == 1)), flush=True)
    print(json.dumps(same_code(args.other)), flush=True)


if __name__ == "__main__":
    main()
