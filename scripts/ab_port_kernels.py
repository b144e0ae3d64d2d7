#!/usr/bin/env python3
"""Time the port's ``cholesky_blocked`` and ``pack_tril`` in this checkout
against another checkout of the repo, in turns, on one CUDA card.

    python3 scripts/ab_port_kernels.py OTHER_CHECKOUT [--rounds 2]

Each run is its own process importing one checkout's ``src`` (so each side
uses its own kernels, built into its own ``build/``).  Runs alternate
other, this, this, other, … for ``--rounds`` rounds.  Inputs: 20 SPD
matrices of 1024² in float64 from a seeded generator (the main path's
anchor batch, ``chip_smoke.py``'s timed shape), block 128.  Each run
prints one JSON line: the card's name and power limit, the mean ms of
each wrapper over 10 calls after a warm-up (CUDA events), and the
kernel's launches per call; the last line gives the median per side.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

CHILD = r"""
import json, subprocess, sys
sys.path.insert(0, "src")
import torch
from repro_torch.kernels import LAUNCHES, chol_blocked, reset_launches, tri_pack
dev = torch.device("cuda")
gen = torch.Generator(device=dev).manual_seed(0)
x = torch.randn(20, 2048, 1024, generator=gen, device=dev, dtype=torch.float64)
a = (x.mT @ x / 1024 + torch.eye(1024, device=dev, dtype=torch.float64)).contiguous()
l = torch.linalg.cholesky(a).contiguous()

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
print(json.dumps(dict(
    card=smi, cholesky_blocked_ms=timed(lambda: chol_blocked.cholesky_blocked(a, 128)),
    pack_tril_ms=timed(lambda: tri_pack.pack_tril(l, 128)),
    cholesky_launches=launches)))
"""


def run(side: str, root: Path) -> dict:
    out = subprocess.run([sys.executable, "-c", CHILD], cwd=root,
                         capture_output=True, text=True)
    if out.returncode:
        raise SystemExit(f"{side} ({root}) failed:\n{out.stderr[-3000:]}")
    rec = dict(json.loads(out.stdout.strip().splitlines()[-1]), side=side)
    print(json.dumps(rec), flush=True)
    return rec


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
                      for k in ("cholesky_blocked_ms", "pack_tril_ms")}
               for side in ("other", "this")}
    print(json.dumps(dict(median=summary)), flush=True)


if __name__ == "__main__":
    main()
