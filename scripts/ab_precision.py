#!/usr/bin/env python3
"""Run the bf16 policies' sweeps (``chip_smoke.py`` phase ``precision``) of
this checkout and of another, in turns, on one CUDA card.

    python3 scripts/ab_precision.py OTHER_CHECKOUT [--rounds 1]

Each run is its own process, started in one checkout, that imports that
checkout's ``chip_smoke`` (and its ``src``) and runs its phases ``build``
and ``precision`` at the repo's configuration (h=1024, n=4096, k=5, q=31,
g=4, r=2, block=128): per bf16 sweep its launches, λ*, deviation from
fp32's curve, wall medians of 5 and one profiled run's device split (the
mixed Cholesky's three kernels, the cluster solves' device ms), and the
Table-4 fixture under ``bf16_refined``.  Runs alternate other, this, this,
other for ``--rounds`` rounds.  Output: the card's ``nvidia-smi`` name and
power limit, then per run the precision phase's JSON line with ``side``
(``this`` or ``other``) added.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

CHILD = r"""
import sys
sys.path.insert(0, "src")
sys.path.insert(0, ".")
import torch
import chip_smoke
dev = torch.device("cuda")
chip_smoke.phase_build()
folds, lams = chip_smoke.main_inputs(dev)
chip_smoke.phase_precision(dev, folds, lams)
"""


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("other", type=Path)
    ap.add_argument("--rounds", type=int, default=1)
    args = ap.parse_args()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    sides = {"this": ROOT, "other": args.other.resolve()}
    for r in range(args.rounds):
        for side in ("other", "this", "this", "other"):
            out = subprocess.run([sys.executable, "-c", CHILD],
                                 cwd=sides[side], capture_output=True,
                                 text=True)
            if out.returncode:
                raise SystemExit(f"{side}: {out.stderr[-4000:]}")
            for line in out.stdout.splitlines():
                if line.startswith("{") and '"phase": "precision"' in line:
                    print(json.dumps(dict(side=side, round=r,
                                          **json.loads(line))), flush=True)


if __name__ == "__main__":
    main()
