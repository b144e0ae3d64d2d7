#!/usr/bin/env python3
"""Time sources of the scan's backward kernel (kernel A, the C interface of
``src/repro_torch/kernels/csrc/ssm_scan_bwd.cu``) against each other, in
turns, on one CUDA card, and hold each to the plain backward.

    python3 scripts/ab_mamba_scan_bwd.py [SOURCE.cu ...]

Without arguments it times the checkout's own source; each argument is
another source of the same interface (for instance the file from another
checkout, or a variant of this one), built by ``nvcc`` with the port's
flags against the port's headers into ``build/ab_mamba_scan_bwd/``.  The
wrapper ``ssm_scan.mamba_scan_bwd`` is pointed at each library in turn
(this, the others, then the same in reverse), and
``chip_smoke.check_mamba_scan_bwd`` times it at the training shape
(4 × 2048 × 8192 × 16, bf16; CUDA events, mean of 5 after a warm-up) and
holds every gradient to the plain version.  Then each source is held to
the plain version at ragged and small shapes, in float32 and bf16.  A
source must keep the wrapper's scratch sizes (``BWD_SEGMENT`` steps a
checkpoint or more, ``BWD_CHANNELS`` channels a block).  Prints the card's
``nvidia-smi`` line, each source's ``ptxas`` line at N = 16, one JSON line
per timed run and one per source with its checks.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402

OUT = ROOT / "build" / "ab_mamba_scan_bwd"
CHECKS = ((chip_smoke.SCAN_RAGGED, True), ((2, 37, 130, 8), True),
          ((2, 9, 64, 32), True), ((3, 17, 70, 3), False))


def build(sources: list) -> dict:
    """Every source at once, one nvcc each; the checkout's own through
    ``_build``.  Returns name → loaded library."""
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, src in enumerate(sources):
        lib = OUT / f"lib{i}_{Path(src).stem}.so"
        procs[str(src)] = (lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
             "-o", str(lib), str(src)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    _build.build_all(["ssm_scan_bwd"])
    libs = {"this": _build.load("ssm_scan_bwd")}
    logs = {"this": _build._target("ssm_scan_bwd").with_suffix(".log")
            .read_text()}
    for name, (lib, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{log[-4000:]}")
        libs[name], logs[name] = ctypes.CDLL(str(lib)), log
    for name, log in logs.items():
        for r in chip_smoke.ptxas_lines(log):
            if "Li16E" in r["kernel"]:
                print(f"ptxas {name}: {r['kernel']}: {r.get('used', '')}; "
                      f"{r.get('spills', '')}", flush=True)
    return libs


def main() -> None:
    info = chip_smoke.phase_device()
    libs = build(sys.argv[1:])
    dev = torch.device("cuda")
    order = list(libs) + list(libs)[::-1]
    for name in order:
        _build._LIBS["ssm_scan_bwd"] = libs[name]
        r = chip_smoke.check_mamba_scan_bwd(dev, chip_smoke.SCAN_SHAPE,
                                            torch.bfloat16,
                                            timing=info["peaks"])
        print(json.dumps({"source": name, "ms": r["ms"],
                          "bound_ms": r["bound_ms"], "ok": r["ok"],
                          "bitwise_twice": r["bitwise_twice"]}), flush=True)
    for name, lib in libs.items():
        _build._LIBS["ssm_scan_bwd"] = lib
        checks = {f"{shape}-{dtype}": chip_smoke.check_mamba_scan_bwd(
            dev, shape, dtype, h0=h0)["ok"] for shape, h0 in CHECKS
            for dtype in (torch.float32, torch.bfloat16)}
        print(json.dumps({"source": name, "checks_ok": all(checks.values()),
                          "checks": checks}), flush=True)
    _build._LIBS.pop("ssm_scan_bwd")


if __name__ == "__main__":
    main()
