#!/usr/bin/env python3
"""Probes of the Mamba-1 scan kernel (``csrc/ssm_scan.cu``) on one CUDA card.

    python3 scripts/probe_ssm_scan.py

Times ``rt_ssm_scan_f32`` (the scan alone, float32) and ``rt_mamba_scan_bf16``
(the mixer entry, bf16) at the serve prefill's shape (B=4, S=2048,
d_inner=8192, N=16; the inputs of ``chip_smoke.py``) for the kernel as
committed and for variants of its source, each made by one text
substitution and compiled with the port's nvcc flags into ``build/probe/``:

- ``no_exp``: each decay's ``ex2.approx`` replaced by an FMA (what the
  exponentials cost);
- ``no_load``: chunks past the first two neither fetched nor stored (what
  the global loads cost; the outputs are wrong);
- ``libm``: the mixer's softplus and silu by the math library (``expf``,
  ``log1pf``, IEEE division) instead of ``softplus_fast``/``silu_fast``;
- ``ch64``, ``ch256``: 64 or 256 channels a block instead of 128;
- ``steps16``: chunks of 16 steps instead of 8.

Then, for the kernel as committed, ``clock64`` stamps of warp 0 of the first
16 blocks of batch row 0 over one run: cycles a chunk at the barrier, in
the fetch and the store and prep of the neighbouring chunks, in the scan and
in storing the fetched chunk, and the SM clock they imply.  Times are means
of 10 calls between CUDA events after a warm-up, two rounds in turns.
Prints JSON lines, then the card's ``nvidia-smi`` name and power limit.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from repro_torch.kernels import _build, ssm_scan  # noqa: E402

OUT = ROOT / "build" / "probe"
SOURCE = _build.CSRC / "ssm_scan.cu"

EXP = "h[j][k2] = fmaf(ex2_approx(dtv[j] * a2[j][k2]), h[j][k2],"
FETCH = "    if (k + 2 < n_chunks)\n      ahead.fetch("
DEPOSIT = "    if (k + 2 < n_chunks)\n      ahead.deposit("
SOFTPLUS = "dtv = Mixer ? softplus_fast(v + bias[i % kCpt]) : v;"
SILU = "silu_fast(to_f32(sz[e]))"
CHANNELS = "constexpr int kScanChannels = 128;"
STEPS = "constexpr int kScanSteps = 8;"
LIBM = """
__device__ __forceinline__ float softplus_libm(float v) {
  return v > 20.f ? v : log1pf(expf(v));
}
"""
VARIANTS = {
    "committed": [],
    "no_exp": [(EXP, "h[j][k2] = fmaf(1.f + dtv[j] * a2[j][k2], h[j][k2],")],
    "no_load": [(FETCH, FETCH.replace("n_chunks)", "n_chunks && k < 0)")),
                (DEPOSIT, DEPOSIT.replace("n_chunks)", "n_chunks && k < 0)"))],
    "libm": [("struct ScanArgs {", LIBM + "struct ScanArgs {"),
             (SOFTPLUS,
              "dtv = Mixer ? softplus_libm(v + bias[i % kCpt]) : v;"),
             (SILU, "silu_f32(to_f32(sz[e]))")],
    "ch64": [(CHANNELS, "constexpr int kScanChannels = 64;")],
    "ch256": [(CHANNELS, "constexpr int kScanChannels = 256;")],
    "steps16": [(STEPS, "constexpr int kScanSteps = 16;")],
}
STAMPED = [
    ("struct ScanArgs {",
     "__device__ long long g_stamps[16][512][4];\n#define STAMP(k, i) "
     "if (tid == 0 && blockIdx.y == 0 && blockIdx.x < 16 && (k) < 512) "
     "g_stamps[blockIdx.x][k][i] = clock64();\nstruct ScanArgs {"),
    ("  for (int k = 0; k < n_chunks; ++k) {\n",
     "  for (int k = 0; k < n_chunks; ++k) {\n    STAMP(k, 0)\n"),
    ("    Staged<T, Mixer, NP> ahead;\n",
     "    STAMP(k, 1)\n    Staged<T, Mixer, NP> ahead;\n"),
    ("    // the scan of chunk k:",
     "    STAMP(k, 2)\n    // the scan of chunk k:"),
    (DEPOSIT, "    STAMP(k, 3)\n" + DEPOSIT),
]

READ_STAMPS = """
extern "C" int rt_read_stamps(void* dst) {
  return (int)cudaMemcpyFromSymbol(dst, g_stamps, sizeof(g_stamps));
}
"""


def variant_source(edits) -> str:
    code = SOURCE.read_text()
    for old, new in edits:
        if code.count(old) != 1:
            raise SystemExit(f"probe_ssm_scan: {old!r} is not in "
                             f"{SOURCE.name} exactly once")
        code = code.replace(old, new)
    return code


def compile_all(sources: dict) -> dict:
    """Every source at once, one nvcc each, against the port's headers."""
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, code in sources.items():
        (OUT / f"scan_{name}.cu").write_text(code)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o",
             str(OUT / f"libscan_{name}.so"), str(OUT / f"scan_{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{log[-4000:]}")
        libs[name] = ctypes.CDLL(str(OUT / f"libscan_{name}.so"))
    return libs


def runners(lib, dev):
    """(scan alone, mixer entry) of ``lib`` on chip_smoke's inputs."""
    b, s, di, n = chip_smoke.SCAN_SHAPE
    ins = [t.contiguous() for t in chip_smoke.scan_inputs(dev, b, s, di, n)]
    xc, dt_lin, dt_bias, bm, cm, a, d, z, _ = chip_smoke.mixer_inputs(
        dev, b, s, di, n, torch.bfloat16)
    dt_bias, d = dt_bias.float().contiguous(), d.float().contiguous()
    y = torch.empty(b, s, di, device=dev)
    yb = torch.empty(b, s, di, device=dev, dtype=torch.bfloat16)
    h = torch.empty(b, di, n, device=dev)
    scan_fn, mixer_fn = lib.rt_ssm_scan_f32, lib.rt_mamba_scan_bf16
    scan_fn.argtypes, mixer_fn.argtypes = ssm_scan._ARGS, ssm_scan._MIXER_ARGS
    ptr, stream = _build.ptr, _build.stream_ptr(dev)

    def scan():
        _build.check(scan_fn(*(ptr(t) for t in ins), ptr(y), ptr(h), b, s,
                             di, n, stream), "scan")

    def mixer():
        _build.check(mixer_fn(ptr(xc), ptr(dt_lin), ptr(dt_bias), ptr(bm),
                              ptr(cm), bm.stride(0), bm.stride(1), ptr(a),
                              ptr(d), ptr(z), None, ptr(yb), ptr(h), b, s, di,
                              n, stream), "mixer")
    return scan, mixer


def main() -> None:
    dev_info = chip_smoke.phase_device()
    dev = torch.device("cuda")
    sources = {name: variant_source(edits)
               for name, edits in VARIANTS.items()}
    sources["stamped"] = variant_source(STAMPED) + READ_STAMPS
    libs = compile_all(sources)
    fns = {name: runners(lib, dev) for name, lib in libs.items()
           if name != "stamped"}
    times = {name: {"scan_ms": [], "mixer_ms": []} for name in fns}
    for _ in range(2):
        for name, (scan, mixer) in fns.items():
            times[name]["scan_ms"].append(chip_smoke.timed_ms(scan, 10))
            times[name]["mixer_ms"].append(chip_smoke.timed_ms(mixer, 10))
    print(json.dumps({"probe": "variants", "shape": chip_smoke.SCAN_SHAPE,
                      "times": times}), flush=True)

    lib = libs["stamped"]
    read = lib.rt_read_stamps
    read.argtypes = [ctypes.c_void_p]
    stamps = np.zeros((16, 512, 4), np.int64)
    for tag, fn in zip(("scan", "mixer"), runners(lib, dev)):
        ms = chip_smoke.timed_ms(fn, 10)
        fn()
        torch.cuda.synchronize()
        _build.check(read(stamps.ctypes.data_as(ctypes.c_void_p)), "stamps")
        g = stamps[:, 2:250]                     # steady chunks
        per_chunk = float(np.diff(g[..., 0], axis=1).mean())
        chunks = -(-chip_smoke.SCAN_SHAPE[1] // 8)
        print(json.dumps({
            "probe": "stamps", "entry": tag, "ms": ms,
            "cycles_per_chunk": {
                "barrier": float((g[..., 1] - g[..., 0]).mean()),
                "fetch_store_prep": float((g[..., 2] - g[..., 1]).mean()),
                "scan": float((g[..., 3] - g[..., 2]).mean()),
                "deposit": float((g[:, 1:, 0] - g[:, :-1, 3]).mean()),
                "total": per_chunk},
            "sm_clock_ghz": per_chunk * chunks / (ms * 1e6)}), flush=True)
    print(dev_info["smi"], flush=True)


if __name__ == "__main__":
    main()
