#!/usr/bin/env python3
"""Time sources of the scan's backward kernel (kernel A, the C interface of
``src/repro_torch/kernels/csrc/ssm_scan_bwd.cu``) against each other, in
turns, on one CUDA card, in each of its modes, and hold each to the plain
backward.

    python3 scripts/ab_mamba_scan_bwd.py [SOURCE.cu ...]

Builds the checkout's source, the variants of it in :data:`VARIANTS` (each
made by text substitutions; what a step of the design is worth), and each
source given as an argument (for instance the file of another checkout),
by ``nvcc`` with the port's flags against the port's headers into
``build/ab_mamba_scan_bwd/``:

- ``exp_twice``: the adjoint forms each decay again instead of taking it
  from the recompute's registers;
- ``no_overlap``: the loads of segment k-1 go out right before they are
  stored, not a segment ahead;
- ``exp_twice_no_overlap``: both;
- ``states_in_registers``: a lane keeps the segment's states in registers
  too, not in shared memory, at one block an SM (up to 255 registers);

and the probes in :data:`PROBES`, whose outputs are timed but not held
(some are wrong by design):

- ``no_reduce``: no reduce-scatter of dB | dC over the warp's channels
  (what the shuffles cost; dB and dC wrong);
- ``no_finish``: no segment finished (dz, dx, d dt_lin, the dB | dC
  partials not written);
- ``no_recompute``, ``no_adjoint``: a segment's steps forward, or back,
  left out (what each costs);
- ``no_fetch``, ``no_deposit``: the loads of a segment, or their store
  into shared memory, left out;
- ``ch32``: 32 channels a block (128 threads, four blocks an SM);
- ``one_block``: one block an SM, so up to 255 registers a thread.

The wrapper ``ssm_scan.mamba_scan_bwd`` is pointed at each library in turn
(all of them, then the same in reverse) and timed at the training shape
(4 × 2048 × 8192 × 16, bf16; CUDA events, mean of 5 after a warm-up) in
its checkpoint mode (on the segment states of the checkout's forward
kernel; a source without the ``rt_mamba_scan_bwd_ckpt_*`` entries has none)
and in its self-walk mode, every gradient held to the plain version at
``chip_smoke``'s limits.  Then each source is held to the plain version at
ragged and small shapes, in float32 and bf16, in each mode, the two modes
to each other bit for bit.  A source must keep the wrapper's scratch
sizes (``BWD_SEGMENT`` steps a checkpoint, ``BWD_CHANNELS`` channels a
block).  Prints the card's ``nvidia-smi`` line, each source's ``ptxas``
line at N = 16, one JSON line per timed run and one per source with its
checks.
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
from repro_torch.kernels import _build, ref, ssm_scan  # noqa: E402

OUT = ROOT / "build" / "ab_mamba_scan_bwd"
SOURCE = _build.CSRC / "ssm_scan_bwd.cu"
CHECKS = ((chip_smoke.SCAN_RAGGED, True), ((2, 37, 130, 8), True),
          ((2, 9, 64, 32), True), ((3, 17, 70, 3), False))

# the adjoint's decay; the fetch of segment k-2 and the deposit of
# segment k-1
DECAY = "const float abar = ab[s][i];"
FETCH = "    if (k > 1) ahead.fetch(p, b, c0, k - 2, tid, true);\n"
DEPOSIT = ("    if (k > 0) rw.deposit(buf_of(k - 1), ck_of(k - 1), bias, tid, "
           "true);\n")
LATE = ("    if (k > 0) {\n      rw.fetch(p, b, c0, k - 1, tid, true);\n"
        "      rw.deposit(buf_of(k - 1), ck_of(k - 1), bias, tid, true);\n"
        "    }\n")
EXP_TWICE = [(DECAY, "const float abar = ex2_approx(r.x * a2[i]);")]
NO_OVERLAP = [(FETCH, ""), (DEPOSIT, LATE)]
PER_SM = "kBlocksPerSm = NP <= 16 ? 2 : 1;"
IN_REGISTERS = [
    ("float h[SPL], ab[kSeg][SPL];",
     "float h[SPL], ab[kSeg][SPL], hr[kSeg][SPL];"),
    ("sts(hs + s * kBwdChannels * NP, h);",
     "for (int i = 0; i < SPL; ++i) hr[s][i] = h[i];"),
    ("lds(hs + s * kBwdChannels * NP, hp);",
     "for (int i = 0; i < SPL; ++i) hp[i] = hr[s][i];"),
    ("static constexpr int ck = sh + kSeg * kBwdChannels * NP;",
     "static constexpr int ck = sh;"),
    (PER_SM, "kBlocksPerSm = 1;")]
VARIANTS = {"exp_twice": EXP_TWICE, "no_overlap": NO_OVERLAP,
            "exp_twice_no_overlap": EXP_TWICE + NO_OVERLAP,
            "states_in_registers": IN_REGISTERS}
CHANNELS = "constexpr int kBwdChannels = 64;"
PROBES = {
    "no_reduce": [("reduce_channels<V>(vals, lane);", "")],
    "no_finish": [("if (k + 1 < nseg) finish(k + 1);", "")],
    "no_recompute": [("    for (int s = 0; s < kSeg; ++s) {\n      // step s",
                      "    for (int s = 0; s < 0; ++s) {\n      // step s")],
    "no_adjoint": [("for (int s = kSeg - 1; s >= 0; --s) {",
                    "for (int s = kSeg - 1; s >= kSeg; --s) {")],
    "no_fetch": [(FETCH, "")],
    "no_deposit": [(DEPOSIT, "")],
    "ch32": [(CHANNELS, "constexpr int kBwdChannels = 32;"),
             (PER_SM, "kBlocksPerSm = NP <= 16 ? 4 : 2;")],
    "one_block": [(PER_SM, "kBlocksPerSm = 1;")],
}
#: channels a block, where a variant changes them (the wrapper's scratch)
BLOCK_CHANNELS = {"ch32": 32}


def variant_source(edits) -> str:
    code = SOURCE.read_text()
    for old, new in edits:
        if code.count(old) != 1:
            raise SystemExit(f"variant edit not found once: {old!r}")
        code = code.replace(old, new)
    return code


def build(sources: dict) -> dict:
    """Every source at once, one nvcc each; the checkout's own through
    ``_build``.  ``sources``: name → path.  Returns name → loaded
    library."""
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, src) in enumerate(sources.items()):
        lib = OUT / f"lib{i}_{Path(src).stem}.so"
        procs[name] = (lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
             "-o", str(lib), str(src)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    _build.build_all(["ssm_scan", "ssm_scan_bwd"])
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


def has_ckpt(lib) -> bool:
    return hasattr(lib, "rt_mamba_scan_bwd_ckpt_bf16")


def inputs(dev, shape, dtype, h0: bool):
    """chip_smoke's inputs of kernel A and the checkout's forward states."""
    ins = chip_smoke.mixer_inputs(dev, *shape, dtype, h0=h0)
    gen = torch.Generator(device=dev).manual_seed(5)
    dy = torch.randn(*shape[:3], generator=gen, device=dev).to(dtype)
    dh_last = torch.randn(shape[0], shape[2], shape[3], generator=gen,
                          device=dev) if h0 else None
    states = ssm_scan.mamba_scan(*ins, states=True)[2]
    return (*ins[:8], dy, ins[8], dh_last), states


def modes(lib) -> tuple:
    return ("ckpt", "walk") if has_ckpt(lib) else ("walk",)


def run(args, states, mode):
    return ssm_scan.mamba_scan_bwd(
        *args, states=states if mode == "ckpt" else None)


def use(name: str, libs: dict) -> None:
    """Point the wrapper at source ``name``'s library."""
    _build._LIBS["ssm_scan_bwd"] = libs[name]
    ssm_scan.BWD_CHANNELS = BLOCK_CHANNELS.get(name, 64)


def check(dev, shape, dtype, h0: bool, lib) -> dict:
    """Each mode against the plain version (chip_smoke's limits), the same
    bits twice, and the modes the same bits."""
    args, states = inputs(dev, shape, dtype, h0)
    want = ref.mamba_scan_bwd(*args)
    got, out = {}, {}
    for mode in modes(lib):
        got[mode] = run(args, states, mode)
        twice = chip_smoke._bitwise(got[mode], run(args, states, mode))
        out[mode] = chip_smoke._bwd_errors(got[mode], want, dtype)[1] \
            and twice
    if len(got) == 2:
        out["ckpt_equals_walk"] = chip_smoke._bitwise(*got.values())
    return out


def main() -> None:
    chip_smoke.phase_device()
    OUT.mkdir(parents=True, exist_ok=True)
    sources = {}
    for name, edits in {**VARIANTS, **PROBES}.items():
        sources[name] = OUT / f"{name}.cu"
        sources[name].write_text(variant_source(edits))
    sources.update({str(s): s for s in sys.argv[1:]})
    libs = build(sources)
    dev = torch.device("cuda")
    shape, dtype = chip_smoke.SCAN_SHAPE, torch.bfloat16
    args, states = inputs(dev, shape, dtype, False)
    want = ref.mamba_scan_bwd(*args)
    order = list(libs) + list(libs)[::-1]
    for name in order:
        use(name, libs)
        for mode in modes(libs[name]):
            got = run(args, states, mode)
            ok = (chip_smoke._bwd_errors(got, want, dtype)[1]
                  if name not in PROBES or name in BLOCK_CHANNELS else None)
            del got
            ms = chip_smoke.timed_ms(lambda: run(args, states, mode), 5)
            print(json.dumps({"source": name, "mode": mode, "ms": ms,
                              "ok": ok, "shape": list(shape)}), flush=True)
    del args, states, want
    torch.cuda.empty_cache()
    for name, lib in libs.items():
        if name in PROBES and name not in BLOCK_CHANNELS:
            continue
        use(name, libs)
        checks = {f"{shape}-{dtype}": check(dev, shape, dtype, h0, lib)
                  for shape, h0 in CHECKS
                  for dtype in (torch.float32, torch.bfloat16)}
        print(json.dumps({"source": name, "checks_ok": all(
            all(v.values()) for v in checks.values()), "checks": checks}),
            flush=True)
    _build._LIBS.pop("ssm_scan_bwd")
    ssm_scan.BWD_CHANNELS = 64


if __name__ == "__main__":
    main()
