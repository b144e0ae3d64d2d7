#!/usr/bin/env python3
"""Time sources of the causal convolution's kernels (the forward and its
backward, kernel B: the C interface of
``src/repro_torch/kernels/csrc/causal_conv1d.cu``) against each other, in
turns, on one CUDA card, and hold each to the plain versions.

    python3 scripts/ab_causal_conv1d.py [--no-variants | --only=A,B]
                                        [SOURCE.cu ...]

Builds the checkout's source, the variants of it in :data:`VARIANTS` and
the probes in :data:`PROBES` (each made by text substitutions), and each
source given as an argument (for instance the file of another checkout:
``git show <rev>:src/repro_torch/kernels/csrc/causal_conv1d.cu >
build/parent/causal_conv1d.cu``; ``--only`` keeps the named variants and
probes, ``--no-variants`` none), one ``nvcc`` each, all started together,
with the port's flags against the port's headers, into
``build/ab_causal_conv1d/``.  A source without ``rt_causal_conv1d_segment``
is taken for the first design's interface (no variant argument, 64-step
strips of the backward).

Variants (what a choice of the design is worth):

- ``prefetch``: the staged route fed by the threads' own loads a tile
  ahead in registers (the generic variant's row source with vector loads),
  not by the bulk-copy ring;
- ``f32_slots``: float32 slots of bf16's rows, not twice as many;
- ``stages2``, ``stages4``: ring depth;
- ``tile8``, ``tile32``: rows a slot holds, forward; ``bwd_tile16``:
  backward (float32 twice as many, but 32 and 16 in both dtypes);
- ``ch512``: 8 bytes of a row a thread (4 bf16, 2 float32 channels), a
  channel tile of 1 KB; ``threads256``: 256 threads a block, a channel
  tile of 1 KB at 4 bytes a thread;
- ``seg128``, ``seg512``: steps a unit walks;
- ``bwd_8_blocks``: the backward held to 64 registers, 8 blocks an SM;
- ``elem_round``: each rounding to bf16 its own conversion, not two values
  packed by one;
- ``guarded``: every step behind its guards, no unguarded path for a whole
  tile inside the segment.

Probes, timed but not held (their outputs are wrong by design):

- ``no_loads``: the ring's slots are signalled without their copies (what
  the arithmetic and stores cost alone);
- ``no_silu``: silu and its gradient left out (what the exponential and
  the IEEE division cost);
- ``no_store``: the outputs of a whole tile not stored (what the reads
  and arithmetic cost without the writes);
- ``no_math``: the forward writes its input, the backward takes dpre =
  dout + x (what the bytes cost alone);
- ``no_sum`` (the checkout's library, run without the second launch):
  what the fixed-order sum of the partials costs.

Checks first: each non-probe source against the plain versions
(``ref.causal_conv1d_silu`` and ``ref.causal_conv1d_silu_bwd``) at ragged
and small shapes in float32 and bf16, a base off by one element among them:
xc, the new state, dx and dstate bit for bit, dw and db within
``chip_smoke.CONV_BWD_TOL`` of max |plain|, the same bits on two calls.
Then every source is timed in turns (all of them, then the same in
reverse), forward and backward at 4 × 2048 × 8192 in bf16 and float32
(CUDA events, mean of 10 after a warm-up).  Prints the card's
``nvidia-smi`` line, each source's ``ptxas`` lines, one JSON line per
source with its checks and one per timed run (``source``, ``kernel``,
``dtype``, ``ms``, ``tb_s``: bytes moved over time).
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
from repro_torch.kernels import _build, causal_conv1d, ref  # noqa: E402

OUT = ROOT / "build" / "ab_causal_conv1d"
SOURCE = _build.CSRC / "causal_conv1d.cu"
K = causal_conv1d.WIDTH
SHAPE = (4, 2048, 8192)
# (shape, state, offset in elements of every tensor's base): S not a
# multiple of a tile, S < K-1 from a state, C not a multiple of the channel
# tile, a segment boundary inside a row, C·itemsize not a multiple of 16
# bytes (generic), a misaligned base (generic), decode
CHECKS = (((3, 999, 8100), True, 0), ((1, 300, 8200), True, 0),
          ((2, 2, 8192), True, 0), ((2, 37, 130), True, 0),
          ((2, 70, 130), False, 0), ((2, 530, 520), True, 1),
          ((3, 1, 8192), True, 0))
STAGED_FWD = ("using StagedFwdRows = RingRows<T, 1, kTileRows * "
              "(sizeof(T) == 4 ? 2 : 1)>;")
STAGED_BWD = ("RingRows<T, 2, kBwdTileRows * (sizeof(T) == 4 ? 2 : 1)>;")
# float32 slots of bf16's rows
NO_F32_ROWS = [
    (STAGED_FWD, "using StagedFwdRows = RingRows<T, 1, kTileRows>;"),
    (STAGED_BWD, "RingRows<T, 2, kBwdTileRows>;")]
PAIRS = "if constexpr (std::is_same_v<T, __nv_bfloat16> && V % 2 == 0) {"
BWD_BOUNDS = ("__launch_bounds__(kConvThreads)\n"
              "causal_conv1d_silu_bwd_kernel")
VARIANTS = {
    "prefetch": [
        (STAGED_FWD, "using StagedFwdRows = DirectRows<T, 1, kTileRows, "
                     "true>;"),
        (STAGED_BWD, "DirectRows<T, 2, kBwdTileRows, true>;")],
    "f32_slots": NO_F32_ROWS,
    "stages2": [("constexpr int kStages = 3;", "constexpr int kStages = 2;")],
    "stages4": [("constexpr int kStages = 3;", "constexpr int kStages = 4;")],
    "tile8": [("constexpr int kTileRows = 16;",
               "constexpr int kTileRows = 8;")],
    "tile32": [("constexpr int kTileRows = 16;",
                "constexpr int kTileRows = 32;"), NO_F32_ROWS[0]],
    "bwd_tile16": [("constexpr int kBwdTileRows = 8;",
                    "constexpr int kBwdTileRows = 16;"), NO_F32_ROWS[1]],
    "ch512": [("constexpr int kThreadBytes = 4;",
               "constexpr int kThreadBytes = 8;")],
    "seg128": [("constexpr int kSegment = 256;",
                "constexpr int kSegment = 128;")],
    "seg512": [("constexpr int kSegment = 256;",
                "constexpr int kSegment = 512;")],
    "bwd_8_blocks": [(BWD_BOUNDS, BWD_BOUNDS.replace(
        "(kConvThreads)", "(kConvThreads, 8)"))],
    "threads256": [("constexpr int kConvThreads = 128;",
                    "constexpr int kConvThreads = 256;")],
    "elem_round": [(PAIRS, "if constexpr (false) {")],
    "guarded": [("if (n == TT) {   // a whole tile: no step's guard",
                 "if (false) {"),
                ("if (n == TT && t0 >= u.s0 + K - 1 && t0 + TT <= u.s1) {",
                 "if (false) {")],
}
PROBES = {
    "no_loads": [
        ("if (lane == 0) mbar_expect_tx(&sh.full[slot], NT * rows * bytes);",
         "if (lane == 0) mbar_expect_tx(&sh.full[slot], 0);"),
        ("    if (n < NT && r < rows)\n      bulk_copy(",
         "    if (false)\n      bulk_copy(")],
    "no_silu": [
        ("y[i] = silu_f32(y[i]);", "y[i] = y[i];"),
        ("dnew[i] = silu_grad_f32(dov[i], dnew[i]);",
         "dnew[i] = dov[i] * dnew[i];")],
    "no_store": [
        ("store_elems<T, V, Vec>(o, u.nv, y);",
         "if (y[0] == 1234.5f) store_elems<T, V, Vec>(o, u.nv, y);"),
        ("store_elems<T, V, Vec>(d, u.nv, v);",
         "if (v[0] == 1234.5f) store_elems<T, V, Vec>(d, u.nv, v);")],
    "no_math": [
        ("pre_acts<T, K, V>(win, cur, w, bias, y);\n#pragma unroll\n"
         "        for (int i = 0; i < V; ++i) y[i] = silu_f32(y[i]);",
         "for (int i = 0; i < V; ++i) y[i] = cur[i];"),
        ("pre_acts<T, K, V>(win, cur, w, bias, dnew);\n#pragma unroll\n"
         "        for (int i = 0; i < V; ++i) dnew[i] = silu_grad_f32(dov[i], "
         "dnew[i]);",
         "for (int i = 0; i < V; ++i) dnew[i] = dov[i] + cur[i];")],
}
SUM_PROBE = "no_sum"


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
    _build.build_all(["causal_conv1d"])
    libs = {"this": _build.load("causal_conv1d")}
    logs = {"this": _build._target("causal_conv1d").with_suffix(".log")
            .read_text()}
    for name, (lib, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{log[-4000:]}")
        libs[name], logs[name] = ctypes.CDLL(str(lib)), log
    for name, log in logs.items():
        for r in chip_smoke.ptxas_lines(log):
            if "reduce" not in r["kernel"]:
                print(f"ptxas {name}: {r['kernel']}: {r.get('used', '')}; "
                      f"{r.get('spills', '')}", flush=True)
    return libs


class Lib:
    """One source's C entries, called on preallocated tensors."""

    def __init__(self, lib):
        self.lib = lib
        self.new = hasattr(lib, "rt_causal_conv1d_segment")
        self.segment = lib.rt_causal_conv1d_segment() if self.new else 64
        extra = [ctypes.c_int] if self.new else []
        for dtype in ("f32", "bf16"):
            getattr(lib, f"rt_causal_conv1d_silu_{dtype}").argtypes = (
                [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + extra
                + [ctypes.c_void_p])
            getattr(lib, f"rt_causal_conv1d_silu_bwd_{dtype}").argtypes = (
                [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + extra
                + [ctypes.c_void_p])
        lib.rt_causal_conv1d_bwd_reduce.argtypes = (
            [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p])

    def _variant(self, s, c, dtype, tensors) -> list:
        if not self.new:
            return []
        v = causal_conv1d.variant(s, c, dtype, [
            None if t is None else t.data_ptr() for t in tensors])
        return [causal_conv1d.VARIANTS.index(v)]

    def fwd(self, x, w, b, st, out, ns) -> None:
        bsz, s, c = x.shape
        fn = getattr(self.lib, "rt_causal_conv1d_silu_"
                     + _build.suffix(x.dtype))
        rc = fn(x.data_ptr(), w.data_ptr(), b.data_ptr(),
                None if st is None else st.data_ptr(), out.data_ptr(),
                ns.data_ptr(), bsz, s, c, K,
                *self._variant(s, c, x.dtype, (x, st, out, ns)),
                torch.cuda.current_stream().cuda_stream)
        _build.check(rc, "fwd")

    def parts(self, bsz, s) -> int:
        return bsz * max(-(-s // self.segment), 1)

    def bwd(self, x, w, b, st, dout, dx, dst, part, dw, db,
            reduce: bool = True) -> None:
        bsz, s, c = x.shape
        stream = torch.cuda.current_stream().cuda_stream
        fn = getattr(self.lib, "rt_causal_conv1d_silu_bwd_"
                     + _build.suffix(x.dtype))
        rc = fn(x.data_ptr(), w.data_ptr(), b.data_ptr(),
                None if st is None else st.data_ptr(), dout.data_ptr(),
                dx.data_ptr(), None if dst is None else dst.data_ptr(),
                part.data_ptr(), bsz, s, c, K,
                *self._variant(s, c, x.dtype, (x, dout, st, dx, dst)),
                stream)
        _build.check(rc, "bwd")
        if reduce:
            rc = self.lib.rt_causal_conv1d_bwd_reduce(
                part.data_ptr(), dw.data_ptr(), db.data_ptr(),
                self.parts(bsz, s), c, K, stream)
            _build.check(rc, "reduce")


def inputs(dev, shape, dtype, state: bool, offset: int = 0):
    b, s, c = shape
    gen = torch.Generator(device=dev).manual_seed(6)
    x = torch.randn(b, s, c, generator=gen, device=dev).to(dtype)
    w = (0.5 * torch.randn(c, K, generator=gen, device=dev)).to(dtype)
    bias = (0.1 * torch.randn(c, generator=gen, device=dev)).to(dtype)
    dout = torch.randn(b, s, c, generator=gen, device=dev).to(dtype)
    st = torch.randn(b, K - 1, c, generator=gen, device=dev).to(dtype) \
        if state else None
    at = chip_smoke.offset_view
    x, dout = at(x, offset), at(dout, offset)
    st = None if st is None else at(st, offset)
    return x, w, bias, dout, st


def outputs(lib: Lib, x, st, offset: int = 0):
    b, s, c = x.shape
    dev, dtype = x.device, x.dtype
    at = chip_smoke.offset_view
    out = at(torch.empty_like(x), offset)
    ns = at(torch.empty(b, K - 1, c, dtype=dtype, device=dev), offset)
    dx = at(torch.empty_like(x), offset)
    dst = None if st is None else at(torch.empty_like(st), offset)
    part = torch.empty(lib.parts(b, s), c, K + 1, device=dev)
    dw = torch.empty(c, K, device=dev)
    db = torch.empty(c, device=dev)
    return out, ns, dx, dst, part, dw, db


def check(lib: Lib, dev, shape, dtype, state, offset) -> dict:
    x, w, b, dout, st = inputs(dev, shape, dtype, state, offset)
    out, ns, dx, dst, part, dw, db = outputs(lib, x, st, offset)
    lib.fwd(x, w, b, st, out, ns)
    got_f = (out.clone(), ns.clone())
    lib.fwd(x, w, b, st, out, ns)
    same_f = torch.equal(out, got_f[0]) and torch.equal(ns, got_f[1])
    want_f = ref.causal_conv1d_silu(x, w, b, st)
    lib.bwd(x, w, b, st, dout, dx, dst, part, dw, db)
    got_b = [t.clone() for t in (dx, dw, db) + ((dst,) if st is not None
                                                  else ())]
    lib.bwd(x, w, b, st, dout, dx, dst, part, dw, db)
    same_b = all(torch.equal(g, t) for g, t in zip(
        got_b, (dx, dw, db) + ((dst,) if st is not None else ())))
    want_b = ref.causal_conv1d_silu_bwd(x, w, b, dout, st)
    torch.cuda.synchronize()
    fwd_exact = torch.equal(got_f[0], want_f[0]) and torch.equal(
        got_f[1], want_f[1])
    bwd_exact = torch.equal(got_b[0], want_b[0]) and (
        st is None or torch.equal(got_b[3], want_b[3]))
    rel = max(float((g - v).abs().max()) / max(float(v.abs().max()), 1e-300)
              for g, v in zip(got_b[1:3], want_b[1:3]))
    ok = (fwd_exact and bwd_exact and same_f and same_b
          and rel <= chip_smoke.CONV_BWD_TOL)
    return dict(ok=ok, fwd_exact=fwd_exact, bwd_exact=bwd_exact,
                bitwise_twice=same_f and same_b, dw_db_rel=rel)


def work_bytes(shape, dtype, kernel: str) -> int:
    b, s, c = shape
    es = torch.empty((), dtype=dtype).element_size()
    if kernel == "fwd":
        return (2 * b * s * c + c * K + c + b * (K - 1) * c) * es
    return (3 * b * s * c + c * K + c) * es + c * (K + 1) * 4


def main() -> None:
    args = sys.argv[1:]
    edits = {**VARIANTS, **PROBES}
    if "--no-variants" in args:
        edits = {}
    only = [a.split("=", 1)[1].split(",") for a in args
            if a.startswith("--only=")]
    if only:
        edits = {n: e for n, e in edits.items() if n in only[0]}
    args = [a for a in args if not a.startswith("--")]
    chip_smoke.phase_device()
    OUT.mkdir(parents=True, exist_ok=True)
    sources = {}
    for name, edit in edits.items():
        sources[name] = OUT / f"{name}.cu"
        sources[name].write_text(variant_source(edit))
    sources.update({str(s): Path(s) for s in args})
    libs = {name: Lib(lib) for name, lib in build(sources).items()}
    dev = torch.device("cuda")
    bad = []
    for name, lib in libs.items():
        if name in PROBES:
            continue
        checks = {f"{shape}-{'state' if st else 'zeros'}-off{off}-{dt}":
                  check(lib, dev, shape, dtype, st, off)
                  for shape, st, off in CHECKS
                  for dt, dtype in (("f32", torch.float32),
                                    ("bf16", torch.bfloat16))}
        ok = all(c["ok"] for c in checks.values())
        print(json.dumps({"source": name, "checks_ok": ok,
                          "checks": checks}), flush=True)
        if not ok:
            bad.append(name)
    runs = [(n, False) for n in libs] + [("this", True)]
    order = runs + runs[::-1]
    for dt, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        x, w, b, dout, st = inputs(dev, SHAPE, dtype, False)
        for name, no_sum in order:
            lib = libs[name]
            out, ns, dx, dst, part, dw, db = outputs(lib, x, st)
            times = {}
            if not no_sum:
                times["fwd"] = chip_smoke.timed_ms(
                    lambda: lib.fwd(x, w, b, st, out, ns), 10)
            times["bwd"] = chip_smoke.timed_ms(
                lambda: lib.bwd(x, w, b, st, dout, dx, dst, part, dw, db,
                                reduce=not no_sum), 10)
            for kernel, ms in times.items():
                print(json.dumps({
                    "source": SUM_PROBE if no_sum else name,
                    "kernel": kernel, "dtype": dt, "ms": ms,
                    "tb_s": work_bytes(SHAPE, dtype, kernel) / ms / 1e9,
                    "shape": list(SHAPE)}), flush=True)
            del out, ns, dx, dst, part, dw, db
        del x, w, b, dout, st
        torch.cuda.empty_cache()
    if bad:
        raise SystemExit(f"sources disagree with the plain versions: {bad}")


if __name__ == "__main__":
    main()
