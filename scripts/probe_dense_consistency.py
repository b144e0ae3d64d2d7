#!/usr/bin/env python3
"""Which products of the dense family's decode step compute other bits than
the forward's, and how far decode drifts from the forward, on one CUDA card.

    python3 scripts/probe_dense_consistency.py [--rows N] [ARCH ...]

``chip_smoke.py``'s ``dense_serve`` prefills 4 prompts of 2048 tokens,
decodes 32 greedy steps and runs a forward over the extended sequences,
and holds the decode logits at the last position to the forward's (max
|Δ| / max |forward| ≤ ``SERVE_TOL``).  A decode step runs each bf16 product
on 4 rows where the prefill and the forward run it on 8192; cuBLAS may pick
kernels that sum in another order for so few rows (the Mamba mixer pads its
products to ``blocks._MIN_ROWS`` for that reason).  For each configuration
(default: the four dense ones, at their published widths, seeded bf16
weights) this prints:

- ``products``: each product of a decode step (``attn.wq``, ``attn.wk``,
  ``attn.wv``, ``attn.wo``; the MLP's three products as ``mlp``, the key
  ``blocks._MIN_ROWS`` pads them under; ``lm_head``) on the last position
  of each of the 4 rows of a (4, 2048) input, computed alone and padded
  with zero rows to 8 … 4096 rows, against the same rows inside the
  product over all 8192 rows: the share of outputs that differ in any bit
  at each row count, and the least row count from which on they never
  differ;
- ``drift``: ``chip_smoke.dense_serve``'s run (decode against forward at
  every position) with ``blocks._MIN_ROWS`` as committed and, unless it
  already pads them all, with every dense product padded to ``--rows``
  (default 1024), and the decode ms a step of each.

Last, the card's ``nvidia-smi`` name and power limit.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402

LADDER = (8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096)
DENSE_KEYS = ("attn.wq", "attn.wk", "attn.wv", "attn.wo", "mlp")


def _emit(**fields) -> None:
    print(json.dumps(fields), flush=True)


@torch.no_grad()
def products(arch: str, dev) -> dict:
    """Bitwise agreement of each decode product with the forward's rows."""
    from repro_torch import configs
    from repro_torch.models import layers
    cfg = configs.get(arch)
    bf16, gen = torch.bfloat16, torch.Generator(device=dev).manual_seed(7)
    b, s, d, f = chip_smoke.SERVE_BATCH, chip_smoke.SERVE_PROMPT, \
        cfg.d_model, cfg.d_ff
    hq = cfg.n_heads * cfg.head_dim_
    hkv = cfg.n_kv_heads * cfg.head_dim_

    def randn(*shape, scale=1.0):
        return (scale * torch.randn(shape, generator=gen, device=dev)).to(
            bf16)

    wi, wg, wo = randn(d, f, scale=0.02), randn(d, f, scale=0.02), \
        randn(f, d, scale=0.02)
    fns = {
        "attn.wq": (d, lambda x, w=randn(d, hq, scale=0.02): x @ w),
        "attn.wk": (d, lambda x, w=randn(d, hkv, scale=0.02): x @ w),
        "attn.wv": (d, lambda x, w=randn(d, hkv, scale=0.02): x @ w),
        "attn.wo": (hq, lambda x, w=randn(hq, d, scale=0.02): x @ w),
        "mlp": (d, lambda x: layers.mlp(x, wi, wo, wg, cfg.act)),
        "lm_head": (d, lambda x, w=randn(d, cfg.vocab_size, scale=0.02):
                    x @ w),
    }
    out = {}
    for name, (k, fn) in fns.items():
        x = randn(b, s, k)
        full = fn(x)[:, -1]                       # (B, N) inside 8192 rows
        last = x[:, -1:]                          # the decode step's rows
        share = {"alone": float((fn(last)[:, 0] != full).float().mean())}
        for rows in LADDER:
            padded = torch.nn.functional.pad(last, (0, 0, 0, 0, 0, rows - b))
            share[rows] = float((fn(padded)[:b, 0] != full).float().mean())
        clean = [r for r in LADDER
                 if all(share[q] == 0.0 for q in LADDER if q >= r)]
        out[name] = dict(differ_share=share,
                         least_rows=clean[0] if clean else None)
    return out


def drift(arch: str, dev, min_rows: dict) -> dict:
    """chip_smoke's dense serve run with ``blocks._MIN_ROWS`` set to
    ``min_rows`` for the dense products."""
    from repro_torch.models import blocks
    saved = dict(blocks._MIN_ROWS)
    blocks._MIN_ROWS.update(min_rows)
    try:
        res = chip_smoke.dense_serve(dev, arch, chip_smoke.SERVE_BATCH,
                                     chip_smoke.SERVE_PROMPT, 1, False)
    finally:
        blocks._MIN_ROWS.clear()
        blocks._MIN_ROWS.update(saved)
    keys = ("decode_vs_forward_last", "decode_vs_forward_max",
            "decode_vs_forward_median", "bit_equal_positions",
            "prefill_vs_forward", "greedy_agreement", "finite")
    return dict({k: res[k] for k in keys},
                decode_ms_per_step=res["median"]["decode_ms_per_step"])


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=1024)
    ap.add_argument("archs", nargs="*", default=list(chip_smoke.DENSE_ARCHS))
    args = ap.parse_args()
    from repro_torch.models import blocks
    dev = torch.device("cuda")
    _emit(device=torch.cuda.get_device_name(0), torch=torch.__version__,
          cuda=torch.version.cuda)
    for arch in args.archs:
        _emit(arch=arch, products=products(arch, dev))
        _emit(arch=arch, min_rows="committed", min_rows_used={
            k: v for k, v in blocks._MIN_ROWS.items() if k in DENSE_KEYS},
              drift=drift(arch, dev, {}))
        pad_all = {k: args.rows for k in DENSE_KEYS}
        if any(blocks._MIN_ROWS.get(k) != args.rows for k in DENSE_KEYS):
            _emit(arch=arch, min_rows=args.rows,
                  drift=drift(arch, dev, pad_all))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
