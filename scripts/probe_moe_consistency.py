"""Decode against forward for the MoE family on the card, drop-free: how
much of the drift is the routing, and whether padding products to more
rows moves it.

    python3 scripts/probe_moe_consistency.py [--prompt-mixtral 512]
        [--prompt-kimi 64] [--decode 8] [--rows 1024]

Mixtral-8x7B (24 of 32 layers) and Kimi-K2 (1 of 61), published widths,
bf16, seeded as ``chip_smoke.py``'s ``moe_serve`` seeds them, at
capacity_factor = E (nothing dropped): one prompt, greedy decodes, the
forward over the extended sequence (``chip_smoke.serve_run``), in three
variants, each on the same weights and prompt:

- ``as_is``: the port as it runs;
- ``experts_padded``: every ``torch.bmm`` (the experts' three products on
  their (E, C, D) buffer) on at least ``--rows`` rows a batch entry, zero
  rows appended and dropped after, so that a decode step's products run
  the kernels of the forward's thousands of rows;
- ``all_padded``: also the attention projections and the MLPs (Kimi-K2's
  shared expert) through ``blocks._MIN_ROWS``.

One JSON line per (configuration, variant): decode against forward at
each position (max |Δ| / max |forward|), the layers whose experts differ
from the forward's at each position with the forward's router margin and
the router logits' drift there (``chip_smoke.routing_flips``), and the
largest drift over the positions routed alike.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.models import Model, blocks  # noqa: E402

PADDED_NAMES = ("mlp", "attn.wq", "attn.wk", "attn.wv", "attn.wo")


@contextlib.contextmanager
def padded_bmm(rows: int):
    """``torch.bmm`` on at least ``rows`` rows a batch entry."""
    plain = torch.bmm

    def bmm(a, b):
        m = a.shape[1]
        if m >= rows:
            return plain(a, b)
        return plain(F.pad(a, (0, 0, 0, rows - m)), b)[:, :m]

    torch.bmm = bmm
    try:
        yield
    finally:
        torch.bmm = plain


@contextlib.contextmanager
def padded_products(rows: int):
    saved = dict(blocks._MIN_ROWS)
    blocks._MIN_ROWS.update({n: rows for n in PADDED_NAMES})
    try:
        with padded_bmm(rows):
            yield
    finally:
        blocks._MIN_ROWS.clear()
        blocks._MIN_ROWS.update(saved)


@torch.no_grad()
def probe(dev, arch: str, layers: int, prompt_len: int, steps: int,
          rows: int) -> None:
    cfg = dataclasses.replace(configs.get(arch), n_layers=layers)
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    model = Model(dataclasses.replace(cfg, capacity_factor=float(
        cfg.n_experts)), device=dev, generator=gen)
    # the prompt moe_serve's consistency part draws: after the serve prompts
    torch.randint(0, cfg.vocab_size, (cs.SERVE_BATCH, cs.SERVE_PROMPT),
                  generator=gen, device=dev)
    prompt = torch.randint(0, cfg.vocab_size, (1, prompt_len), generator=gen,
                           device=dev)
    variants = {"as_is": contextlib.nullcontext,
                "experts_padded": lambda: padded_bmm(rows),
                "all_padded": lambda: padded_products(rows)}
    for name, ctx in variants.items():
        with ctx(), blocks.routing_stats() as st:
            stats, _, _, _ = cs.serve_run(model, prompt, steps, "probe",
                                          each=True)
        flips = cs.routing_flips(st, layers, prompt_len, cfg.top_k)
        dropped = sum(d for d, _ in cs.per_call(st, layers))
        del st
        each = stats["decode_vs_forward_each"]
        same = [e for e, f in zip(each, flips) if not f]
        print(json.dumps(dict(
            arch=arch, layers=layers, variant=name, rows=rows,
            prompt=prompt_len, decode_steps=steps, dropped=dropped,
            decode_vs_forward_each=each, flips=flips,
            same_routing_max=max(same, default=None),
            same_routing_median=sorted(same)[len(same) // 2] if same
            else None,
            bit_equal_positions=stats["bit_equal_positions"],
            greedy_agreement=stats["greedy_agreement"])), flush=True)
    del model
    torch.cuda.empty_cache()


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--prompt-mixtral", type=int, default=512)
    ap.add_argument("--prompt-kimi", type=int, default=64)
    ap.add_argument("--decode", type=int, default=8)
    ap.add_argument("--rows", type=int, default=1024)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    dev = torch.device("cuda")
    cs.phase_device()
    prompts = {"mixtral-8x7b": args.prompt_mixtral,
               "kimi-k2-1t-a32b": args.prompt_kimi}
    for arch, layers in cs.MOE_SERVE:
        probe(dev, arch, layers, prompts[arch], args.decode, args.rows)


if __name__ == "__main__":
    main()
