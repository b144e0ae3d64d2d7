#!/usr/bin/env python3
"""Does a training step give the same bits twice on the card?

    python3 scripts/probe_train_determinism.py [--arch qwen2-1.5b]
        [--layers 2] [--batch 4] [--seq 2048]

The configuration at its widths, cut to ``--layers`` layers (bf16,
seeded): the loss and every gradient of one batch computed twice on the
same weights, per variant: ``as_is``; ``embedding`` (the embedding's
lookup by ``F.embedding``, whose backward sums each row's gradients in a
fixed order, in place of indexing, whose backward accumulates them with
atomics); ``deterministic`` (``torch.use_deterministic_algorithms(True,
warn_only=True)``).  One JSON line per variant: the gradients that
differ between the two passes and their largest difference.  Needs one
CUDA card; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

from repro_torch import configs  # noqa: E402
from repro_torch.data import token_stream  # noqa: E402
from repro_torch.models import Model  # noqa: E402


def grads(model, batch):
    loss, _ = model.loss(batch)
    named = dict(model.named_parameters())
    return loss.detach(), dict(zip(named, torch.autograd.grad(
        loss, list(named.values()))))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=2048)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    dev = torch.device("cuda")
    cfg = dataclasses.replace(configs.get(args.arch), n_layers=args.layers)
    model = Model(cfg, device=dev,
                  generator=torch.Generator(device=dev).manual_seed(0))
    batch = next(token_stream(torch.Generator(device=dev).manual_seed(1),
                              cfg.vocab_size, args.batch, args.seq))
    embed = Model._embed

    def by_embedding(self, tokens):
        return F.embedding(self._tokens(tokens), self.embed).to(
            self.cfg.activation_dtype)

    for variant in ("as_is", "embedding", "deterministic"):
        if variant == "embedding":
            Model._embed = by_embedding
        if variant == "deterministic":
            Model._embed = embed
            torch.use_deterministic_algorithms(True, warn_only=True)
        (l1, g1), (l2, g2) = grads(model, batch), grads(model, batch)
        differ = {n: float((g1[n].float() - g2[n].float()).abs().max())
                  for n in g1 if not torch.equal(g1[n], g2[n])}
        print(json.dumps(dict(variant=variant, arch=args.arch,
                              layers=args.layers, batch=args.batch,
                              seq=args.seq, loss_equal=bool(torch.equal(
                                  l1, l2)), grads=len(g1), differ=differ)),
              flush=True)
    torch.use_deterministic_algorithms(False)
    Model._embed = embed


if __name__ == "__main__":
    main()
