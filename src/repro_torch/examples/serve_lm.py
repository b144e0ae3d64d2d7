"""Batched serving (``examples/serve_lm.py``): prefill a batch of prompts,
then decode tokens one step at a time from the KV or recurrent cache, for
any configuration of the zoo (its reduced variant).

    PYTHONPATH=src python -m repro_torch.examples.serve_lm \\
        --arch recurrentgemma-2b --tokens 16 [--device cpu]

The weights, prompts and (for the audio and VLM families) the source come
from ``torch.Generator`` draws; :func:`run` takes a model and prompts
instead.
"""
from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence

import torch

from repro_torch import configs
from repro_torch._device import resolve_device
from repro_torch.data import cross_source
from repro_torch.models import Model


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.examples.serve_lm")
    ap.add_argument("--arch", default="qwen2-1.5b", choices=configs.names())
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="the CUDA device unless given (e.g. cpu)")
    return ap


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(args: argparse.Namespace, *, model: Optional[Model] = None,
        prompts: Optional[torch.Tensor] = None,
        extra: Optional[dict] = None) -> dict:
    """The example for parsed ``args``; ``model`` (of the reduced
    configuration), ``prompts`` (batch, prompt_len) and ``extra`` (the
    source) replace the drawn ones.  Returns the prefill's logits, the
    generated ids and the walls."""
    dev = resolve_device(args.device)
    cfg = configs.get(args.arch).reduced()
    if model is None:
        model = Model(cfg, device=dev,
                      generator=torch.Generator(device=dev).manual_seed(0))
    gen = torch.Generator(device=dev).manual_seed(1)
    if prompts is None:
        prompts = torch.randint(0, cfg.vocab_size,
                                (args.batch, args.prompt_len),
                                generator=gen, device=dev)
    prompts = torch.as_tensor(prompts, device=dev)
    batch, prompt_len = prompts.shape
    if extra is None:
        extra = cross_source(cfg, gen, batch, prompt_len)

    t0 = time.perf_counter()
    logits, cache = model.prefill(prompts, extra,
                                  cache_len=prompt_len + args.tokens + 8)
    _sync(dev)
    t_prefill = time.perf_counter() - t0
    prefill_logits = logits

    out_tokens = []
    tok = logits[:, -1].argmax(-1)[:, None]
    t0 = time.perf_counter()
    with torch.no_grad():
        for _ in range(args.tokens):
            out_tokens.append(tok)
            logits, cache = model.decode(cache, tok)
            tok = logits[:, -1].argmax(-1)[:, None]
    _sync(dev)
    t_decode = time.perf_counter() - t0

    gen_ids = torch.cat(out_tokens, dim=1)
    tps = batch * args.tokens / t_decode
    print(f"arch={cfg.name} batch={batch} prompt={prompt_len}")
    print(f"prefill: {t_prefill*1e3:.1f} ms   decode: "
          f"{t_decode*1e3/args.tokens:.1f} ms/token   {tps:.0f} tok/s")
    print(f"first generated ids: {gen_ids[0, :8].tolist()}")
    return {"prefill_logits": prefill_logits, "ids": gen_ids.tolist(),
            "prefill_s": t_prefill, "decode_s": t_decode}


def main(argv: Optional[Sequence[str]] = None) -> dict:
    return run(parser().parse_args(argv))


if __name__ == "__main__":
    main()
