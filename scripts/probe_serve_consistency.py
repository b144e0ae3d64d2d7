#!/usr/bin/env python3
"""How far Falcon-Mamba-7B's decode drifts from its forward in bf16, on one
CUDA card.

    python3 scripts/probe_serve_consistency.py [n_prompt_seeds [n_settings]]

The serve phase of ``chip_smoke.py`` prefills 4 prompts of 2048 tokens,
decodes 32 greedy steps and runs a forward over the extended sequences, and
holds the decode logits at the last position to the forward's (max |Δ| /
max |forward| ≤ ``SERVE_TOL``).  This script measures that statistic at
every one of the 33 positions (the prefill's last, then each decode step),
for the mixer's kernels (``scan="cuda"``) and their plain versions
(``scan="reference"``) on the same seeded weights, for the serve phase's own
prompts and for prompts drawn from seeds 1 .. n_prompt_seeds - 1 (default
4 in all), with cuBLAS allowed to reduce bf16 split-K partials in reduced
precision (``torch.backends.cuda.matmul.
allow_bf16_reduced_precision_reduction``, PyTorch's default) and, unless
n_settings is 1, with it disallowed (n_settings 0: no drift runs).  Per run
it prints the last position's value, the median and maximum over
positions, the share of positions above ``SERVE_TOL``, the positions
where decode and forward agree bit for bit, the greedy agreement and the
decode's ms a step.

Before that, two diagnostics of the products:
- ``gemm_rounding``: each bf16 GEMM of the mixer and the head, at M = the
  batch's rows (a decode step) and M = 2048 (a prefill's share), under
  both settings, against the same product accumulated in float32 and
  rounded once to bf16 (what the JAX reference computes): the share of
  elements that differ and the largest difference in bf16 steps;
- ``op_invariance``: layer 0's products and RMSNorm on the prompts' last
  position, once over all B·S rows as the forward runs them and once over
  the B rows alone or padded with zero rows to 64 .. 2048 (plain ``@``,
  not the model's ``blocks._product``): the share of outputs that differ
  in any bit, which sets ``blocks._MIN_ROWS``.

- ``decode_ab``: decode ms a step of the serve batch with every product
  padded to ``blocks._MIN_ROWS``, with none, and with each one alone, in
  turns (4 rounds of 32 steps each).

Last, the card's ``nvidia-smi`` name and power limit.
"""
from __future__ import annotations

import contextlib
import itertools
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402

_MATMUL = torch.backends.cuda.matmul


@contextlib.contextmanager
def reduced_reduction(allowed: bool):
    old = _MATMUL.allow_bf16_reduced_precision_reduction
    _MATMUL.allow_bf16_reduced_precision_reduction = allowed
    try:
        yield
    finally:
        _MATMUL.allow_bf16_reduced_precision_reduction = old


def gemm_rounding(model, batch: int) -> list:
    """Each bf16 GEMM of a decode step against float32 accumulation."""
    dev, bf16 = model.device, torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(7)
    p = model.groups[0].mamba
    shapes = dict(wx=p.wx, x_proj=p.x_proj, out_proj=p.out_proj,
                  lm_head=model.lm_head)
    rows = []
    for (name, w), m in itertools.product(shapes.items(), (batch, 2048)):
        w = w.to(bf16)
        x = torch.randn(m, w.shape[0], generator=gen, device=dev).to(bf16)
        want = (x.float() @ w.float()).to(bf16)
        for allowed in (True, False):
            with reduced_reduction(allowed):
                got = x @ w
            rows.append(dict(
                gemm=name, m=m, k=w.shape[0], n=w.shape[1],
                reduced_precision_reduction=allowed,
                differ_share=float((got != want).float().mean()),
                max_ulps=chip_smoke.bf16_ulps(got, want)))
    return rows


def drift(model, prompts) -> dict:
    """Decode after prefill against forward, per position."""
    logits_p, cache = model.prefill(prompts)
    toks, logits = [logits_p[:, -1].argmax(-1, keepdim=True)], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(chip_smoke.SERVE_DECODE):
        step, cache = model.decode(cache, toks[-1])
        logits.append(step)
        toks.append(step[:, -1].argmax(-1, keepdim=True))
    torch.cuda.synchronize()
    decode_ms = (time.perf_counter() - t0) * 1e3 / chip_smoke.SERVE_DECODE
    mine = torch.cat([logits_p, *logits], 1)
    ext = torch.cat([prompts, *toks[:-1]], 1)     # the decode steps' inputs
    ref = model(ext)[0][:, chip_smoke.SERVE_PROMPT - 1:]
    per = [float((mine[:, j] - ref[:, j]).abs().max() / ref[:, j].abs().max())
           for j in range(ref.shape[1])]
    agree = float((mine.argmax(-1) == ref.argmax(-1)).float().mean())
    return dict(last=per[-1], median=float(np.median(per)), max=max(per),
                share_over_tol=float(np.mean(np.array(per)
                                             > chip_smoke.SERVE_TOL)),
                bit_equal_positions=int(sum(v == 0.0 for v in per)),
                greedy_agreement=agree, decode_ms_per_step=decode_ms,
                per_position=per)


def op_invariance(model, prompts, pads) -> list:
    """Layer 0's ops on the last prompt position, once as the forward runs
    them (all B·S rows at once) and once as a decode step does (the B rows
    alone, or padded with zero rows to ``pad``): the share of outputs that
    differ in any bit."""
    from repro_torch.models import blocks
    cfg, p = model.cfg, model.groups[0].mamba
    bsz, s = prompts.shape
    x = model._embed(prompts)
    h = blocks.norm_apply(model.groups[0].ln, x, cfg)
    xc, z, _ = blocks._in_proj(p, h, model.scan)
    r = cfg.dt_rank_
    dt_r = (xc @ p.x_proj.to(xc.dtype))[..., :r].float()
    ops = dict(wx=(h, p.wx.to(h.dtype)), x_proj=(xc, p.x_proj.to(xc.dtype)),
               dt_proj=(dt_r, p.dt_proj.float()),
               out_proj=(xc, p.out_proj.to(xc.dtype)),
               lm_head=(h, model.lm_head.to(h.dtype)))
    rows = []
    for name, (a, w) in ops.items():
        full = (a.reshape(bsz * s, -1) @ w).view(bsz, s, -1)[:, -1]
        for pad in pads:
            last = a[:, -1]
            if pad > bsz:
                last = torch.cat([last, last.new_zeros(pad - bsz,
                                                       last.shape[1])])
            got = (last @ w)[:bsz]
            rows.append(dict(op=name, m_full=bsz * s, m=max(pad, bsz),
                             k=w.shape[0], n=w.shape[1],
                             differ_share=float((got != full).float().mean())))
    xf = x.reshape(bsz * s, -1)
    full = blocks.norm_apply(model.groups[0].ln, xf, cfg).view(bsz, s, -1)
    got = blocks.norm_apply(model.groups[0].ln, x[:, -1], cfg)
    rows.append(dict(op="rms_norm", m_full=bsz * s, m=bsz,
                     differ_share=float((got != full[:, -1]).float().mean())))
    return rows


def decode_ab(model, prompts, rounds: int = 4) -> dict:
    """Decode ms a step with the model's products on at least
    ``blocks._MIN_ROWS`` rows ("all"), on the batch's rows alone ("none"),
    and with one product padded alone (its name), 32 steps each, the sides'
    order rotated every round."""
    from repro_torch.models import blocks
    _, cache = model.prefill(prompts)
    first = prompts[:, -1:]
    kept = dict(blocks._MIN_ROWS)
    sides = {"all": kept, "none": dict.fromkeys(kept, 0),
             **{k: {**dict.fromkeys(kept, 0), k: v} for k, v in kept.items()}}
    names = list(sides)
    times = {k: [] for k in names}
    try:
        for r in range(rounds):
            for side in names[r % len(names):] + names[:r % len(names)]:
                blocks._MIN_ROWS.update(sides[side])
                c, tok = cache, first
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(chip_smoke.SERVE_DECODE):
                    step, c = model.decode(c, tok)
                    tok = step[:, -1].argmax(-1, keepdim=True)
                torch.cuda.synchronize()
                times[side].append((time.perf_counter() - t0) * 1e3
                                   / chip_smoke.SERVE_DECODE)
    finally:
        blocks._MIN_ROWS.update(kept)
    return dict(ms_per_step=times,
                median={k: float(np.median(v)) for k, v in times.items()})


def main() -> None:
    n_seeds = int(sys.argv[1]) if len(sys.argv) > 1 else 4
    dev_info = chip_smoke.phase_device()
    from repro_torch import configs
    from repro_torch.models import Model
    dev = torch.device("cuda")
    cfg = configs.get(chip_smoke.MAMBA_ARCH)
    gen = torch.Generator(device=dev).manual_seed(chip_smoke.SEED)
    model = Model(cfg, device=dev, generator=gen)
    shape = (chip_smoke.SERVE_BATCH, chip_smoke.SERVE_PROMPT)
    # seed 0: the serve phase's prompts (drawn after the weights, as there)
    prompts = [torch.randint(0, cfg.vocab_size, shape, generator=gen,
                             device=dev)]
    for seed in range(1, n_seeds):
        g = torch.Generator(device=dev).manual_seed(seed)
        prompts.append(torch.randint(0, cfg.vocab_size, shape, generator=g,
                                     device=dev))
    for row in gemm_rounding(model, chip_smoke.SERVE_BATCH):
        print(json.dumps(dict(probe="gemm_rounding", **row)), flush=True)
    for row in op_invariance(model, prompts[0], (4, 64, 256, 1024, 2048)):
        print(json.dumps(dict(probe="op_invariance", **row)), flush=True)
    print(json.dumps(dict(probe="decode_ab", scan=model.scan,
                          **decode_ab(model, prompts[0]))), flush=True)
    for allowed in (True, False)[:int(sys.argv[2]) if len(sys.argv) > 2
                                 else 2]:
        for scan in ("cuda", "reference"):
            model.scan = scan
            for seed, p in enumerate(prompts):
                with reduced_reduction(allowed):
                    res = drift(model, p)
                print(json.dumps(dict(
                    probe="serve_drift", scan=scan, prompt_seed=seed,
                    reduced_precision_reduction=allowed,
                    tol=chip_smoke.SERVE_TOL, **res)), flush=True)
    print(dev_info["smi"], flush=True)


if __name__ == "__main__":
    main()
