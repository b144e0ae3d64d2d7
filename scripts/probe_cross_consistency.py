#!/usr/bin/env python3
"""Where Llama-3.2-Vision-11B's decode drifts from its forward, on one CUDA
card.

    python3 scripts/probe_cross_consistency.py [VARIANT ...]

``chip_smoke.py``'s ``vlm_serve`` serves the model as published (bf16,
seeded weights, gates opened, 4 prompts of 2048 tokens over 1601 image
embeddings), decodes 32 greedy steps, runs a forward over the extended
sequences and holds the decode logits at the last position to the
forward's (max |Δ| / max |forward| ≤ ``BF16_SERVE_TOL["vlm"]``).  For each
variant (default: all) this prints, on the same weights and inputs:

- ``step``: one decode step from the prefill's cache against the forward
  over the prompts and that token, after every sublayer (each group's
  cross-decoder layer and its dense layers, in order) and at the logits:
  max |Δ| / max |forward| of the residual stream at the last position;
- ``serve``: ``chip_smoke.serve_run``'s statistics (decode against forward
  at each of the 33 positions) and the decode ms a step.

The variants: ``as_is``; ``gates_closed`` (every gate 0: no
cross-attention, a 40-layer dense model); ``rows_1024`` (every product of
attention and the MLP on at least 1024 rows, zero rows appended, as
``blocks._MIN_ROWS`` does for the Mamba mixer); ``chunked_decode``
(``layers.decode_attention`` replaced by ``flash_attention`` over the
valid slots, so a decode step's softmax runs over the forward's key
chunks in the forward's order); ``no_reduced_bf16`` (cuBLAS barred from
reduced-precision reductions in bf16 products).  Two more break the
decode's cross cache, the faults that ``vlm_serve``'s bf16 bound must
catch: ``cross_cache_other`` (each prompt decodes over the cross k and v
of the next prompt's images, a stale cache) and ``cross_cache_e4m3``
(the cross k and v rounded through float8 e4m3, a wrong cast).  With ``ops`` among the
arguments, first the first cross-decoder layer op by op: each op of the
forward over the prompts and one token against the same op on the last
position alone (a decode step's shapes), both on the forward's own
inputs: the share of outputs that differ in any bit and max |Δ| / max
|forward|.  Last, the card's ``nvidia-smi`` name and power limit.
"""
from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402

VARIANTS = ("as_is", "gates_closed", "rows_1024", "chunked_decode",
            "no_reduced_bf16", "cross_cache_other", "cross_cache_e4m3")
PAD_KEYS = ("attn.wq", "attn.wk", "attn.wv", "attn.wo", "mlp")


def _emit(**fields) -> None:
    print(json.dumps(fields), flush=True)


@contextlib.contextmanager
def variant(name: str, model):
    """The variant's change, undone on exit."""
    from repro_torch.models import blocks, layers
    saved_rows = dict(blocks._MIN_ROWS)
    saved_decode = layers.decode_attention
    saved_cross = blocks.cross_attention
    gates = {n: p.detach().clone() for n, p in model.named_parameters()
             if n.endswith(".gate")}
    if name == "gates_closed":
        with torch.no_grad():
            for n, p in model.named_parameters():
                if n in gates:
                    p.zero_()
    elif name == "rows_1024":
        blocks._MIN_ROWS.update({k: 1024 for k in PAD_KEYS})
    elif name == "chunked_decode":
        chunk = model.cfg.attn_chunk

        def decode(q, cache_k, cache_v, pos, *, window=None):
            return layers.flash_attention(q, cache_k[:, :pos],
                                          cache_v[:, :pos], causal=False,
                                          window=None, chunk=chunk)

        layers.decode_attention = decode
    elif name == "no_reduced_bf16":
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
            False
    elif name in ("cross_cache_other", "cross_cache_e4m3"):
        def cross(p, x, src, cfg, ctx=None):
            # the prefill's cross cache only: the forward's output is kept
            y, kv = saved_cross(p, x, src, cfg, ctx)
            if name == "cross_cache_other":
                return y, {k: t.roll(1, 0) for k, t in kv.items()}
            return y, {k: t.to(torch.float8_e4m3fn).to(t.dtype)
                       for k, t in kv.items()}

        blocks.cross_attention = cross
    elif name != "as_is":
        raise ValueError(f"unknown variant {name!r}")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
            True
        blocks._MIN_ROWS.clear()
        blocks._MIN_ROWS.update(saved_rows)
        layers.decode_attention = saved_decode
        blocks.cross_attention = saved_cross
        with torch.no_grad():
            for n, p in model.named_parameters():
                if n in gates:
                    p.copy_(gates[n])


@contextlib.contextmanager
def recorded(out: list, col: int):
    """Each sublayer's output row ``col`` (the last position) appended to
    ``out``, in call order."""
    from repro_torch.models import model as mm
    saved = (mm._xdec_layer, mm._attention_layer)

    def wrap(fn, tag):
        def inner(*args, **kwargs):
            res = fn(*args, **kwargs)
            out.append((tag, res[0][:, col].float().clone()))
            return res
        return inner

    mm._xdec_layer = wrap(saved[0], "cross")
    mm._attention_layer = wrap(saved[1], "self")
    try:
        yield
    finally:
        mm._xdec_layer, mm._attention_layer = saved


@torch.no_grad()
def step(model, prompts, extra) -> dict:
    """One decode step against the forward, sublayer by sublayer."""
    logits_p, cache = model.prefill(prompts, extra)
    first = logits_p[:, -1].argmax(-1, keepdim=True)
    fwd, dec = [], []
    with recorded(fwd, -1):
        logits_f, _ = model(torch.cat([prompts, first], 1), extra)
    with recorded(dec, 0):
        logits_d, _ = model.decode(cache, first)
    rel = [float((d - f).abs().max() / f.abs().max())
           for (_, f), (_, d) in zip(fwd, dec)]
    return dict(sublayers=[t for t, _ in fwd], rel=rel,
                logits=float((logits_d[:, 0] - logits_f[:, -1]).abs().max()
                             / logits_f[:, -1].abs().max()))


@torch.no_grad()
def ops(model, prompts, extra) -> list:
    """The first cross-decoder layer op by op (see the module's
    docstring)."""
    from repro_torch.models import blocks, layers
    cfg, layer = model.cfg, model.groups[0].cross
    logits_p, _ = model.prefill(prompts, extra)
    ext = torch.cat([prompts, logits_p[:, -1].argmax(-1, keepdim=True)], 1)
    last = ext.shape[1] - 1
    x, src = model._embed(ext), model._source(extra)
    rows = []

    def cmp(name, full, one):
        f, o = full[:, -1:].float(), one.float()
        rows.append(dict(op=name, differ=float((f != o).float().mean()),
                         rel=float((f - o).abs().max() / f.abs().max())))

    def both(fn, t):
        full, one = fn(t), fn(t[:, -1:])
        cmp(fn.__name__, full, one)
        return full

    def ln1(t):
        return blocks.norm_apply(layer.ln1, t, cfg)

    h = both(ln1, x)
    q, k, v = (both(lambda t, n=n: blocks._heads_product(layer.attn, t, n),
                    h) for n in ("wq", "wk", "wv"))
    rows[-3:] = [dict(r, op=n) for r, n in zip(rows[-3:], ("wq", "wk", "wv"))]
    pos = torch.arange(ext.shape[1], device=x.device)
    pos1 = torch.full((x.shape[0], 1), last, device=x.device)
    qr, kr = (layers.rope(t, pos, cfg.rope_theta) for t in (q, k))
    for name, t, r in (("rope q", q, qr), ("rope k", k, kr)):
        cmp(name, r, layers.rope(t[:, -1:], pos1, cfg.rope_theta))
    o = layers.flash_attention(qr, kr, v, causal=True, chunk=cfg.attn_chunk)
    cmp("self attention (decode_attention)", o, layers.decode_attention(
        qr[:, -1:], kr, v, last + 1))
    cmp("self attention (chunked, one row)", o, layers.flash_attention(
        qr[:, -1:], kr, v, causal=False, chunk=cfg.attn_chunk))
    y = blocks._out(layer.attn, o, x)
    cmp("wo", y, blocks._out(layer.attn, o[:, -1:], x[:, -1:]))
    x2 = x + y

    def lnx(t):
        return blocks.norm_apply(layer.lnx, t, cfg)

    h = both(lnx, x2)
    qx = blocks._heads_product(layer.xattn, h, "wq")
    cmp("cross wq", qx, blocks._heads_product(layer.xattn, h[:, -1:], "wq"))
    kx, vx = (blocks._heads_product(layer.xattn, src, n) for n in ("wk",
                                                                  "wv"))
    ox = layers.flash_attention(qx, kx, vx, causal=False,
                                chunk=cfg.attn_chunk)
    cmp("cross attention (decode_attention)", ox, layers.decode_attention(
        qx[:, -1:], kx, vx, kx.shape[1]))
    yx = blocks._gated(layer.xattn, blocks._out(layer.xattn, ox, x2))
    cmp("cross wo, gate", yx, blocks._gated(
        layer.xattn, blocks._out(layer.xattn, ox[:, -1:], x2[:, -1:])))
    x3 = x2 + yx

    def ln2(t):
        return blocks.norm_apply(layer.ln2, t, cfg)

    h = both(ln2, x3)
    wi, wg, wo = (getattr(layer.mlp, n).to(h.dtype) for n in ("wi", "wg",
                                                              "wo"))

    def mlp_wi(t):
        return t @ wi

    def mlp_wg(t):
        return t @ wg

    a, g = both(mlp_wi, h), both(mlp_wg, h)
    hid = torch.nn.functional.silu(a) * g

    def mlp_wo(t):
        return t @ wo

    both(mlp_wo, hid)
    return rows


@torch.no_grad()
def main() -> None:
    from repro_torch import configs
    from repro_torch.models import Model
    names = sys.argv[1:] or list(VARIANTS)
    dev = torch.device("cuda")
    cfg = configs.get(chip_smoke.CROSS_ARCHS["vlm"])
    b, s = chip_smoke.SERVE_BATCH, chip_smoke.SERVE_PROMPT
    # the data of chip_smoke.cross_serve, drawn in its order
    gen = torch.Generator(device=dev).manual_seed(chip_smoke.SEED)
    model = Model(cfg, device=dev, generator=gen)
    chip_smoke.open_gates(model)
    prompts = torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                            device=dev)
    extra = {"image_embeds": torch.randn(
        (b, cfg.n_image_tokens, cfg.d_model), generator=gen,
        device=dev).to(cfg.activation_dtype)}
    if "ops" in names:
        names.remove("ops")
        for row in ops(model, prompts, extra):
            _emit(**row)
    for name in names:
        with variant(name, model):
            one = step(model, prompts, extra)
            stats, _, cache, first = chip_smoke.serve_run(
                model, prompts, chip_smoke.SERVE_DECODE, "vlm", each=True,
                extra=extra)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            chip_smoke.greedy(model, cache, first, 8)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3 / 8
            del cache
        _emit(variant=name, step=one, serve=stats, decode_ms_per_step=ms,
              tol=chip_smoke.BF16_SERVE_TOL["vlm"])
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
