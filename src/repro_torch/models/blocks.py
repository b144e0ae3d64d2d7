"""The per-family blocks of the port, from the JAX package's
``models/blocks.py``: the norm (``:500-505``), attention and the dense MLP
(``:63-197``) for the ``dense`` family, and the Mamba-1 mixer
(``:340-425``) for the ``ssm`` family.

Every block takes ``p``, a module (or any object) with the parameters as
attributes under the JAX package's leaf names and layouts (attention: ``wq``
(d, H, hd), ``wk``/``wv`` (d, KV, hd), ``wo`` (H, hd, d), ``bq``/``bk``/
``bv``; the MLP: ``wi``, ``wg`` (d, f), ``wo`` (f, d); the mixer: ``wx``
(d, di), ``x_proj`` (di, r+2N), ``a_log`` (di, N), …).  Attention is
:func:`~repro_torch.models.layers.flash_attention` over the whole sequence
and :func:`~repro_torch.models.layers.decode_attention` over the cache; one
card pads no query heads, so query head j reads kv head j // (H / KV)
(``_kv_index``).  Between its GEMMs the mixer runs two kernels, chosen by
``scan=`` (:func:`repro_torch.kernels.ssm_scan.resolve_mixer`): the causal
convolution with its bias and silu, and ``mamba_scan`` (softplus, the
selective scan and the gate); the JAX package computes the recurrence
through ``layers.chunked_linear_recurrence``.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssm_scan import resolve_mixer

from . import layers
from .config import ModelConfig
from .params import Spec

__all__ = ["attention_spec", "attention_apply", "attention_prefill",
           "attention_decode", "mlp_spec", "mlp_apply", "mamba_spec",
           "mamba_apply", "mamba_prefill", "mamba_init_cache",
           "mamba_decode", "norm_spec", "norm_apply"]


# On the card each of these products runs on at least this many rows (zero
# rows appended, their outputs dropped).  On fewer rows, as in a decode
# step, cuBLAS (H100, CUDA 12.8) picks kernels that sum in another order
# than for a prefill's thousands: the rows differ from the forward's in
# their last bits (dt_proj in 66 % of its outputs at 4 rows, x_proj and
# out_proj in under 1 %), and over 64 bf16 layers decode logits drift to
# ~5e-2 of forward's.  From these counts on, each runs the prefill's
# kernel, so a decode step computes what the forward computes for its
# position.  Measured by scripts/probe_serve_consistency.py.  The dense
# family's products (``attn.wq``, ``attn.wk``, ``attn.wv``, ``attn.wo``,
# ``mlp``) are not listed: at 4 rows its MLP differs from the forward's
# rows in 0.3-0.5 % of its outputs (Qwen2-1.5B, MiniCPM-2B,
# H2O-Danube3-4B) and H2O-Danube3's k and v in 0.2 %, all others in none.
# Padding them all to 1024 rows left decode against forward at the last
# position at 1.7-3.2 % of max |forward| (3.0-4.0 % for MiniCPM-2B) and
# its largest over the 33 positions at 1.9-5.2 %, either way: that drift
# comes from attention, whose decode sums in another order than the
# forward's chunked softmax (scripts/probe_dense_consistency.py; PERF.md).
_MIN_ROWS = {"x_proj": 1024, "dt_proj": 64, "out_proj": 256}


def _on_rows(fn, a: torch.Tensor, name: str) -> torch.Tensor:
    """``fn(a)`` for ``a`` (B, S, K) and a row-wise ``fn``; on the card
    over at least ``_MIN_ROWS[name]`` rows (none for a name it does not
    list): batch rows of zeros appended, dropped after."""
    bsz, s = a.shape[0], a.shape[1]
    rows = _MIN_ROWS.get(name, 0)
    if a.device.type != "cuda" or s == 0 or bsz * s >= rows:
        return fn(a)
    pad = -(-rows // s) - bsz
    return fn(F.pad(a, (0, 0, 0, 0, 0, pad)))[:bsz]


def _product(a: torch.Tensor, w: torch.Tensor, name: str) -> torch.Tensor:
    """``a @ w`` over at least ``_MIN_ROWS[name]`` rows (:func:`_on_rows`)."""
    return _on_rows(lambda t: t @ w, a, name)


# ---------------------------------------------------------------- attention


def attention_spec(cfg: ModelConfig, *, cross: bool = False
                   ) -> Dict[str, Spec]:
    """``blocks.py:63-79`` on one card: no padded query heads."""
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    spec = {"wq": Spec((d, h, hd)), "wk": Spec((d, kv, hd)),
            "wv": Spec((d, kv, hd)), "wo": Spec((h, hd, d))}
    if cfg.qkv_bias and not cross:
        spec["bq"] = Spec((h, hd), init="zeros")
        spec["bk"] = Spec((kv, hd), init="zeros")
        spec["bv"] = Spec((kv, hd), init="zeros")
    if cross:
        spec["gate"] = Spec((), init="zeros")      # gated cross-attn (VLM)
    return spec


def _heads_product(p, x: torch.Tensor, leaf: str) -> torch.Tensor:
    """``einsum("bsd,dhk->bshk", x, p.<leaf>)`` in x's dtype, plus the
    leaf's bias (``b`` + its letter) in x's dtype where there is one."""
    w = getattr(p, leaf).to(x.dtype)
    y = _product(x, w.reshape(w.shape[0], -1), f"attn.{leaf}")
    y = y.view(*x.shape[:2], *w.shape[1:])
    bias = getattr(p, "b" + leaf[1:], None)
    return y if bias is None else y + bias.to(x.dtype)


def _qkv(p, x: torch.Tensor, kv_src: torch.Tensor):
    """``blocks.py:82-90``: q from x, k and v from ``kv_src``, the biases
    added in the activation dtype."""
    return (_heads_product(p, x, "wq"), _heads_product(p, kv_src, "wk"),
            _heads_product(p, kv_src, "wv"))


def _out(p, out: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``einsum("bshk,hkd->bsd", out, p.wo)`` in x's dtype."""
    wo = p.wo.to(x.dtype)
    return _product(out.reshape(*out.shape[:2], -1),
                    wo.reshape(-1, wo.shape[-1]), "attn.wo")


def _gated(p, y: torch.Tensor) -> torch.Tensor:
    """The cross-attention gate ``tanh(gate) · y``, the gate in float32."""
    return torch.tanh(p.gate.float()).to(y.dtype) * y


def attention_apply(p, x: torch.Tensor, cfg: ModelConfig, *,
                    causal: bool = True, window: Optional[int] = None,
                    kv_src: Optional[torch.Tensor] = None,
                    use_rope: bool = True,
                    positions: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """``blocks.py:93-116``: self-attention over x, or cross-attention over
    ``kv_src`` (no RoPE, not causal, gated)."""
    cross = kv_src is not None
    q, k, v = _qkv(p, x, kv_src if cross else x)
    if use_rope and not cross:
        pos = positions if positions is not None else torch.arange(
            x.shape[1], device=x.device)
        q = layers.rope(q, pos, cfg.rope_theta)
        k = layers.rope(k, pos, cfg.rope_theta)
    out = layers.flash_attention(q, k, v, causal=causal and not cross,
                                 window=window, chunk=cfg.attn_chunk)
    y = _out(p, out, x)
    return _gated(p, y) if cross else y


def attention_prefill(p, x: torch.Tensor, cfg: ModelConfig, *,
                      window: Optional[int] = None,
                      cache_len: Optional[int] = None
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """``blocks.py:119-143``: causal self-attention over x, and its KV
    cache.  With ``window`` a ring buffer of exactly ``window`` slots, token
    t at slot t % window; without, k and v padded to ``cache_len`` (default
    S + 128) slots for the decode steps."""
    s = x.shape[1]
    pos = torch.arange(s, device=x.device)
    q, k, v = _qkv(p, x, x)
    q = layers.rope(q, pos, cfg.rope_theta)
    k = layers.rope(k, pos, cfg.rope_theta)
    out = layers.flash_attention(q, k, v, causal=True, window=window,
                                 chunk=cfg.attn_chunk)
    y = _out(p, out, x)
    if window:
        keep = min(window, s)
        slots = torch.arange(s - keep, s, device=x.device) % window
        shape = (k.shape[0], window) + k.shape[2:]
        ck = k.new_zeros(shape).index_copy_(1, slots, k[:, s - keep:])
        cv = v.new_zeros(shape).index_copy_(1, slots, v[:, s - keep:])
    else:
        cache_len = cache_len or s + 128
        if cache_len < s:
            raise ValueError(f"cache_len {cache_len} < the prompt's {s} "
                             "tokens")
        pad = (0, 0, 0, 0, 0, cache_len - s)
        ck, cv = F.pad(k, pad), F.pad(v, pad)
    return y, {"k": ck, "v": cv}


def attention_decode(p, x: torch.Tensor, cache: Dict[str, torch.Tensor],
                     pos: int, cfg: ModelConfig, *,
                     window: Optional[int] = None, cross: bool = False
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """``blocks.py:146-177``.  x: (B, 1, D); cache: {"k", "v"} (B, S, KV,
    hd); pos: the tokens so far.  The new k and v go to slot ``pos % S``
    with a window (the ring buffer) and ``min(pos, S - 1)`` without, and
    the query attends over the ``min(pos + 1, S)`` valid slots.  Returns
    the output and a new cache: ``cache`` is not modified (its k and v are
    copied, one slot replaced).  ``cross``: attend over the whole cache
    (encoder or image K/V), which is returned as it is."""
    if cross:
        q = _heads_product(p, x, "wq")
        out = layers.decode_attention(q, cache["k"], cache["v"],
                                      cache["k"].shape[1])
        return _gated(p, _out(p, out, x)), cache
    q, k, v = _qkv(p, x, x)
    pos_b = torch.full((x.shape[0], 1), pos, device=x.device)
    q = layers.rope(q, pos_b, cfg.rope_theta)
    k = layers.rope(k, pos_b, cfg.rope_theta)
    s = cache["k"].shape[1]
    slot = pos % s if window else min(pos, s - 1)
    ck, cv = cache["k"].clone(), cache["v"].clone()
    ck[:, slot], cv[:, slot] = k[:, 0], v[:, 0]
    out = layers.decode_attention(q, ck, cv, min(pos + 1, s))
    return _out(p, out, x), {"k": ck, "v": cv}


# ---------------------------------------------------------------- dense MLP


def mlp_spec(cfg: ModelConfig, d_ff: Optional[int] = None
             ) -> Dict[str, Spec]:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    spec = {"wi": Spec((d, f)), "wo": Spec((f, d))}
    if cfg.act == "silu":
        spec["wg"] = Spec((d, f))
    return spec


def mlp_apply(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """``blocks.py:192-194``: the weights cast to x's dtype, then
    :func:`~repro_torch.models.layers.mlp`."""
    def w(name):
        t = getattr(p, name, None)
        return None if t is None else t.to(x.dtype)

    wi, wo, wg = w("wi"), w("wo"), w("wg")
    return _on_rows(lambda t: layers.mlp(t, wi, wo, wg, cfg.act), x, "mlp")


# ---------------------------------------------------------------- Mamba


def mamba_spec(cfg: ModelConfig) -> Dict[str, Spec]:
    d, di, n, r = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.dt_rank_
    return {
        "wx": Spec((d, di)),
        "wz": Spec((d, di)),
        "conv_w": Spec((di, cfg.d_conv)),
        "conv_b": Spec((di,), init="zeros"),
        "x_proj": Spec((di, r + 2 * n)),
        "dt_proj": Spec((r, di)),
        "dt_bias": Spec((di,), init="dt_bias"),
        "a_log": Spec((di, n), init="mamba_a"),
        "d_skip": Spec((di,), init="ones"),
        "out_proj": Spec((di, d)),
    }


def _in_proj(p, x: torch.Tensor, scan: str, state=None):
    """The two input projections, then the causal convolution with its bias
    and silu (one kernel): (xc, z, conv state)."""
    conv, _ = resolve_mixer(scan, x.device)
    xz = x @ p.wx.to(x.dtype)
    z = x @ p.wz.to(x.dtype)
    xc, conv_state = conv(xz, p.conv_w, p.conv_b, state)
    return xc, z, conv_state


def _mamba_core(p, xc: torch.Tensor, z: torch.Tensor, cfg: ModelConfig,
                scan: str = "auto", h0=None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """xc: post-conv activations (B, S, di); z: the gate's input.  Returns
    (y gated by silu(z), in xc's dtype; h_last (B, di, N) float32).  The
    ``x_proj`` and float32 ``dt_proj`` products, then softplus, the scan
    from ``h0`` (zero state when ``None``) and the gate in one kernel
    (``mamba_scan``), B and C read in place from the ``x_proj`` output.
    The scan runs in float32 (the JAX package's bf16 path runs its
    recurrence in bf16, ``blocks.py:369-375``; float32 agrees with it)."""
    n, r = cfg.ssm_state, cfg.dt_rank_
    proj = _product(xc, p.x_proj.to(xc.dtype), "x_proj")         # (B,S,r+2N)
    dt_r, b_mat, c_mat = torch.split(proj, [r, n, n], dim=-1)
    dt_lin = _product(dt_r.float(), p.dt_proj.float(), "dt_proj")  # (B,S,di)
    a = -torch.exp(p.a_log.float())                                # (di,N)
    _, mixer = resolve_mixer(scan, xc.device)
    return mixer(xc, dt_lin, p.dt_bias, b_mat, c_mat, a, p.d_skip, z, h0)


def mamba_apply(p, x: torch.Tensor, cfg: ModelConfig,
                scan: str = "auto") -> torch.Tensor:
    return mamba_prefill(p, x, cfg, scan)[0]


def mamba_prefill(p, x: torch.Tensor, cfg: ModelConfig, scan: str = "auto"
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The mixer over a whole sequence, and the cache a decode continues
    from: the conv tail (B, K-1, di) and the scan's final state
    (``model.py:525-550``)."""
    xc, z, conv_state = _in_proj(p, x, scan)
    y, h_last = _mamba_core(p, xc, z, cfg, scan)
    out = _product(y, p.out_proj.to(x.dtype), "out_proj")
    return out, {"conv": conv_state, "h": h_last}


def mamba_init_cache(cfg: ModelConfig, batch: int, dtype: torch.dtype,
                     device) -> Dict[str, torch.Tensor]:
    return {
        "conv": torch.zeros(batch, cfg.d_conv - 1, cfg.d_inner, dtype=dtype,
                            device=device),
        "h": torch.zeros(batch, cfg.d_inner, cfg.ssm_state,
                         dtype=torch.float32, device=device),
    }


def mamba_decode(p, x: torch.Tensor, cache: Dict[str, torch.Tensor],
                 cfg: ModelConfig, scan: str = "auto"
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Single-token recurrent step: the prefill's two kernels at S = 1,
    from the cache's conv tail and scan state.  x: (B, 1, D).  Returns the
    output and a new cache; ``cache`` is not modified."""
    xc, z, conv_state = _in_proj(p, x, scan, cache["conv"])
    y, h = _mamba_core(p, xc, z, cfg, scan, h0=cache["h"])
    out = _product(y, p.out_proj.to(x.dtype), "out_proj")
    return out, {"conv": conv_state, "h": h}


def norm_spec(cfg: ModelConfig) -> Dict[str, Spec]:
    return {"scale": Spec((cfg.d_model,), init="zeros")}


def norm_apply(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    return layers.rms_norm(x, p.scale, cfg.norm_eps)
