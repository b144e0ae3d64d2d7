"""The per-family blocks of the port, from the JAX package's
``models/blocks.py``: the norm (``:500-505``), attention and the dense MLP
(``:63-197``) for the ``dense`` family, the mixture of experts
(``:200-337``) for ``moe``, the Mamba-1 mixer (``:340-425``) for ``ssm``
and the RG-LRU (``:431-497``) for ``hybrid``; each with its parameter
specs, whose axes follow the mesh of a
:class:`~repro_torch.distributed.context.MeshCtx` (``ctx``; ``None`` is no
mesh) as the reference's spec functions do (``blocks.py:1-57``): attention
shards its heads over ``"model"`` when they divide it (KV replicated when
only the query heads do), else its head dim, else nothing; an MLP or mixer
width its ``"model"`` axis when that divides it.

Every block takes ``p``, a module (or any object) with the parameters as
attributes under the JAX package's leaf names and layouts (attention: ``wq``
(d, H, hd), ``wk``/``wv`` (d, KV, hd), ``wo`` (H, hd, d), ``bq``/``bk``/
``bv``; the MLP: ``wi``, ``wg`` (d, f), ``wo`` (f, d); the mixer: ``wx``
(d, di), ``x_proj`` (di, r+2N), ``a_log`` (di, N), …).  Attention is
:func:`~repro_torch.models.layers.flash_attention` over the whole sequence
and :func:`~repro_torch.models.layers.decode_attention` over the cache.
Under a mesh whose ``"model"`` axis does not divide the query heads, they
are padded up to the next multiple (``_padded_heads``, with ``wq``,
``bq`` and ``wo`` of the padded count), and query head j reads kv head
``min(j, H - 1) // (H / KV)`` (``_kv_index``: the padded heads read the
last real head's group, as the reference's code has it; its docstring
says group 0); without padding that is j // (H / KV), the grouping the
attention functions do themselves.  Between its GEMMs the mixer runs two
kernels, chosen by ``scan=``
(:func:`repro_torch.kernels.ssm_scan.resolve_mixer`): the causal
convolution with its bias and silu, and ``mamba_scan`` (softplus, the
selective scan and the gate); the JAX package computes the recurrence
through ``layers.chunked_linear_recurrence``.

The MoE layer (``router`` (d, E), ``wi``/``wg`` (E, d, f), ``wo`` (E, f,
d), ``shared`` an MLP) and the RG-LRU (``wx``, ``wy`` (d, W), ``conv_w``
(W, K), ``w_input``/``w_rec`` (W, W), ``lam``, ``out_proj`` (W, d), …) run
no kernel of the port: the reference computes them with XLA, and so does
the port with PyTorch's operations.  Under a mesh the MoE layer runs per
shard, as the reference's ``shard_map`` does (:func:`moe_apply`).
"""
from __future__ import annotations

import contextlib
import math
from types import SimpleNamespace
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed.context import MeshCtx
from repro_torch.kernels.ssm_scan import resolve_mixer

from . import layers
from .config import ModelConfig
from .params import Spec

__all__ = ["attention_spec", "attention_apply", "cross_attention",
           "attention_prefill", "attention_decode", "mlp_spec", "mlp_apply",
           "moe_spec", "moe_apply", "dispatch_slots", "routing_stats",
           "mamba_spec", "mamba_apply", "mamba_prefill", "mamba_init_cache",
           "mamba_decode", "rglru_spec", "rglru_apply", "rglru_prefill",
           "rglru_init_cache", "rglru_decode", "norm_spec", "norm_apply"]


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


# ---------------------------------------------------------------- helpers


def _ctx(ctx: Optional[MeshCtx]) -> MeshCtx:
    return MeshCtx(None) if ctx is None else ctx


def _padded_heads(cfg: ModelConfig, ctx: Optional[MeshCtx]) -> int:
    """The query heads, padded up to a multiple of the ``"model"`` axis
    when it does not divide them (``blocks.py:26-31``)."""
    tp, h = _ctx(ctx).tp_size, cfg.n_heads
    if cfg.pad_heads and tp > 1 and h % tp != 0:
        return -(-h // tp) * tp
    return h


def _attn_layout(cfg: ModelConfig, ctx: Optional[MeshCtx]):
    """(query heads, kv heads, query head dim, kv head dim) axes
    (``blocks.py:34-43``)."""
    tp = _ctx(ctx).tp_size
    hp, kv, hd = _padded_heads(cfg, ctx), cfg.n_kv_heads, cfg.head_dim_
    if hp % tp == 0 and kv % tp == 0:
        return "model", "model", None, None
    if hp % tp == 0:
        return "model", None, None, None          # KV replicated (GQA-TP)
    if hd % tp == 0:
        return None, None, "model", "model"       # head_dim TP
    return None, None, None, None


def _kv_index(cfg: ModelConfig, ctx: Optional[MeshCtx]) -> List[int]:
    """Each (padded) query head's kv head, ``min(j, H - 1) // group``
    (``blocks.py:46-53``)."""
    h, kv = cfg.n_heads, cfg.n_kv_heads
    group = max(h // kv, 1)
    return [min(j, h - 1) // group for j in range(_padded_heads(cfg, ctx))]


def _mlp_axis(d_ff: int, ctx: Optional[MeshCtx]) -> Optional[str]:
    return "model" if d_ff % _ctx(ctx).tp_size == 0 else None


# ---------------------------------------------------------------- attention


def attention_spec(cfg: ModelConfig, ctx: Optional[MeshCtx] = None, *,
                   cross: bool = False) -> Dict[str, Spec]:
    """``blocks.py:63-80``: the query heads padded under ``ctx``'s mesh
    (:func:`_padded_heads`), the axes of :func:`_attn_layout`."""
    d, kv, hd = cfg.d_model, cfg.n_kv_heads, cfg.head_dim_
    hp = _padded_heads(cfg, ctx)
    qh, kvh, qd, kvd = _attn_layout(cfg, ctx)
    spec = {"wq": Spec((d, hp, hd), ("fsdp", qh, qd)),
            "wk": Spec((d, kv, hd), ("fsdp", kvh, kvd)),
            "wv": Spec((d, kv, hd), ("fsdp", kvh, kvd)),
            "wo": Spec((hp, hd, d), (qh, qd, "fsdp"))}
    if cfg.qkv_bias and not cross:
        spec["bq"] = Spec((hp, hd), (qh, qd), init="zeros")
        spec["bk"] = Spec((kv, hd), (kvh, kvd), init="zeros")
        spec["bv"] = Spec((kv, hd), (kvh, kvd), init="zeros")
    if cross:
        spec["gate"] = Spec((), (), init="zeros")  # gated cross-attn (VLM)
    return spec


def _for_heads(k: torch.Tensor, v: torch.Tensor, cfg: ModelConfig,
               ctx: Optional[MeshCtx]):
    """k and v (B, S, KV, hd) for the query heads: with padded heads one kv
    head per query head by :func:`_kv_index` (the reference's ``take``);
    else as they are, the attention grouping query head j on kv head
    j // (H / KV), the same map."""
    if _padded_heads(cfg, ctx) == cfg.n_heads:
        return k, v
    idx = torch.as_tensor(_kv_index(cfg, ctx), device=k.device)
    return k.index_select(2, idx), v.index_select(2, idx)


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


def attention_apply(p, x: torch.Tensor, cfg: ModelConfig,
                    ctx: Optional[MeshCtx] = None, *,
                    causal: bool = True, window: Optional[int] = None,
                    use_rope: bool = True,
                    positions: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """``blocks.py:93-116``: self-attention over x (the reference's
    ``kv_src`` case is :func:`cross_attention`)."""
    q, k, v = _qkv(p, x, x)
    if use_rope:
        pos = positions if positions is not None else torch.arange(
            x.shape[1], device=x.device)
        q = layers.rope(q, pos, cfg.rope_theta)
        k = layers.rope(k, pos, cfg.rope_theta)
    out = layers.flash_attention(q, *_for_heads(k, v, cfg, ctx),
                                 causal=causal, window=window,
                                 chunk=cfg.attn_chunk)
    return _out(p, out, x)


def cross_attention(p, x: torch.Tensor, src: torch.Tensor, cfg: ModelConfig,
                    ctx: Optional[MeshCtx] = None
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Cross-attention of x over ``src`` (no RoPE, not causal, gated;
    ``blocks.py:93-116`` with ``kv_src``), and the k and v of ``src``
    (B, S_src, KV, hd): the cross cache that a prefill keeps for its decode
    steps (``model.py:562-567``)."""
    q, k, v = _qkv(p, x, src)
    out = layers.flash_attention(q, *_for_heads(k, v, cfg, ctx),
                                 causal=False, chunk=cfg.attn_chunk)
    return _gated(p, _out(p, out, x)), {"k": k, "v": v}


def attention_prefill(p, x: torch.Tensor, cfg: ModelConfig,
                      ctx: Optional[MeshCtx] = None, *,
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
    out = layers.flash_attention(q, *_for_heads(k, v, cfg, ctx),
                                 causal=True, window=window,
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
                     pos: int, cfg: ModelConfig,
                     ctx: Optional[MeshCtx] = None, *,
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
        out = layers.decode_attention(
            q, *_for_heads(cache["k"], cache["v"], cfg, ctx),
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
    out = layers.decode_attention(q, *_for_heads(ck, cv, cfg, ctx),
                                  min(pos + 1, s))
    return _out(p, out, x), {"k": ck, "v": cv}


# ---------------------------------------------------------------- dense MLP


def mlp_spec(cfg: ModelConfig, ctx: Optional[MeshCtx] = None,
             d_ff: Optional[int] = None) -> Dict[str, Spec]:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    ax = _mlp_axis(f, ctx)
    spec = {"wi": Spec((d, f), ("fsdp", ax)),
            "wo": Spec((f, d), (ax, "fsdp"))}
    if cfg.act == "silu":
        spec["wg"] = Spec((d, f), ("fsdp", ax))
    return spec


def mlp_apply(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """``blocks.py:192-194``: the weights cast to x's dtype, then
    :func:`~repro_torch.models.layers.mlp`."""
    def w(name):
        t = getattr(p, name, None)
        return None if t is None else t.to(x.dtype)

    wi, wo, wg = w("wi"), w("wo"), w("wg")
    return _on_rows(lambda t: layers.mlp(t, wi, wo, wg, cfg.act), x, "mlp")


# ---------------------------------------------------------------- MoE


def moe_spec(cfg: ModelConfig, ctx: Optional[MeshCtx] = None) -> Dict:
    """``blocks.py:200-216``: the float32-routed experts and, with
    ``n_shared_experts``, one shared MLP of ``moe_d_ff · n_shared`` width.
    The experts over ``"model"`` when it divides them (EP), else their
    width."""
    d, e, f = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    ax = (("model", "fsdp", None) if e % _ctx(ctx).tp_size == 0
          else (None, "fsdp", "model"))
    spec: Dict = {"router": Spec((d, e), (None, None),
                                 scale=0.02 / math.sqrt(d)),
                  "wi": Spec((e, d, f), ax), "wg": Spec((e, d, f), ax),
                  "wo": Spec((e, f, d), (ax[0], ax[2], ax[1]))}
    if cfg.n_shared_experts:
        spec["shared"] = mlp_spec(cfg, ctx, d_ff=f * cfg.n_shared_experts)
    return spec


# the profiler ranges of an MoE layer: the router, the dispatch and the
# combine; the experts' three products with their activation and gate
MOE_ROUTE, MOE_EXPERTS = "moe_route", "moe_experts"
_STATS: Optional[List[torch.Tensor]] = None


@contextlib.contextmanager
def routing_stats():
    """Within the block, every MoE layer appends to the list it yields a
    record of tensors on the layer's device (no host sync): ``dropped``,
    the (token, choice) pairs its capacity dropped; ``used``, the experts
    that received a choice; ``topi`` (T, k), each token's experts;
    ``logits`` (T, E), the float32 router logits."""
    global _STATS
    outer, _STATS = _STATS, []
    try:
        yield _STATS
    finally:
        _STATS = outer


def dispatch_slots(flat_e: torch.Tensor, n_experts: int, capacity: int
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                              torch.Tensor]:
    """The capacity-limited routing of ``blocks.py:234-247``.  ``flat_e``
    (T·k,): the expert of each (token, choice), flattened token-major.
    Expert e takes the first ``min(count_e, capacity)`` entries of its run
    in the stable order of ``flat_e`` (``jnp.argsort`` is stable: a
    token's choice over capacity is dropped, the earlier tokens kept).
    Returns (idx (E, C): the flat index each slot holds, T·k when empty;
    valid (E, C); counts (E,); slot (T·k,): each entry's place among its
    expert's, kept when below ``capacity``)."""
    n = flat_e.numel()
    order = torch.argsort(flat_e, stable=True)
    counts = torch.bincount(flat_e, minlength=n_experts)
    starts = torch.cumsum(counts, 0) - counts
    c = torch.arange(capacity, device=flat_e.device)
    valid = c[None, :] < counts[:, None]
    held = order[(starts[:, None] + c[None, :]).clamp(max=n - 1)]
    idx = torch.where(valid, held, n)
    rank = torch.empty_like(order)
    rank[order] = torch.arange(n, device=flat_e.device)
    return idx, valid, counts, rank - starts[flat_e]


def _gather_rows(src: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """``src[rows]``, a row index of ``len(src)`` giving zeros
    (``mode="fill"``)."""
    return F.pad(src, (0, 0, 0, 1))[rows]


def _sum_choices(buf: torch.Tensor, pos: torch.Tensor, kept: torch.Tensor
                 ) -> torch.Tensor:
    """out[t] = Σ_j buf[pos[t, j]] over the kept choices j of token t, in
    ascending column order, in buf's dtype, starting from zero: the
    reference's scatter-add of (E, C) rows in ascending expert order
    (``blocks.py:265-266``), as gathers and adds, without atomics."""
    out = buf.new_zeros((pos.shape[0], buf.shape[1]))
    for j in range(pos.shape[1]):
        rows = buf[pos[:, j]]
        out = out + torch.where(kept[:, j, None], rows, rows.new_zeros(()))
    return out


class _Dispatch(torch.autograd.Function):
    """The tokens into the experts' (E·C, D) buffer, ``tok`` (E·C,) the
    token of each slot (T for an empty one, a zero row); its backward is
    the combine of the gradient (:func:`_sum_choices`): each token's slots
    in ascending expert order, the reference's scatter-add order."""

    @staticmethod
    def forward(ctx, x, tok, pos, kept):
        ctx.save_for_backward(pos, kept)
        return _gather_rows(x, tok)

    @staticmethod
    def backward(ctx, g):
        pos, kept = ctx.saved_tensors
        return _sum_choices(g, pos, kept), None, None, None


class _Combine(torch.autograd.Function):
    """Each token's kept expert outputs summed in ascending expert order
    (:func:`_sum_choices`); its backward is the dispatch of the gradient
    (the gradient of an empty slot is zero)."""

    @staticmethod
    def forward(ctx, buf, tok, pos, kept):
        ctx.save_for_backward(tok)
        return _sum_choices(buf, pos, kept)

    @staticmethod
    def backward(ctx, g):
        tok, = ctx.saved_tensors
        return _gather_rows(g, tok), None, None, None


def _route(x: torch.Tensor, router: torch.Tensor, cfg: ModelConfig,
           capacity: int) -> SimpleNamespace:
    """``blocks.py:219-243``: the routing of x (T, D) over all E experts.
    The router in float32 (TF32 off, :func:`repro_torch._device.
    resolve_device`), softmax, top-k renormalised; aux = E · Σ_e mean
    prob_e · (choices of e)/(T·k); each expert's first ``capacity``
    choices (:func:`dispatch_slots`).  Profiler range ``moe_route``."""
    t = x.shape[0]
    e, k = cfg.n_experts, cfg.top_k
    with torch.profiler.record_function(MOE_ROUTE):
        logits = x.float() @ router.float()
        probs = torch.softmax(logits, -1)                         # (T, E)
        topv, topi = torch.topk(probs, k, dim=-1)                 # (T, k)
        topv = topv / topv.sum(-1, keepdim=True)
        flat_e = topi.reshape(-1)
        ce = torch.bincount(flat_e, minlength=e).float() / (t * k)
        aux = e * (probs.mean(0) * ce).sum()
        idx, valid, counts, slot = dispatch_slots(flat_e, e, capacity)
    return SimpleNamespace(logits=logits, topv=topv, topi=topi,
                           flat_e=flat_e, aux=aux, idx=idx, valid=valid,
                           counts=counts, slot=slot, capacity=capacity)


def _experts(x: torch.Tensor, p, r: SimpleNamespace,
             n_local: Optional[int] = None, offset: int = 0
             ) -> torch.Tensor:
    """``blocks.py:244-267``: the dispatch of routing ``r``'s choices of
    the ``n_local`` experts from ``offset`` (default: every expert), whose
    weights ``p.wi``, ``p.wg`` (n_local, d, f) and ``p.wo`` (n_local, f,
    d) are, those experts and the combine.  Returns (T, D) in x's dtype:
    the local experts' share of each token's output.

    The (n_local, C, D) buffer runs silu(x·wi) ⊙ (x·wg), then ·wo, as three
    batched products in x's dtype; each slot is scaled by its gate
    (float32, cast to x's dtype) and summed into its token in ascending
    expert order.  The dispatch and the combine are the profiler range
    ``moe_route``, the experts ``moe_experts``."""
    t, d = x.shape
    k, capacity, flat_e = r.topi.shape[1], r.capacity, r.flat_e
    n_local = r.counts.numel() if n_local is None else n_local
    with torch.profiler.record_function(MOE_ROUTE):
        mine = slice(offset, offset + n_local)
        idx, valid, counts = r.idx[mine], r.valid[mine], r.counts[mine]
        if _STATS is not None:
            _STATS.append(dict(
                dropped=(counts - capacity).clamp(min=0).sum(),
                used=(counts > 0).sum(), topi=r.topi,
                logits=r.logits.detach()))
        tok = torch.where(valid, idx // k, t).reshape(-1)    # (n_local·C,)
        gate = torch.where(valid,
                           r.topv.reshape(-1)[idx.clamp(max=t * k - 1)],
                           0.0)                              # (n_local, C)
        # each (token, choice)'s row in the flat buffer, the choices of a
        # token in ascending expert order; kept when within capacity and
        # local
        local = (flat_e >= offset) & (flat_e < offset + n_local)
        pos = ((flat_e - offset).clamp(0, n_local - 1) * capacity
               + r.slot.clamp(max=capacity - 1)).view(t, k)
        kept = ((r.slot < capacity) & local).view(t, k)
        order = torch.argsort(r.topi, dim=-1)
        pos, kept = pos.gather(1, order), kept.gather(1, order)
        xg = _Dispatch.apply(x, tok, pos, kept).view(n_local, capacity, d)
    with torch.profiler.record_function(MOE_EXPERTS):
        wi, wg, wo = p.wi.to(x.dtype), p.wg.to(x.dtype), p.wo.to(x.dtype)
        hidden = F.silu(torch.bmm(xg, wi)) * torch.bmm(xg, wg)
        ye = torch.bmm(hidden, wo) * gate[..., None].to(x.dtype)
    with torch.profiler.record_function(MOE_ROUTE):
        return _Combine.apply(ye.view(n_local * capacity, d), tok, pos, kept)


def _moe_local(x: torch.Tensor, p, cfg: ModelConfig, capacity: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``blocks.py:219-267``: x (T, D) routed (:func:`_route`) and run
    through every expert (:func:`_experts`).  Returns (out (T, D) in x's
    dtype, the load-balance aux loss)."""
    r = _route(x, p.router, cfg, capacity)
    return _experts(x, p, r), r.aux


def _moe_sharded(xf: torch.Tensor, p, cfg: ModelConfig, ctx: MeshCtx
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's ``shard_map`` branch (``blocks.py:283-333``), shard
    by shard on x's device.  The tokens xf (T, D) split over the data axes
    when they divide them (else every data shard holds all of them, and
    computes one answer); each data shard has its own capacity
    ``int(T_loc · k / E · capacity_factor) + 1``, rounded up to a multiple
    of 8, and is routed once (:func:`_route`: every model shard of the
    reference routes alike).  Under expert parallelism (``"model"``
    divides E and is over 1) model shard m runs :func:`_experts` on its
    E / tp experts from ``m · E / tp``; else on every expert's m-th slice
    of the width (``wi``, ``wg`` columns, ``wo`` rows).  Its weights are
    its block along ``"model"``, whole along the FSDP axis (the
    reference's all-gather over it).  The model shards' outputs are summed
    in ascending order (the psum over ``"model"``); aux is the mean of the
    data shards' (the pmean) when they split the tokens.  Under
    :func:`routing_stats` each model shard's record also names its
    ``data_shard``, ``model_shard`` and ``experts`` (first, past-last):
    its ``dropped`` counts its experts' drops, so a data shard's are the
    sum over its records of distinct ``experts``."""
    t = xf.shape[0]
    e, tp = cfg.n_experts, ctx.tp_size
    ep = e % tp == 0 and tp > 1
    dp_ok = t % ctx.dp_size == 0
    n_dp = ctx.dp_size if dp_ok else 1
    t_loc = t // n_dp
    cap = int(t_loc * cfg.top_k / e * cfg.capacity_factor) + 1
    cap = -(-cap // 8) * 8
    n_local = e // tp if ep else e
    w_spec = ("model", None, None) if ep else (None, None, "model")
    wo_spec = ("model", None, None) if ep else (None, "model", None)
    shards = []
    for m in range(tp):
        coord = {"model": m}
        w, wo = ctx.sharding(*w_spec), ctx.sharding(*wo_spec)
        shards.append((SimpleNamespace(
            wi=w.block(p.wi, coord), wg=w.block(p.wg, coord),
            wo=wo.block(p.wo, coord)), m * n_local if ep else 0))
    outs, auxes = [], []
    for i in range(n_dp):
        xl = xf[i * t_loc:(i + 1) * t_loc]
        r = _route(xl, p.router, cfg, cap)
        out = None
        for m, (w, offset) in enumerate(shards):
            o = _experts(xl, w, r, n_local, offset)
            if _STATS is not None:
                _STATS[-1].update(data_shard=i, model_shard=m,
                                  experts=(offset, offset + n_local))
            out = o if out is None else out + o
        outs.append(out)
        auxes.append(r.aux)
    out = outs[0] if n_dp == 1 else torch.cat(outs)
    return out, torch.stack(auxes).sum() / n_dp


def moe_apply(p, x: torch.Tensor, cfg: ModelConfig,
              ctx: Optional[MeshCtx] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) → (out, aux loss) (``blocks.py:270-337``).  Without a
    mesh the single-device branch: capacity ``int(B·S·k / E ·
    capacity_factor) + 1`` from this call's own tokens, so a decode step
    of 4 tokens gets a capacity of its own.  Under a mesh
    :func:`_moe_sharded`.  Then the shared expert's MLP added."""
    b, s, d = x.shape
    xf = x.reshape(b * s, d)
    if _ctx(ctx).mesh is None:
        cap = int(b * s * cfg.top_k / cfg.n_experts
                  * cfg.capacity_factor) + 1
        out, aux = _moe_local(xf, p, cfg, cap)
    else:
        out, aux = _moe_sharded(xf, p, cfg, ctx)
    out = out.view(b, s, d).to(x.dtype)
    if cfg.n_shared_experts:
        out = out + mlp_apply(p.shared, x, cfg)
    return out, aux


# ---------------------------------------------------------------- Mamba


def mamba_spec(cfg: ModelConfig, ctx: Optional[MeshCtx] = None
               ) -> Dict[str, Spec]:
    """``blocks.py:340-353``: d_inner over ``"model"`` when it divides."""
    d, di, n, r = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.dt_rank_
    ax = _mlp_axis(di, ctx)
    return {
        "wx": Spec((d, di), ("fsdp", ax)),
        "wz": Spec((d, di), ("fsdp", ax)),
        "conv_w": Spec((di, cfg.d_conv), (ax, None)),
        "conv_b": Spec((di,), (ax,), init="zeros"),
        "x_proj": Spec((di, r + 2 * n), (ax, None)),
        "dt_proj": Spec((r, di), (None, ax)),
        "dt_bias": Spec((di,), (ax,), init="dt_bias"),
        "a_log": Spec((di, n), (ax, None), init="mamba_a"),
        "d_skip": Spec((di,), (ax,), init="ones"),
        "out_proj": Spec((di, d), (ax, "fsdp")),
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


# ---------------------------------------------------------------- RG-LRU


def rglru_spec(cfg: ModelConfig, ctx: Optional[MeshCtx] = None
               ) -> Dict[str, Spec]:
    """``blocks.py:431-446``: the width over ``"model"`` when it
    divides."""
    d, w = cfg.d_model, cfg.lru_width_
    ax = _mlp_axis(w, ctx)
    return {
        "wx": Spec((d, w), ("fsdp", ax)),
        "wy": Spec((d, w), ("fsdp", ax)),        # the gate branch
        "conv_w": Spec((w, cfg.d_conv), (ax, None)),
        "conv_b": Spec((w,), (ax,), init="zeros"),
        "w_input": Spec((w, w), (None, ax)),
        "b_input": Spec((w,), (ax,), init="zeros"),
        "w_rec": Spec((w, w), (None, ax)),
        "b_rec": Spec((w,), (ax,), init="zeros"),
        "lam": Spec((w,), (ax,), init="rglru_a"),
        "out_proj": Spec((w, d), (ax, "fsdp")),
    }


_RGLRU_C = 8.0
# the profiler range of the RG-LRU's convolution
RGLRU_CONV = "rglru_conv"


def _rglru_gates(p, xc: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``blocks.py:448-461``, all in float32: the input and recurrence
    gates, a = exp(-8 · softplus(λ) · r), b = sqrt(max(1 - a², 1e-12)) ·
    x · i."""
    xf = xc.float()
    i_gate = torch.sigmoid(xf @ p.w_input.float() + p.b_input.float())
    r_gate = torch.sigmoid(xf @ p.w_rec.float() + p.b_rec.float())
    a = torch.exp(-_RGLRU_C * F.softplus(p.lam.float()) * r_gate)
    b = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * (xf * i_gate)
    return a, b


def _rglru_in(p, x: torch.Tensor, state=None):
    """The two input projections, the convolution (no silu; the profiler
    range ``rglru_conv``) from ``state`` plus its bias, and the gates: (a,
    b, the gate branch, conv state)."""
    xz = x @ p.wx.to(x.dtype)
    gate = x @ p.wy.to(x.dtype)
    with torch.profiler.record_function(RGLRU_CONV):
        xc, conv_state = layers.causal_conv1d(xz, p.conv_w.to(x.dtype),
                                              state)
    a, b = _rglru_gates(p, xc + p.conv_b.to(x.dtype))
    return a, b, gate, conv_state


def _rglru_out(p, hs: torch.Tensor, gate: torch.Tensor) -> torch.Tensor:
    """h in the activation dtype times gelu(gate) (the tanh form,
    ``jax.nn.gelu``'s default), then ``out_proj``."""
    y = hs.to(gate.dtype) * F.gelu(gate, approximate="tanh")
    return y @ p.out_proj.to(gate.dtype)


def rglru_apply(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """``blocks.py:464-474``."""
    return rglru_prefill(p, x, cfg)[0]


def rglru_prefill(p, x: torch.Tensor, cfg: ModelConfig
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The RG-LRU over a whole sequence from h0 = 0, the recurrence chunked
    at ``cfg.scan_chunk``, and the cache a decode continues from: the conv
    tail (B, K-1, W) and the last state (B, W) float32
    (``model.py:496-512``)."""
    a, b, gate, conv_state = _rglru_in(p, x)
    h0 = torch.zeros(a.shape[0], a.shape[2], device=x.device)
    hs, h_last = layers.chunked_linear_recurrence(a, b, h0, cfg.scan_chunk)
    return _rglru_out(p, hs, gate), {"conv": conv_state, "h": h_last}


def rglru_init_cache(cfg: ModelConfig, batch: int, dtype: torch.dtype,
                     device) -> Dict[str, torch.Tensor]:
    return {
        "conv": torch.zeros(batch, cfg.d_conv - 1, cfg.lru_width_,
                            dtype=dtype, device=device),
        "h": torch.zeros(batch, cfg.lru_width_, dtype=torch.float32,
                         device=device),
    }


def rglru_decode(p, x: torch.Tensor, cache: Dict[str, torch.Tensor],
                 cfg: ModelConfig
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One step (``blocks.py:483-497``) from the cache's conv tail and
    state.  x: (B, 1, D).  Returns the output and a new cache; ``cache`` is
    not modified."""
    a, b, gate, conv_state = _rglru_in(p, x, cache["conv"])
    h = a[:, 0] * cache["h"] + b[:, 0]
    return _rglru_out(p, h[:, None], gate), {"conv": conv_state, "h": h}


# ---------------------------------------------------------------- norms


def norm_spec(cfg: ModelConfig) -> Dict[str, Spec]:
    return {"scale": Spec((cfg.d_model,), (None,), init="zeros")}


def norm_apply(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    return layers.rms_norm(x, p.scale, cfg.norm_eps)
