"""The primitives of the port's LM families, from the JAX package's
``models/layers.py``.

``rms_norm`` carries the reference's custom gradient (``layers.py:25-68``)
as a ``torch.autograd.Function``, and so does ``flash_attention``
(``_flash_core``, ``layers.py:110-230``): the q-chunk × kv-chunk online
softmax in float32, whose backward recomputes the score blocks chunk by
chunk from (q, k, v, o, m, l) and never keeps a score-sized tensor.
``rope``, ``decode_attention`` and ``mlp`` are the reference's formulas.
``causal_conv1d`` is the plain version the ``causal_conv1d`` kernel is held
to (:mod:`repro_torch.kernels.ref`), re-exported here: the depthwise causal
convolution with its carried state and no silu, which the RG-LRU runs as it
is (``layers.py:300-316``).  ``chunked_linear_recurrence`` (``layers.py:
318-410``) is a ``torch.autograd.Function`` too, with the reference's
reverse-scan backward.

Query heads and kv heads (GQA): the reference repeats each kv head for its
``H / KV`` query heads (``_repeat_kv``, ``blocks._kv_index``: query head j
reads kv head j // (H / KV); one card pads no heads).  Here the query heads
of one kv head are stacked as rows of one product with that kv head
instead, so no repeated copy of K or V is made, and a kv head's gradient is
summed over its query heads inside the float32 product (the reference sums
the repeated heads' gradients after casting them to the kv dtype).  The
float32 products run in full float32: the entry points pin TF32 off
(:func:`repro_torch._device.resolve_device`).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.ref import causal_conv1d

__all__ = ["rms_norm", "rope", "rope_freqs", "flash_attention",
           "decode_attention", "mlp", "causal_conv1d",
           "chunked_linear_recurrence"]


def _rms_inv(x: torch.Tensor, eps: float) -> torch.Tensor:
    """1/rms of x's last axis: the variance accumulated in float32, its
    inverse cast to ``x.dtype``."""
    var = x.float().square().mean(-1, keepdim=True)
    return torch.rsqrt(var + eps).to(x.dtype)


class _RMSNorm(torch.autograd.Function):
    """RMSNorm with the reference's dtype-preserving backward
    (``_rms_norm_bwd``, ``layers.py:53-65``): dx in x's dtype, Σ g·x
    accumulated in float32, dscale from the float32 product."""

    @staticmethod
    def forward(ctx, x, scale, eps):
        inv = _rms_inv(x, eps)
        ctx.save_for_backward(x, inv, scale)
        return x * inv * (1 + scale.to(x.dtype))

    @staticmethod
    def backward(ctx, dy):
        x, inv, scale = ctx.saved_tensors
        n = x.shape[-1]
        g = dy * (1 + scale.to(dy.dtype))
        gx = (g.float() * x.float()).sum(-1, keepdim=True)
        inv_f32 = inv.float()
        corr = (inv_f32 * inv_f32 * inv_f32 * gx / n).to(x.dtype)
        dx = g * inv - x * corr
        dscale = (dy.float() * (x * inv).float()).reshape(-1, n).sum(0)
        return dx, dscale.to(scale.dtype), None


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm as ``layers.py:26-50``: the variance accumulated in float32,
    its inverse cast to ``x.dtype``, the scale applied as ``1 + scale``."""
    return _RMSNorm.apply(x, scale, eps)


def rope_freqs(half: int, theta: float, device=None) -> torch.Tensor:
    """The rotary frequencies ``exp(-i · log(θ) / half)``, i < half, in
    float32 (``layers.py:75-76``; not ``θ^(-2i/hd)``, which rounds
    otherwise).  XLA's CPU exp rounds a few of them the other way, so at
    a position p the JAX package's angles on the CPU differ by up to
    p · ulp(f) (``tests/test_torch_attention.py``)."""
    return torch.exp(-torch.arange(half, dtype=torch.float32, device=device)
                     * (math.log(theta) / half))


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """Rotary embedding in the rotate-half layout (``layers.py:71-84``).
    x: (B, S, H, hd); positions: (S,) or (B, S).  The angles and the
    rotation in float32 (:func:`rope_freqs`), cast back to ``x.dtype``."""
    half = x.shape[-1] // 2
    freqs = rope_freqs(half, theta, x.device)
    if positions.ndim == 1:
        ang = positions[None, :, None].float() * freqs
    else:
        ang = positions[..., None].float() * freqs
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def _mask_bias(qp: torch.Tensor, kp: torch.Tensor, sk0: int, causal: bool,
               window: Optional[int]) -> torch.Tensor:
    """Additive float32 bias (qc, kc) (``layers.py:95-107``): 0 where a
    query position sees a key position, −inf where not (kv padding,
    causality, the window)."""
    mask = (kp[None, :] < sk0).expand(qp.shape[0], kp.shape[0])
    if causal:
        mask = mask & (qp[:, None] >= kp[None, :])
    if window is not None:
        mask = mask & (qp[:, None] - kp[None, :] < window)
    return torch.zeros(mask.shape, dtype=torch.float32,
                       device=qp.device).masked_fill_(~mask, float("-inf"))


def _grouped(x: torch.Tensor, kvh: int) -> torch.Tensor:
    """(B, S, H, hd) → float32 (B, KV, S, rep, hd): the query heads of each
    kv head side by side, so a chunk of positions is a (qc · rep, hd) block
    of rows."""
    b, s, h, hd = x.shape
    return x.float().reshape(b, s, kvh, h // kvh, hd).transpose(1, 2) \
        .contiguous()


def _ungrouped(x: torch.Tensor) -> torch.Tensor:
    """(B, KV, S, rep, ...) → (B, S, KV · rep, ...)."""
    b, kvh, s, rep = x.shape[:4]
    return x.transpose(1, 2).reshape(b, s, kvh * rep, *x.shape[4:])


def _heads(x: torch.Tensor) -> torch.Tensor:
    """(B, S, KV, hd) → float32 (B, KV, S, hd)."""
    return x.float().transpose(1, 2).contiguous()


class _FlashCore(torch.autograd.Function):
    """Flash attention with the recompute backward (``_flash_core``,
    ``layers.py:110-230``) on chunk-padded inputs: q (B, Sq, H, hd), k and
    v (B, Sk, KV, hd), Sq and Sk multiples of the chunks qc and kc; sq0 and
    sk0 the lengths before padding, ``q_offset`` the position of q's first
    row.  The forward saves only (q, k, v, o, m, l); the backward forms
    ``delta``, ``1/l`` and, per kv chunk, the score blocks of every q chunk
    again: dq summed over the kv chunks in order, dk and dv per kv chunk
    summed over the q chunks in order, as ``attn_bwd`` does."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset, qc, kc, sq0, sk0):
        b, sq, h, hd = q.shape
        sk, kvh = k.shape[1], k.shape[2]
        rep, scale = h // kvh, 1.0 / math.sqrt(hd)
        qg, kg, vg = _grouped(q, kvh), _heads(k), _heads(v)
        out = torch.empty((b, kvh, sq, rep, hd), dtype=q.dtype,
                          device=q.device)
        m_all = torch.empty((b, kvh, sq, rep), dtype=torch.float32,
                            device=q.device)
        l_all = torch.empty_like(m_all)
        kp_all = torch.arange(sk, device=q.device)
        for i in range(sq // qc):
            rows = slice(i * qc, (i + 1) * qc)
            qb = qg[:, :, rows].reshape(b, kvh, qc * rep, hd)
            qp = torch.arange(qc, device=q.device) + (i * qc + q_offset)
            m = torch.full((b, kvh, qc * rep), float("-inf"),
                           device=q.device)
            l = torch.zeros_like(m)
            acc = torch.zeros((b, kvh, qc * rep, hd), device=q.device)
            for j in range(sk // kc):
                cols = slice(j * kc, (j + 1) * kc)
                bias = _mask_bias(qp, kp_all[cols], sk0, causal, window)
                s = (qb @ kg[:, :, cols].transpose(-1, -2)).mul_(scale)
                s.view(b, kvh, qc, rep, kc).add_(bias[:, None, :])
                m_new = torch.maximum(m, s.amax(-1))
                m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
                p = s.sub_(m_safe[..., None]).exp_()
                alpha = torch.where(torch.isfinite(m), torch.exp(m - m_safe),
                                    0.0)
                l = l * alpha + p.sum(-1)
                acc = acc * alpha[..., None] + p @ vg[:, :, cols]
                m = m_new
            o = acc / torch.clamp(l, min=1e-30)[..., None]
            out[:, :, rows] = o.view(b, kvh, qc, rep, hd)
            m_all[:, :, rows] = torch.where(torch.isfinite(m), m, 0.0) \
                .view(b, kvh, qc, rep)
            l_all[:, :, rows] = l.view(b, kvh, qc, rep)
        o = _ungrouped(out)
        ctx.save_for_backward(q, k, v, o, m_all, l_all)
        ctx.args = (causal, window, q_offset, qc, kc, sk0)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, m_all, l_all = ctx.saved_tensors
        causal, window, q_offset, qc, kc, sk0 = ctx.args
        b, sq, h, hd = q.shape
        sk, kvh = k.shape[1], k.shape[2]
        rep, scale = h // kvh, 1.0 / math.sqrt(hd)
        delta = (do.float() * o.float()).sum(-1)                  # (B,Sq,H)
        delta = delta.reshape(b, sq, kvh, rep).transpose(1, 2)
        linv = 1.0 / torch.clamp(l_all, min=1e-30)
        qg, dog, kg, vg = _grouped(q, kvh), _grouped(do, kvh), _heads(k), \
            _heads(v)
        dq = torch.zeros((b, kvh, sq, rep, hd), device=q.device)
        dk = torch.empty((b, kvh, sk, hd), device=q.device)
        dv = torch.empty_like(dk)
        kp_all = torch.arange(sk, device=q.device)

        def rows_of(t, rows, width=None):
            shape = (b, kvh, qc * rep) + ((width,) if width else ())
            return t[:, :, rows].reshape(shape)

        for j in range(sk // kc):
            cols = slice(j * kc, (j + 1) * kc)
            kb, vb = kg[:, :, cols], vg[:, :, cols]
            dkc = torch.zeros((b, kvh, kc, hd), device=q.device)
            dvc = torch.zeros_like(dkc)
            for i in range(sq // qc):
                rows = slice(i * qc, (i + 1) * qc)
                qb, dob = rows_of(qg, rows, hd), rows_of(dog, rows, hd)
                qp = torch.arange(qc, device=q.device) + (i * qc + q_offset)
                bias = _mask_bias(qp, kp_all[cols], sk0, causal, window)
                s = (qb @ kb.transpose(-1, -2)).mul_(scale)
                s.view(b, kvh, qc, rep, kc).add_(bias[:, None, :])
                p = s.sub_(rows_of(m_all, rows)[..., None]).exp_() \
                    .mul_(rows_of(linv, rows)[..., None])
                dvc = dvc + p.transpose(-1, -2) @ dob
                dp = dob @ vb.transpose(-1, -2)
                dsv = dp.sub_(rows_of(delta, rows)[..., None]).mul_(p) \
                    .mul_(scale)
                dq[:, :, rows] += (dsv @ kb).view(b, kvh, qc, rep, hd)
                dkc = dkc + dsv.transpose(-1, -2) @ qb
            dk[:, :, cols], dv[:, :, cols] = dkc, dvc
        return (_ungrouped(dq).to(q.dtype), dk.transpose(1, 2).to(k.dtype),
                dv.transpose(1, 2).to(v.dtype)) + (None,) * 7


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool, window: Optional[int] = None,
                    q_offset: int = 0, chunk: int = 1024) -> torch.Tensor:
    """Chunked online-softmax attention, O(S) memory forward and backward
    (``layers.py:233-264``).  q: (B, Sq, H, hd); k, v: (B, Sk, KV, hd) with
    KV dividing H; ``q_offset`` is the absolute position of q's first row.
    q and k are padded to multiples of their chunks, the padding masked and
    sliced off.  Returns (B, Sq, H, hd) in q's dtype.  The call is a
    profiler range named ``flash_attention``."""
    sq0, sk0 = q.shape[1], k.shape[1]
    if q.shape[2] % k.shape[2]:
        raise ValueError(f"{q.shape[2]} query heads over {k.shape[2]} kv "
                         "heads")
    qc, kc = min(chunk, sq0), min(chunk, sk0)
    sq, sk = -(-sq0 // qc) * qc, -(-sk0 // kc) * kc
    if sq != sq0:
        q = F.pad(q, (0, 0, 0, 0, 0, sq - sq0))
    if sk != sk0:
        k = F.pad(k, (0, 0, 0, 0, 0, sk - sk0))
        v = F.pad(v, (0, 0, 0, 0, 0, sk - sk0))
    with torch.profiler.record_function("flash_attention"):
        out = _FlashCore.apply(q, k, v, causal, window, q_offset, qc, kc,
                               sq0, sk0)
    return out[:, :sq0]


def decode_attention(q: torch.Tensor, cache_k: torch.Tensor,
                     cache_v: torch.Tensor, pos, *,
                     window: Optional[int] = None) -> torch.Tensor:
    """One query position over a cache (``layers.py:267-289``): a float32
    softmax over the slots below ``pos`` (the number of valid entries; with
    ``window``, also at or above ``pos - window``).  q: (B, 1, H, hd);
    cache_k, cache_v: (B, S, KV, hd).  Returns (B, 1, H, hd) in q's
    dtype."""
    b, _, h, hd = q.shape
    s, kvh = cache_k.shape[1], cache_k.shape[2]
    qg = q.float().reshape(b, kvh, h // kvh, hd)
    scores = torch.einsum("bgrd,bsgd->bgrs", qg, cache_k.float()) \
        * (1.0 / math.sqrt(hd))
    k_pos = torch.arange(s, device=q.device)
    valid = k_pos < pos
    if window is not None:
        valid = valid & (k_pos >= pos - window)
    p = torch.softmax(scores.masked_fill(~valid, float("-inf")), dim=-1)
    out = torch.einsum("bgrs,bsgd->bgrd", p, cache_v.float())
    return out.reshape(b, 1, h, hd).to(q.dtype)


def mlp(x: torch.Tensor, wi: torch.Tensor, wo: torch.Tensor,
        wg: Optional[torch.Tensor], act: str) -> torch.Tensor:
    """The dense MLP (``layers.py:292-297``): ``silu(x wi) · (x wg)`` then
    ``wo``, or ``gelu(x wi) wo`` (``jax.nn.gelu``'s default, the tanh
    form)."""
    if act == "silu":
        hidden = F.silu(x @ wi) * (x @ wg)
    else:
        hidden = F.gelu(x @ wi, approximate="tanh")
    return hidden @ wo


def _associative_scan(a: torch.Tensor, b: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """The inclusive scan over axis 2 of (a, b) under (a₁, b₁) ∘ (a₂, b₂) =
    (a₁a₂, a₂b₁ + b₂), by doubling: log₂ of the axis's length steps, each
    combining every position with the one 2ʲ before it."""
    n, d = a.shape[2], 1
    while d < n:
        a_lo, b_lo = a[:, :, :n - d], b[:, :, :n - d]
        a_hi, b_hi = a[:, :, d:], b[:, :, d:]
        b = torch.cat([b[:, :, :d], a_hi * b_lo + b_hi], 2)
        a = torch.cat([a[:, :, :d], a_hi * a_lo], 2)
        d *= 2
    return a, b


def _recurrence(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor,
                chunk: int, cd: torch.dtype
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """``_chunked_recurrence_impl`` (``layers.py:318-360``): (every h_t in
    ``cd``, h_S float32).  ``chunk = 0`` steps through time one position at
    a time in float32.  Otherwise the sequence is padded with identity steps
    (a = 1, b = 0) to a multiple of the chunk; within a chunk an
    associative scan in ``cd``, between chunks the state carried in
    float32, each chunk's h = (scanned a) · carry + (scanned b)."""
    if chunk == 0:
        h, hs = h0.float(), []
        for t in range(a.shape[1]):
            h = a[:, t].float() * h + b[:, t].float()
            hs.append(h.to(cd))
        return torch.stack(hs, 1), h
    bsz, s0, rest = a.shape[0], a.shape[1], a.shape[2:]
    chunk = min(chunk, s0)
    s = -(-s0 // chunk) * chunk
    if s != s0:
        pad = (0, 0) * len(rest) + (0, s - s0)
        a, b = F.pad(a, pad, value=1.0), F.pad(b, pad)
    nc = s // chunk
    a_sc, b_sc = _associative_scan(a.reshape(bsz, nc, chunk, *rest).to(cd),
                                   b.reshape(bsz, nc, chunk, *rest).to(cd))
    carries = [h0.float()]
    for c in range(nc):
        carries.append((a_sc[:, c, -1] * carries[-1].to(cd)
                        + b_sc[:, c, -1]).float())
    prev = torch.stack(carries[:-1], 1).to(cd).unsqueeze(2)
    hs = a_sc * prev + b_sc
    return hs.reshape(bsz, s, *rest)[:, :s0], carries[-1]


class _LinearRecurrence(torch.autograd.Function):
    """``chunked_linear_recurrence`` with the reference's ``custom_vjp``
    (``_clr_fwd``/``_clr_bwd``, ``layers.py:384-410``): the forward saves
    only (a, hs, h0); the backward is the same recurrence run in reverse on
    a shifted by one (λ_t = g_t + a_{t+1} λ_{t+1}), then da = λ · h_{t-1},
    db = λ, dh0 = a_0 · λ_0.  Autograd never records the scan."""

    @staticmethod
    def forward(ctx, a, b, h0, chunk, cd):
        hs, h_last = _recurrence(a, b, h0, chunk, cd)
        ctx.save_for_backward(a, hs, h0)
        ctx.args = (chunk, cd)
        return hs, h_last

    @staticmethod
    def backward(ctx, dhs, dh_last):
        a, hs, h0 = ctx.saved_tensors
        chunk, cd = ctx.args
        g = dhs.to(cd)
        if dh_last is not None:
            g = g.clone()
            g[:, -1] += dh_last.to(cd)
        ar = torch.cat([a[:, 1:], torch.zeros_like(a[:, :1])], 1).to(cd)
        lam_rev, _ = _recurrence(ar.flip(1), g.flip(1),
                                 torch.zeros(h0.shape, device=h0.device),
                                 chunk, cd)
        lam = lam_rev.flip(1)
        h_prev = torch.cat([h0.to(hs.dtype)[:, None], hs[:, :-1]], 1)
        da = (lam * h_prev.float()).to(a.dtype)
        db = lam.to(a.dtype)
        dh0 = (a[:, 0].float() * lam[:, 0]).to(h0.dtype)
        return da, db, dh0, None, None


def chunked_linear_recurrence(a: torch.Tensor, b: torch.Tensor,
                              h0: torch.Tensor, chunk: int,
                              compute_dtype: torch.dtype = torch.float32
                              ) -> tuple[torch.Tensor, torch.Tensor]:
    """h_t = a_t ⊙ h_{t-1} + b_t over axis 1 of (B, S, …) from ``h0``
    (``layers.py:363-381``): (every h_t in ``compute_dtype``, h_S float32).
    Chunks of ``chunk`` steps scanned associatively in ``compute_dtype``,
    the state between them in float32; ``chunk = 0`` the sequential mode.
    Differentiable in a, b and h0 by the reverse scan
    (:class:`_LinearRecurrence`).  The call is a profiler range named
    ``linear_recurrence``."""
    with torch.profiler.record_function("linear_recurrence"):
        return _LinearRecurrence.apply(a, b, h0, chunk, compute_dtype)
