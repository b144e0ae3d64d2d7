"""The Mamba-1 mixer's depthwise causal convolution, bias and silu as one
CUDA kernel.

Computes the JAX package's ``layers.causal_conv1d``
(``src/repro/models/layers.py:300-315``) followed by ``+ conv_b`` and
``silu`` (``src/repro/models/blocks.py:387-388``) in one pass over the
``wx`` GEMM's output, rounded as the plain version
(:func:`repro_torch.kernels.ref.causal_conv1d_silu`) rounds, so the two
agree bit for bit.  Bound by its bytes; see ``csrc/causal_conv1d.cu``.
The JAX package has no Pallas kernel for it (XLA fuses the convolution);
the port's plain version took ~42 passes over the activation tensor.

:func:`causal_conv1d_silu` is differentiable: a CUDA tensor that needs a
gradient goes through the backward kernel (:func:`causal_conv1d_silu_bwd`,
in the same source, counted under ``causal_conv1d_bwd``), a CPU tensor
through :func:`repro_torch.kernels.ref.causal_conv1d_silu_bwd`.  The new
state is not differentiable (training discards it).
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import _build, ref

__all__ = ["WIDTH", "causal_conv1d_silu", "causal_conv1d_silu_bwd"]

#: the width K the kernel is compiled for (d_conv of every configuration)
WIDTH = 4

_ARGS = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
# rt_causal_conv1d_silu_bwd_*: x, w, b, state, dout in; dx, dstate, the
# partials of dw and db out; batch, S, C, K; stream
_BWD_ARGS = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
# rt_causal_conv1d_bwd_reduce: partials in, dw, db out; parts, C, K; stream
_REDUCE_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
#: time steps a thread of the backward kernel walks (``kBwdStrip``)
BWD_STRIP = 64


def _check(x, w, b, state, what="causal_conv1d_silu") -> None:
    if x.ndim != 3:
        raise ValueError(f"{what}: x must be (B, S, C), got "
                         f"{tuple(x.shape)}")
    bsz, s, c = x.shape
    k = w.shape[-1] if w.ndim == 2 else -1
    if tuple(w.shape) != (c, WIDTH):
        raise ValueError(f"{what}: w must be (C={c}, K={WIDTH}), got "
                         f"{tuple(w.shape)}")
    if tuple(b.shape) != (c,):
        raise ValueError(f"{what}: b has shape {tuple(b.shape)}, expected "
                         f"({c},)")
    if state is not None and tuple(state.shape) != (bsz, k - 1, c):
        raise ValueError(f"{what}: state has shape {tuple(state.shape)}, "
                         f"expected {(bsz, k - 1, c)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{what}: x must be float32 or bfloat16, got "
                        f"{x.dtype}")


def _card_inputs(x, w, b, state, what):
    """w, b and the state in x's dtype, contiguous, every tensor checked
    for the kernels."""
    w, b = (t.to(x.dtype).contiguous() for t in (w, b))
    if state is not None:
        state = state.to(x.dtype).contiguous()
    for t, name in ((x, "x"), (w, "w"), (b, "b"), (state, "state")):
        if t is None:
            continue
        _build.check_tensor(t, f"{what} {name}", x.dtype)
        if t.device != x.device:
            raise ValueError(f"{what}: {name} is on {t.device}, x on "
                             f"{x.device}")
    return w, b, state


def _forward(x, w, b, state):
    """The fused forward: the plain version on a CPU tensor, the kernel on
    a CUDA one.  Builds no graph."""
    if x.device.type == "cpu":
        with torch.no_grad():
            return ref.causal_conv1d_silu(x, w, b, state)
    bsz, s, c = x.shape
    k = WIDTH
    w, b, state = _card_inputs(x, w, b, state, "causal_conv1d_silu")
    out = torch.empty_like(x)
    new_state = torch.empty(bsz, k - 1, c, dtype=x.dtype, device=x.device)
    if bsz and c:
        fn = _build.c_function("causal_conv1d",
                               _build.entry("causal_conv1d_silu", x.dtype),
                               _ARGS)
        rc = fn(_build.ptr(x), _build.ptr(w), _build.ptr(b),
                None if state is None else _build.ptr(state),
                _build.ptr(out), _build.ptr(new_state), bsz, s, c, k,
                _build.stream_ptr(x.device))
        _build.check(rc, "causal_conv1d_silu")
        _build.count_launch("causal_conv1d")
    return out, new_state


def causal_conv1d_silu_bwd(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                           dout: torch.Tensor,
                           state: Optional[torch.Tensor] = None) -> tuple:
    """The backward of :func:`causal_conv1d_silu` given ``dout`` (the
    gradient of xc, in x's dtype): (dx in x's dtype, dw (C, K) float32, db
    (C,) float32, dstate in x's dtype or ``None`` without a state); its
    plain version is :func:`repro_torch.kernels.ref.causal_conv1d_silu_bwd`.
    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    (one thread a 16-byte channel group and strip of :data:`BWD_STRIP`
    steps, then a second launch that sums the strips' dw and db partials in
    a fixed order)."""
    what = "causal_conv1d_silu_bwd"
    _check(x, w, b, state, what)
    if tuple(dout.shape) != tuple(x.shape) or dout.dtype != x.dtype:
        raise ValueError(f"{what}: dout must be {tuple(x.shape)} in "
                         f"{x.dtype}, got {tuple(dout.shape)} {dout.dtype}")
    if x.device.type == "cpu":
        return ref.causal_conv1d_silu_bwd(x, w, b, dout, state)
    bsz, s, c = x.shape
    k = WIDTH
    w, b, state = _card_inputs(x, w, b, state, what)
    dout = dout.contiguous()
    dev = x.device
    dx = torch.empty_like(x)
    dstate = torch.empty_like(state) if state is not None else None
    parts = bsz * max(-(-s // BWD_STRIP), 1)
    part = torch.empty(parts, c, k + 1, dtype=torch.float32, device=dev)
    dw = torch.zeros(c, k, dtype=torch.float32, device=dev)
    db = torch.zeros(c, dtype=torch.float32, device=dev)
    if bsz and c:
        stream = _build.stream_ptr(dev)
        fn = _build.c_function("causal_conv1d",
                               _build.entry("causal_conv1d_silu_bwd",
                                            x.dtype), _BWD_ARGS)
        rc = fn(_build.ptr(x), _build.ptr(w), _build.ptr(b),
                None if state is None else _build.ptr(state),
                _build.ptr(dout), _build.ptr(dx),
                None if dstate is None else _build.ptr(dstate),
                _build.ptr(part), bsz, s, c, k, stream)
        _build.check(rc, what)
        _build.count_launch("causal_conv1d_bwd")
        fn = _build.c_function("causal_conv1d", "rt_causal_conv1d_bwd_reduce",
                               _REDUCE_ARGS)
        rc = fn(_build.ptr(part), _build.ptr(dw), _build.ptr(db), parts, c,
                k, stream)
        _build.check(rc, f"{what} (reduce)")
        _build.count_launch("causal_conv1d_bwd")
    return dx, dw, db, dstate


class _CausalConv1dSilu(torch.autograd.Function):
    """:func:`causal_conv1d_silu` with its backward: the kernel's on the
    card, the plain version's on the CPU."""

    @staticmethod
    def forward(ctx, x, w, b, state):
        out, new_state = _forward(x, w, b, state)
        ctx.save_for_backward(x, w, b, state)
        ctx.mark_non_differentiable(new_state)
        ctx.set_materialize_grads(False)
        return out, new_state

    @staticmethod
    def backward(ctx, dout, _):
        ins = ctx.saved_tensors
        if dout is None:
            return (None,) * 4
        grads = causal_conv1d_silu_bwd(ins[0], ins[1], ins[2],
                                       dout.to(ins[0].dtype), ins[3])
        return tuple(None if g is None or not need else g.to(t.dtype)
                     for g, t, need in zip(grads, ins, ctx.needs_input_grad))


def causal_conv1d_silu(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                       state: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``silu(round(conv(x, w)) + b)`` and the new conv state.

    x: (B, S, C), float32 or bfloat16; w: (C, K) with K = :data:`WIDTH`;
    b: (C,); state: the last K-1 inputs (B, K-1, C),
    zeros when ``None``.  ``w``, ``b`` and ``state`` are cast to x's dtype.
    Returns (xc (B, S, C), new state (B, K-1, C)), both in x's dtype.
    A CPU tensor takes the plain version; a CUDA tensor launches the kernel.
    When grad is enabled and an input needs one, the call records its
    backward (:func:`causal_conv1d_silu_bwd`).
    """
    _check(x, w, b, state)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in (x, w, b, state)):
        return _CausalConv1dSilu.apply(x, w, b, state)
    return _forward(x, w, b, state)
