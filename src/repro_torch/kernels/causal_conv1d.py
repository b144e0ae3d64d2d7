"""The Mamba-1 mixer's depthwise causal convolution, bias and silu as one
CUDA kernel, and its backward.

Computes the JAX package's ``layers.causal_conv1d``
(``src/repro/models/layers.py:300-315``) followed by ``+ conv_b`` and
``silu`` (``src/repro/models/blocks.py:387-388``) in one pass over the
``wx`` GEMM's output, rounded as the plain version
(:func:`repro_torch.kernels.ref.causal_conv1d_silu`) rounds, so the two
agree bit for bit.  The JAX package has no Pallas kernel for it (XLA fuses
the convolution); the port's plain version took ~42 passes over the
activation tensor.

Both kernels are bound by their bytes (x read once, xc written once; the
backward reads x and dout and writes dx), with the instruction floor of
their exact rounding close behind, so loads have to overlap arithmetic.
The first design walked each 16 bytes of channels with one thread, a load
in flight at a time at 106 (backward 188) registers: 1.18 (0.65) TB/s.
Now a block is a unit (batch row, 512 bytes of channels, :data:`SEGMENT`
steps) whose rows the bulk-copy engine streams into a ring of
shared-memory slots (the ``staged`` variant), and each thread walks its 2
bf16 or 1 float32 channel out of the ring with its window in registers;
``csrc/causal_conv1d.cu`` says what was measured and what lost.  Shapes the
bulk copies cannot take run the ``generic`` variant, the same walk fed by
the threads' own loads; :func:`variant` chooses from shape, dtype and
alignment before the launch.

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

__all__ = ["WIDTH", "SEGMENT", "VARIANTS", "LAST_VARIANT", "variant",
           "bwd_parts", "causal_conv1d_silu", "causal_conv1d_silu_bwd"]

#: the width K the kernel is compiled for (d_conv of every configuration)
WIDTH = 4

#: time steps a block of either kernel walks (``kSegment``)
SEGMENT = 256
#: the kernels' variants, by their number in the C entry points
VARIANTS = ("generic", "staged")
#: per wrapper (``causal_conv1d``, ``causal_conv1d_bwd``), the variant of
#: its last launch (for reports only)
LAST_VARIANT: dict = {}

# rt_causal_conv1d_silu_*: x, w, b, state in; out, new_state out; batch, S,
# C, K, variant; stream
_ARGS = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
# rt_causal_conv1d_silu_bwd_*: x, w, b, state, dout in; dx, dstate, the
# partials of dw and db out; batch, S, C, K, variant; stream
_BWD_ARGS = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
# rt_causal_conv1d_bwd_reduce: partials in, dw, db out; parts, C, K; stream
_REDUCE_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]


def variant(s: int, c: int, dtype, ptrs) -> str:
    """The kernels' variant for S = ``s`` steps of ``c`` channels of
    ``dtype`` at base addresses ``ptrs`` (every tensor the kernel reads or
    writes, ``None`` for one absent): ``"staged"`` when the bulk-copy
    engine can move the rows (S ≥ 1; C · itemsize a multiple of 16 bytes,
    so every row slice of a 512-byte channel tile is whole 16-byte units;
    every base 16-byte aligned), else ``"generic"``."""
    if s >= 1 and c * dtype.itemsize % 16 == 0 and all(
            p is None or p % 16 == 0 for p in ptrs):
        return "staged"
    return "generic"


def bwd_parts(bsz: int, s: int) -> int:
    """Partials of dw and db the backward writes: one a unit's (batch row,
    segment), ``bsz`` rows of ``ceil(S / SEGMENT)`` (one at S = 0)."""
    return bsz * max(-(-s // SEGMENT), 1)


def _ptr(t):
    return None if t is None else t.data_ptr()


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
        v = variant(s, c, x.dtype, [_ptr(t) for t in (x, state, out,
                                                       new_state)])
        fn = _build.c_function("causal_conv1d",
                               _build.entry("causal_conv1d_silu", x.dtype),
                               _ARGS)
        rc = fn(_build.ptr(x), _build.ptr(w), _build.ptr(b), _ptr(state),
                _build.ptr(out), _build.ptr(new_state), bsz, s, c, k,
                VARIANTS.index(v), _build.stream_ptr(x.device))
        _build.check(rc, "causal_conv1d_silu")
        _build.count_launch("causal_conv1d")
        LAST_VARIANT["causal_conv1d"] = v
    return out, new_state


def causal_conv1d_silu_bwd(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                           dout: torch.Tensor,
                           state: Optional[torch.Tensor] = None) -> tuple:
    """The backward of :func:`causal_conv1d_silu` given ``dout`` (the
    gradient of xc, in x's dtype): (dx in x's dtype, dw (C, K) float32, db
    (C,) float32, dstate in x's dtype or ``None`` without a state); its
    plain version is :func:`repro_torch.kernels.ref.causal_conv1d_silu_bwd`.
    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    (a block a unit of (batch row, channel tile, :data:`SEGMENT` steps),
    then a second launch that sums the units' dw and db partials in a fixed
    order)."""
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
    if not (bsz and c):
        return (dx, torch.zeros(c, k, dtype=torch.float32, device=dev),
                torch.zeros(c, dtype=torch.float32, device=dev), dstate)
    parts = bwd_parts(bsz, s)
    part = torch.empty(parts, c, k + 1, dtype=torch.float32, device=dev)
    # the sum writes every element
    dw = torch.empty(c, k, dtype=torch.float32, device=dev)
    db = torch.empty(c, dtype=torch.float32, device=dev)
    stream = _build.stream_ptr(dev)
    v = variant(s, c, x.dtype, [_ptr(t) for t in (x, dout, state, dx,
                                                   dstate)])
    fn = _build.c_function("causal_conv1d",
                           _build.entry("causal_conv1d_silu_bwd", x.dtype),
                           _BWD_ARGS)
    rc = fn(_build.ptr(x), _build.ptr(w), _build.ptr(b), _ptr(state),
            _build.ptr(dout), _build.ptr(dx), _ptr(dstate), _build.ptr(part),
            bsz, s, c, k, VARIANTS.index(v), stream)
    _build.check(rc, what)
    _build.count_launch("causal_conv1d_bwd")
    LAST_VARIANT["causal_conv1d_bwd"] = v
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
