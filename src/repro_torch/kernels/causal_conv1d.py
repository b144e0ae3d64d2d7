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
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import _build, ref

__all__ = ["WIDTH", "causal_conv1d_silu"]

#: the width K the kernel is compiled for (d_conv of every configuration)
WIDTH = 4

_ARGS = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def causal_conv1d_silu(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                       state: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``silu(round(conv(x, w)) + b)`` and the new conv state.

    x: (B, S, C), float32 or bfloat16; w: (C, K) with K = :data:`WIDTH`;
    b: (C,); state: the last K-1 inputs (B, K-1, C),
    zeros when ``None``.  ``w``, ``b`` and ``state`` are cast to x's dtype.
    Returns (xc (B, S, C), new state (B, K-1, C)), both in x's dtype.
    A CPU tensor takes the plain version; a CUDA tensor launches the kernel.
    """
    if x.ndim != 3:
        raise ValueError(f"causal_conv1d_silu: x must be (B, S, C), got "
                         f"{tuple(x.shape)}")
    bsz, s, c = x.shape
    k = w.shape[-1] if w.ndim == 2 else -1
    if tuple(w.shape) != (c, WIDTH):
        raise ValueError(f"causal_conv1d_silu: w must be (C={c}, "
                         f"K={WIDTH}), got {tuple(w.shape)}")
    if tuple(b.shape) != (c,):
        raise ValueError(f"causal_conv1d_silu: b has shape {tuple(b.shape)}, "
                         f"expected ({c},)")
    if state is not None and tuple(state.shape) != (bsz, k - 1, c):
        raise ValueError(f"causal_conv1d_silu: state has shape "
                         f"{tuple(state.shape)}, expected {(bsz, k - 1, c)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"causal_conv1d_silu: x must be float32 or bfloat16, "
                        f"got {x.dtype}")
    if x.device.type == "cpu":
        return ref.causal_conv1d_silu(x, w, b, state)
    w, b = (t.to(x.dtype).contiguous() for t in (w, b))
    if state is not None:
        state = state.to(x.dtype).contiguous()
    for t, what in ((x, "x"), (w, "w"), (b, "b"), (state, "state")):
        if t is None:
            continue
        _build.check_tensor(t, f"causal_conv1d_silu {what}", x.dtype)
        if t.device != x.device:
            raise ValueError(f"causal_conv1d_silu: {what} is on {t.device}, "
                             f"x on {x.device}")
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
