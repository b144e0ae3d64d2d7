"""The primitives of the Mamba-1 path, from the JAX package's
``models/layers.py``: forward only, no custom gradients.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

__all__ = ["rms_norm", "causal_conv1d"]


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm as ``layers.py:26-50``: the variance accumulated in float32,
    its inverse cast to ``x.dtype``, the scale applied as ``1 + scale``."""
    var = x.float().square().mean(-1, keepdim=True)
    inv = torch.rsqrt(var + eps).to(x.dtype)
    return x * inv * (1 + scale.to(x.dtype))


def causal_conv1d(x: torch.Tensor, w: torch.Tensor,
                  state: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal convolution.  x: (B, S, C); w: (C, K); state: the
    last K-1 inputs (B, K-1, C), zeros when ``None``.  Returns (y, the new
    state).

    Written as K shifted multiply-adds in float32, rounded once to
    ``x.dtype``: ``y_t = Σ_k xp_{t+k} w_k`` over ``xp = [state, x]``, the
    cross-correlation ``lax.conv_general_dilated`` computes
    (``layers.py:300-315``).  No cuDNN call, so no TF32 on the card.
    """
    k = w.shape[-1]
    bsz, s, c = x.shape
    if state is None:
        state = x.new_zeros(bsz, k - 1, c)
    xp = torch.cat([state.to(x.dtype), x], dim=1)
    xf, wf = xp.float(), w.float()
    y = xf[:, :s] * wf[:, 0]
    for j in range(1, k):
        y += xf[:, j:j + s] * wf[:, j]
    # a copy: a view would keep the whole (B, S+K-1, C) input alive
    return y.to(x.dtype), xp[:, s:].clone()
