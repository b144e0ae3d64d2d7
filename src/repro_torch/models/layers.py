"""The primitives of the Mamba-1 path, from the JAX package's
``models/layers.py``: forward only, no custom gradients.

``causal_conv1d`` is the plain version the ``causal_conv1d`` kernel is held
to (:mod:`repro_torch.kernels.ref`), re-exported here.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.ref import causal_conv1d

__all__ = ["rms_norm", "causal_conv1d"]


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm as ``layers.py:26-50``: the variance accumulated in float32,
    its inverse cast to ``x.dtype``, the scale applied as ``1 + scale``."""
    var = x.float().square().mean(-1, keepdim=True)
    inv = torch.rsqrt(var + eps).to(x.dtype)
    return x * inv * (1 + scale.to(x.dtype))
