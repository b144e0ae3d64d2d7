"""The primitives of the Mamba-1 path, from the JAX package's
``models/layers.py``.

``rms_norm`` carries the reference's custom gradient (``layers.py:25-68``)
as a ``torch.autograd.Function``.  ``causal_conv1d`` is the plain version
the ``causal_conv1d`` kernel is held to (:mod:`repro_torch.kernels.ref`),
re-exported here.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.ref import causal_conv1d

__all__ = ["rms_norm", "causal_conv1d"]


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
