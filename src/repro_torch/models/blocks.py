"""The Mamba-1 mixer and the norm, from the JAX package's ``models/blocks.py``
(``:340-425``, ``:500-505``).

``mamba_*`` and ``norm_*`` take ``p``, a module (or any object) with the
parameters as attributes under the JAX package's leaf names and layouts
(``wx`` (d, di), ``x_proj`` (di, r+2N), ``a_log`` (di, N), …).  The
mixer's recurrence goes through the ``ssm_scan`` kernel
(:mod:`repro_torch.kernels.ssm_scan`), chosen by ``scan=``; the JAX package
computes the same function through ``layers.chunked_linear_recurrence``.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssm_scan import resolve_scan

from . import layers
from .config import ModelConfig
from .params import Spec

__all__ = ["mamba_spec", "mamba_apply", "mamba_prefill", "mamba_init_cache",
           "mamba_decode", "norm_spec", "norm_apply"]


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


def _in_proj(p, x: torch.Tensor, state=None):
    """The two input projections and the convolution: (xc, z, conv state)."""
    xz = x @ p.wx.to(x.dtype)
    z = x @ p.wz.to(x.dtype)
    xc, conv_state = layers.causal_conv1d(xz, p.conv_w.to(x.dtype), state)
    return F.silu(xc + p.conv_b.to(x.dtype)), z, conv_state


def _ssm_inputs(p, xc: torch.Tensor, cfg: ModelConfig):
    """dt (float32), B, C and A of the selective scan."""
    n, r = cfg.ssm_state, cfg.dt_rank_
    proj = xc @ p.x_proj.to(xc.dtype)                             # (B,S,r+2N)
    dt_r, b_mat, c_mat = torch.split(proj, [r, n, n], dim=-1)
    dt = F.softplus(dt_r.float() @ p.dt_proj.float()
                    + p.dt_bias.float())                           # (B,S,di)
    a = -torch.exp(p.a_log.float())                                # (di,N)
    return dt, b_mat, c_mat, a


def _mamba_core(p, xc: torch.Tensor, cfg: ModelConfig, scan: str = "auto"
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """xc: post-conv activations (B, S, di).  Returns (y in xc's dtype,
    h_last (B, di, N) float32).  The scan runs in float32 from zero state
    (the JAX package's bf16 path runs its recurrence in bf16,
    ``blocks.py:369-375``; float32 agrees with it)."""
    dt, b_mat, c_mat, a = _ssm_inputs(p, xc, cfg)
    y, h_last = resolve_scan(scan, xc.device)(xc, dt, b_mat, c_mat, a,
                                              p.d_skip)
    return y.to(xc.dtype), h_last


def mamba_apply(p, x: torch.Tensor, cfg: ModelConfig,
                scan: str = "auto") -> torch.Tensor:
    return mamba_prefill(p, x, cfg, scan)[0]


def mamba_prefill(p, x: torch.Tensor, cfg: ModelConfig, scan: str = "auto"
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The mixer over a whole sequence, and the cache a decode continues
    from: the conv tail (B, K-1, di) and the scan's final state
    (``model.py:525-550``)."""
    xc, z, conv_state = _in_proj(p, x)
    y, h_last = _mamba_core(p, xc, cfg, scan)
    y = y * F.silu(z)
    return y @ p.out_proj.to(x.dtype), {"conv": conv_state, "h": h_last}


def mamba_init_cache(cfg: ModelConfig, batch: int, dtype: torch.dtype,
                     device) -> Dict[str, torch.Tensor]:
    return {
        "conv": torch.zeros(batch, cfg.d_conv - 1, cfg.d_inner, dtype=dtype,
                            device=device),
        "h": torch.zeros(batch, cfg.d_inner, cfg.ssm_state,
                         dtype=torch.float32, device=device),
    }


def mamba_decode(p, x: torch.Tensor, cache: Dict[str, torch.Tensor],
                 cfg: ModelConfig
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Single-token recurrent step, elementwise in float32.  x: (B, 1, D).
    Returns the output and a new cache; ``cache`` is not modified."""
    xc, z, conv_state = _in_proj(p, x, cache["conv"])
    dt, b_mat, c_mat, a = _ssm_inputs(p, xc, cfg)
    a_bar = torch.exp(dt[:, 0, :, None] * a)                       # (B,di,N)
    bx = (dt[:, 0, :, None] * b_mat[:, 0, None, :].float()
          * xc[:, 0, :, None].float())
    h = a_bar * cache["h"] + bx
    y = (h * c_mat[:, 0, None, :].float()).sum(-1)
    y = y + p.d_skip.float() * xc[:, 0].float()
    y = (y.to(x.dtype) * F.silu(z[:, 0]))[:, None, :]
    return y @ p.out_proj.to(x.dtype), {"conv": conv_state, "h": h}


def norm_spec(cfg: ModelConfig) -> Dict[str, Spec]:
    return {"scale": Spec((cfg.d_model,), init="zeros")}


def norm_apply(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    return layers.rms_norm(x, p.scale, cfg.norm_eps)
