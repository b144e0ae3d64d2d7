"""The Mamba-1 mixer and the norm, from the JAX package's ``models/blocks.py``
(``:340-425``, ``:500-505``).

``mamba_*`` and ``norm_*`` take ``p``, a module (or any object) with the
parameters as attributes under the JAX package's leaf names and layouts
(``wx`` (d, di), ``x_proj`` (di, r+2N), ``a_log`` (di, N), …).  Between
its GEMMs the mixer runs two kernels, chosen by ``scan=``
(:func:`repro_torch.kernels.ssm_scan.resolve_mixer`): the causal
convolution with its bias and silu, and ``mamba_scan`` (softplus, the
selective scan and the gate); the JAX package computes the recurrence
through ``layers.chunked_linear_recurrence``.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssm_scan import resolve_mixer

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


# On the card each of these products runs on at least this many rows (zero
# rows appended, their outputs dropped).  On fewer rows, as in a decode
# step, cuBLAS (H100, CUDA 12.8) picks kernels that sum in another order
# than for a prefill's thousands: the rows differ from the forward's in
# their last bits (dt_proj in 66 % of its outputs at 4 rows, x_proj and
# out_proj in under 1 %), and over 64 bf16 layers decode logits drift to
# ~5e-2 of forward's.  From these counts on, each runs the prefill's
# kernel, so a decode step computes what the forward computes for its
# position.  Measured by scripts/probe_serve_consistency.py.
_MIN_ROWS = {"x_proj": 1024, "dt_proj": 64, "out_proj": 256}


def _product(a: torch.Tensor, w: torch.Tensor, name: str) -> torch.Tensor:
    """``a @ w`` for ``a`` (B, S, K); on the card over at least
    ``_MIN_ROWS[name]`` rows: batch rows of zeros appended, dropped after."""
    bsz, s = a.shape[0], a.shape[1]
    if a.device.type != "cuda" or s == 0 or bsz * s >= _MIN_ROWS[name]:
        return a @ w
    pad = -(-_MIN_ROWS[name] // s) - bsz
    return (F.pad(a, (0, 0, 0, 0, 0, pad)) @ w)[:bsz]


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
