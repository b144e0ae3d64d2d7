"""The LM side of the port: the Mamba-1 (``ssm``) family so far.

``Model`` (``model.py``) runs ``forward`` and ``loss`` (differentiable,
with per-layer remat), ``init_cache``, ``prefill`` and ``decode``; its
mixer's recurrence goes through the fused ``mamba_scan`` kernel and its
backward kernel (:mod:`repro_torch.kernels.ssm_scan`).
"""
from .config import ModelConfig
from .model import Model

__all__ = ["Model", "ModelConfig"]
