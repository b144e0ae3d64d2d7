"""The LM side of the port: the ``dense``, ``moe``, ``ssm`` (Mamba-1) and
``hybrid`` (RG-LRU and local attention) families.

``Model`` (``model.py``) runs ``forward`` and ``loss`` (differentiable,
with per-group remat), ``init_cache``, ``prefill`` and ``decode``; the
Mamba mixer's recurrence goes through the fused ``mamba_scan`` kernel and
its backward kernel (:mod:`repro_torch.kernels.ssm_scan`).
"""
from .config import ModelConfig
from .model import Model

__all__ = ["Model", "ModelConfig"]
