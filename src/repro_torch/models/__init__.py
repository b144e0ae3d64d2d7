"""The LM side of the port: the Mamba-1 (``ssm``) family so far.

``Model`` (``model.py``) runs ``forward``, ``loss`` (forward only),
``init_cache``, ``prefill`` and ``decode``; its mixer's recurrence goes
through the ``ssm_scan`` kernel (:mod:`repro_torch.kernels.ssm_scan`).
"""
from .config import ModelConfig
from .model import Model

__all__ = ["Model", "ModelConfig"]
