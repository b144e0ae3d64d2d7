"""PyTorch/CUDA port of the piCholesky CV system.

A second package beside the JAX reference ``repro``: the same module layout,
plain PyTorch around hand-written CUDA kernels for Hopper
(:mod:`repro_torch.kernels`).  It imports ``torch`` and never ``jax`` or
``repro``.  Entry points run on the CUDA device unless the caller passes
``device="cpu"``.
"""
from ._device import resolve_device

__all__ = ["resolve_device"]
