"""Device resolution shared by every entry point of the port."""
from __future__ import annotations

import torch

__all__ = ["resolve_device", "canonical"]


def resolve_device(device=None) -> torch.device:
    """``None`` means the CUDA device.  A CUDA request without a CUDA device
    raises instead of quietly running on the CPU; the CPU runs only when
    the caller asks for it.

    On CUDA, float32 matrix products and convolutions are pinned to full
    float32 (TF32 off), so a float32 run on the card rounds like float32
    everywhere and not like TF32 in some places.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "port on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev


def canonical(device) -> torch.device:
    """``device`` with its index: a CUDA device named without one is the
    current one (``cuda`` and ``cuda:0`` are then the same device)."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None and torch.cuda.is_available():
        return torch.device("cuda", torch.cuda.current_device())
    return dev
