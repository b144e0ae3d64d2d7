"""The model configurations the port runs.

``get(name)`` returns the full :class:`~repro_torch.models.config.ModelConfig`
(as the JAX package's ``configs.get``); ``get(name).reduced()`` the CPU test
variant.  Only the ``ssm`` family runs so far; the other configurations of
the JAX registry come with their families (``ROADMAP.md`` queue 1 item 4).
"""
from __future__ import annotations

from typing import Dict, List

from repro_torch.models.config import ModelConfig

from . import falcon_mamba_7b

REGISTRY: Dict[str, ModelConfig] = {
    m.CONFIG.name: m.CONFIG for m in (falcon_mamba_7b,)}


def get(name: str) -> ModelConfig:
    return REGISTRY[name]


def names() -> List[str]:
    return list(REGISTRY)
