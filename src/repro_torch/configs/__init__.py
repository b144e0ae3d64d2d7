"""The model configurations the port runs.

``get(name)`` returns the full :class:`~repro_torch.models.config.ModelConfig`
(as the JAX package's ``configs.get``); ``get(name).reduced()`` the CPU test
variant.  The ``dense`` and ``ssm`` families run so far; the other
configurations of the JAX registry come with their families (``ROADMAP.md``
queue 1 items 2-5: MoE, hybrid, audio, VLM).
"""
from __future__ import annotations

from typing import Dict, List

from repro_torch.models.config import ModelConfig

from . import (falcon_mamba_7b, h2o_danube_3_4b, minicpm_2b, qwen2_1_5b,
               smollm_360m)

REGISTRY: Dict[str, ModelConfig] = {
    m.CONFIG.name: m.CONFIG for m in (smollm_360m, qwen2_1_5b, minicpm_2b,
                                      h2o_danube_3_4b, falcon_mamba_7b)}


def get(name: str) -> ModelConfig:
    return REGISTRY[name]


def names() -> List[str]:
    return list(REGISTRY)
