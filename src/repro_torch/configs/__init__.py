"""The model configurations the port runs.

``get(name)`` returns the full :class:`~repro_torch.models.config.ModelConfig`
(as the JAX package's ``configs.get``); ``get(name).reduced()`` the CPU test
variant.  All ten configurations of the JAX registry, of its six families
(``dense``, ``moe``, ``ssm``, ``hybrid``, ``audio``, ``vlm``).
"""
from __future__ import annotations

from typing import Dict, List

from repro_torch.models.config import ModelConfig

from . import (falcon_mamba_7b, h2o_danube_3_4b, kimi_k2_1t_a32b,
               llama_3_2_vision_11b, minicpm_2b, mixtral_8x7b, qwen2_1_5b,
               recurrentgemma_2b, smollm_360m, whisper_base)

REGISTRY: Dict[str, ModelConfig] = {
    m.CONFIG.name: m.CONFIG for m in (smollm_360m, qwen2_1_5b, minicpm_2b,
                                      h2o_danube_3_4b, falcon_mamba_7b,
                                      recurrentgemma_2b, mixtral_8x7b,
                                      kimi_k2_1t_a32b, whisper_base,
                                      llama_3_2_vision_11b)}


def get(name: str) -> ModelConfig:
    return REGISTRY[name]


def names() -> List[str]:
    return list(REGISTRY)
