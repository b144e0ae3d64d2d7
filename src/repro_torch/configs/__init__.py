"""The model configurations the port runs.

``get(name)`` returns the full :class:`~repro_torch.models.config.ModelConfig`
(as the JAX package's ``configs.get``); ``get(name).reduced()`` the CPU test
variant.  All ten configurations of the JAX registry, of its six families
(``dense``, ``moe``, ``ssm``, ``hybrid``, ``audio``, ``vlm``); and the
dry run's shape grid (:data:`SHAPES`, :func:`cells`).
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


# the shape grid of the LM dry run (seq_len, global_batch, kind), the
# reference's ``configs.SHAPES``
SHAPES = {
    "train_4k": dict(seq_len=4096, global_batch=256, kind="train"),
    "prefill_32k": dict(seq_len=32768, global_batch=32, kind="prefill"),
    "decode_32k": dict(seq_len=32768, global_batch=128, kind="decode"),
    "long_500k": dict(seq_len=524288, global_batch=1, kind="decode"),
}


def cells():
    """Every (name, shape, meta, skip) cell of the configurations × shapes,
    in the reference's order (its registry's, then the shapes'); ``skip``
    says why ``long_500k`` does not run for a pure full-attention
    configuration, else ``None``."""
    out = []
    for name in _DRYRUN_ORDER:
        cfg = REGISTRY[name]
        for shape, meta in SHAPES.items():
            skip = None
            if shape == "long_500k" and not cfg.subquadratic:
                skip = ("pure full-attention arch: 500k decode cache is "
                        "O(seq) with quadratic prefill")
            out.append((name, shape, meta, skip))
    return out


# the reference registry's order (``configs/__init__.py:16-19``)
_DRYRUN_ORDER = ("qwen2-1.5b", "smollm-360m", "minicpm-2b", "h2o-danube-3-4b",
                 "falcon-mamba-7b", "whisper-base", "llama-3.2-vision-11b",
                 "recurrentgemma-2b", "mixtral-8x7b", "kimi-k2-1t-a32b")
