"""Mixtral-8x7B — 8-expert top-2 MoE with SWA [arXiv:2401.04088; hf].

The JAX package's ``configs/mixtral_8x7b.py``, the same widths.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=32000,
    sliding_window=4096,
    n_experts=8,
    top_k=2,
    moe_d_ff=14336,
    act="silu",
)
