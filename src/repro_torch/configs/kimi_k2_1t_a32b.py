"""Kimi-K2 1T-A32B — trillion-param MoE: 384 experts top-8 + 1 shared
[arXiv:2501.kimi2 paper-table; unverified].

The JAX package's ``configs/kimi_k2_1t_a32b.py``, the same widths: plain
GQA attention and every layer MoE, as the reference configures it.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=64,
    n_kv_heads=8,
    d_ff=2048,
    vocab_size=163840,
    n_experts=384,
    top_k=8,
    moe_d_ff=2048,
    n_shared_experts=1,
    act="silu",
)
