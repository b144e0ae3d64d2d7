"""Qwen2-1.5B — dense GQA decoder with QKV bias [arXiv:2407.10671; hf].

The JAX package's ``configs/qwen2_1_5b.py``, the same widths.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-1.5b",
    family="dense",
    n_layers=28,
    d_model=1536,
    n_heads=12,
    n_kv_heads=2,
    d_ff=8960,
    vocab_size=151936,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    act="silu",
)
