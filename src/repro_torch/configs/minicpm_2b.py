"""MiniCPM-2B — llama-like dense (WSD schedule) [arXiv:2404.06395; hf].

The JAX package's ``configs/minicpm_2b.py``, the same widths.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="minicpm-2b",
    family="dense",
    n_layers=40,
    d_model=2304,
    n_heads=36,
    n_kv_heads=36,
    d_ff=5760,
    vocab_size=122753,
    act="silu",
)
