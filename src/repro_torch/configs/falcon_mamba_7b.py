"""Falcon-Mamba-7B — attention-free Mamba-1 [arXiv:2410.05355; unverified].

The JAX package's ``configs/falcon_mamba_7b.py``, the same widths.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b",
    family="ssm",
    n_layers=64,
    d_model=4096,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab_size=65024,
    ssm_state=16,
    d_conv=4,
    expand=2,
)
