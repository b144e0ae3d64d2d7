"""H2O-Danube3-4B — llama+mistral mix with sliding-window attention
[arXiv:2401.16818; unverified].

The JAX package's ``configs/h2o_danube_3_4b.py``, the same widths.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-3-4b",
    family="dense",
    n_layers=24,
    d_model=3840,
    n_heads=32,
    n_kv_heads=8,
    d_ff=10240,
    vocab_size=32000,
    sliding_window=4096,
    act="silu",
)
