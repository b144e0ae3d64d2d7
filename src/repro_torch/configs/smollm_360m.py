"""SmolLM-360M — llama-arch small [hf:HuggingFaceTB/SmolLM-360M].

The JAX package's ``configs/smollm_360m.py``, the same widths.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="smollm-360m",
    family="dense",
    n_layers=32,
    d_model=960,
    n_heads=15,
    n_kv_heads=5,
    d_ff=2560,
    vocab_size=49152,
    act="silu",
)
