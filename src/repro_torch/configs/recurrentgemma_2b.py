"""RecurrentGemma-2B — RG-LRU + local attention, 2:1 pattern
[arXiv:2402.19427; hf].

The JAX package's ``configs/recurrentgemma_2b.py``, the same widths (no
embedding scale, as the reference has none).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,
    d_ff=7680,
    vocab_size=256000,
    head_dim=256,
    pattern_rnn=2,
    local_window=2048,
    lru_width=2560,
    act="silu",
)
