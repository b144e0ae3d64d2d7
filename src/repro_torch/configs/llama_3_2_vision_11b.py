"""Llama-3.2-Vision-11B backbone — gated cross-attn image layers every 5
[hf:meta-llama/Llama-3.2-11B-Vision; unverified].

The JAX package's ``configs/llama_3_2_vision_11b.py``, the same widths.
The ViT frontend is a stub there too: the cross-attention reads
precomputed patch embeddings, ``extra["image_embeds"]`` (B,
n_image_tokens, d_model).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b",
    family="vlm",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=128256,
    rope_theta=500_000.0,
    cross_attn_every=5,
    n_image_tokens=1601,
    act="silu",
)
