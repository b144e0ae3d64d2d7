"""Whisper-base — encoder-decoder [arXiv:2212.04356; unverified].

The JAX package's ``configs/whisper_base.py``, the same widths.  The
conv/mel frontend is a stub there too: the encoder takes precomputed frame
embeddings, ``extra["enc_frames"]`` (B, S // enc_seq_ratio, d_model).  As
in the reference, the encoder and decoder use RoPE and the cross-attention
is gated (``ROADMAP.md``, differences by design).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base",
    family="audio",
    n_layers=6,
    n_enc_layers=6,
    d_model=512,
    n_heads=8,
    n_kv_heads=8,
    d_ff=2048,
    vocab_size=51865,
    act="gelu",
    enc_seq_ratio=2,
)
