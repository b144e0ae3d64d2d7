"""Model configuration, the JAX package's ``models/config.py`` carried over.

One frozen dataclass covers all 10 families of the reference; family-specific
fields are zero/None when unused.  ``reduced()`` derives the CPU test config.
The port runs all six families; the fields the port does not read (the TP
head padding) are kept so that a configuration reads the same in both
packages.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

__all__ = ["ModelConfig", "torch_dtype"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16, "float64": torch.float64}


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a configuration's dtype name."""
    return _DTYPES[name]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None  # default d_model // n_heads
    qkv_bias: bool = False
    act: str = "silu"               # silu (SwiGLU) | gelu
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = False

    # attention variants
    sliding_window: Optional[int] = None    # SWA width (tokens)

    # MoE
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    n_shared_experts: int = 0
    capacity_factor: float = 1.25

    # SSM (Mamba-1)
    ssm_state: int = 0
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0                # 0 -> ceil(d_model / 16)

    # hybrid (RecurrentGemma): block pattern = `pattern_rnn` RG-LRU blocks
    # followed by 1 local-attention block, repeated.
    pattern_rnn: int = 0
    local_window: int = 2048
    lru_width: int = 0              # 0 -> d_model

    # encoder-decoder (Whisper)
    n_enc_layers: int = 0
    enc_seq_ratio: int = 2          # stub frontend: enc_len = seq_len // ratio

    # VLM (Llama-3.2-Vision): one cross-attn block every `cross_attn_every`
    cross_attn_every: int = 0
    n_image_tokens: int = 0

    # TP head padding: when n_heads doesn't divide the model axis, pad query
    # heads up to the next multiple so attention shards fully (Megatron GQA
    # with replicated KV).  Padded heads are extra capacity, not a stub —
    # set False to keep the exact reference head count (smoke tests use
    # tp=1 where padding is a no-op anyway).
    pad_heads: bool = True

    # numerics / memory
    dtype: str = "bfloat16"
    param_dtype: str = "bfloat16"
    remat: bool = True
    scan_chunk: int = 256           # recurrence chunk (ssm / rg-lru)
    attn_chunk: int = 1024          # flash-attention KV chunk

    # ---- derived ----
    @property
    def head_dim_(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.n_heads if self.n_heads else 0

    @property
    def dt_rank_(self) -> int:
        return self.dt_rank or -(-self.d_model // 16)

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def lru_width_(self) -> int:
        return self.lru_width or self.d_model

    @property
    def activation_dtype(self) -> torch.dtype:
        return torch_dtype(self.dtype)

    @property
    def parameter_dtype(self) -> torch.dtype:
        return torch_dtype(self.param_dtype)

    @property
    def subquadratic(self) -> bool:
        """Can this arch run long_500k decode with O(1)/O(window) state?"""
        return (self.family in ("ssm", "hybrid")
                or self.sliding_window is not None)

    def n_params(self) -> int:
        """Approximate parameter count (used for MODEL_FLOPS = 6·N·D)."""
        d, hd = self.d_model, self.head_dim_
        attn = (d * hd * (self.n_heads + 2 * self.n_kv_heads)
                + self.n_heads * hd * d) if self.n_heads else 0
        dense_mlp = d * self.d_ff * (3 if self.act == "silu" else 2)
        per_layer = 0
        if self.family == "ssm":
            di, n, r = self.d_inner, self.ssm_state, self.dt_rank_
            per_layer = (d * 2 * di + di * self.d_conv + di * (2 * n + r)
                         + r * di + di * n + di * d)
        elif self.family == "moe":
            moe = self.n_experts * d * self.moe_d_ff * 3 + d * self.n_experts
            moe += self.n_shared_experts * d * self.moe_d_ff * 3
            per_layer = attn + moe
        elif self.family == "hybrid":
            w = self.lru_width_
            rnn = d * w * 2 + w * d + 2 * w + d * self.d_ff * 3
            att = attn + d * self.d_ff * 3
            per_layer = (self.pattern_rnn * rnn + att) / (self.pattern_rnn + 1)
        else:
            per_layer = attn + dense_mlp
        total = self.n_layers * per_layer + self.vocab_size * d
        if self.family == "audio":
            total += self.n_enc_layers * (attn + dense_mlp)
        if self.family == "vlm" and self.cross_attn_every:
            n_cross = self.n_layers // self.cross_attn_every
            total += n_cross * attn
        if not self.tie_embeddings:
            total += self.vocab_size * d
        return int(total)

    def n_active_params(self) -> int:
        """Active params per token (MoE: only top_k + shared experts)."""
        if self.family != "moe":
            return self.n_params()
        d = self.d_model
        active_moe = (self.top_k + self.n_shared_experts) * d * self.moe_d_ff * 3
        hd = self.head_dim_
        attn = d * hd * (self.n_heads + 2 * self.n_kv_heads) + self.n_heads * hd * d
        per_layer = attn + active_moe + d * self.n_experts
        return int(self.n_layers * per_layer + 2 * self.vocab_size * d)

    def reduced(self) -> "ModelConfig":
        """Tiny same-family config for CPU smoke tests."""
        def cap(v, m):
            return min(v, m)

        return dataclasses.replace(
            self,
            n_layers=cap(self.n_layers, 4) if self.family != "hybrid"
            else (self.pattern_rnn + 1),
            d_model=cap(self.d_model, 64),
            n_heads=cap(self.n_heads, 4),
            n_kv_heads=cap(self.n_kv_heads, 2) if self.n_kv_heads < self.n_heads
            else cap(self.n_heads, 4),
            head_dim=16 if self.head_dim or self.d_model > 64 else None,
            d_ff=cap(self.d_ff, 128) if self.d_ff else 0,
            vocab_size=cap(self.vocab_size, 512),
            n_experts=cap(self.n_experts, 8),
            top_k=cap(self.top_k, 2),
            moe_d_ff=cap(self.moe_d_ff, 64),
            # drop-free capacity so smoke tests are exactly batch-invariant
            capacity_factor=float(max(self.n_experts, 1)),
            ssm_state=cap(self.ssm_state, 8),
            dt_rank=8 if self.family == "ssm" else 0,
            lru_width=cap(self.lru_width_, 64) if self.family == "hybrid" else 0,
            local_window=cap(self.local_window, 32),
            sliding_window=cap(self.sliding_window, 32) if self.sliding_window else None,
            n_enc_layers=cap(self.n_enc_layers, 2),
            n_image_tokens=cap(self.n_image_tokens, 16),
            cross_attn_every=cap(self.cross_attn_every, 2) if self.cross_attn_every else 0,
            scan_chunk=min(self.scan_chunk, 16) if self.scan_chunk else 0,
            attn_chunk=32,
            dtype="float32",
            param_dtype="float32",
            remat=False,
        )
