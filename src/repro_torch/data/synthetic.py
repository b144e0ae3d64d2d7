"""Synthetic data: the JAX package's constructions on a ``torch.Generator``
(ridge designs, the LM token stream and the stub frontends' inputs).

Two-class Gaussian-mixture data pushed through the Kar–Karnick random
polynomial feature map, with labels from a planted linear model plus noise
(the regime where the hold-out curve has an interior optimum in λ).  The
random stream differs from ``jax.random``, so the same seed gives other
numbers than the JAX package; parity tests feed both packages the same
arrays instead.
"""
from __future__ import annotations

import math
from typing import Dict, Iterator, Optional, Tuple

import torch

from .._device import resolve_device

__all__ = ["make_classification", "random_polynomial_features",
           "make_regression_dataset", "make_low_rank_dataset", "token_stream",
           "cross_source"]


def make_classification(gen: torch.Generator, n: int, raw_dim: int, *,
                        class_sep: float = 1.0, dtype=torch.float32,
                        device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Balanced two-class Gaussian mixture; labels in {−1, +1}."""
    mu = torch.randn(raw_dim, generator=gen, dtype=dtype, device=device
                     ) * class_sep / math.sqrt(raw_dim)
    half = n // 2
    x = torch.randn(2 * half, raw_dim, generator=gen, dtype=dtype,
                    device=device)
    x[:half] += mu
    x[half:] -= mu
    y = torch.cat([torch.ones(half, dtype=dtype, device=device),
                   -torch.ones(half, dtype=dtype, device=device)])
    perm = torch.randperm(2 * half, generator=gen, device=device)
    return x[perm], y[perm]


def random_polynomial_features(gen: torch.Generator, x: torch.Tensor,
                               out_dim: int, degree: int = 2, *,
                               add_intercept: bool = True) -> torch.Tensor:
    """Kar–Karnick random features for (x·z + 1)^p: each feature is
    ∏_{t≤p} (ω_tᵀ[1; x]) with Rademacher ω, scaled by 1/√out_dim, plus an
    intercept column."""
    n, d = x.shape
    x1 = torch.cat([torch.ones(n, 1, dtype=x.dtype, device=x.device), x],
                   dim=1)
    feats = torch.ones(n, out_dim, dtype=x.dtype, device=x.device)
    for _ in range(degree):
        omega = torch.randint(0, 2, (d + 1, out_dim), generator=gen,
                              device=x.device).to(x.dtype) * 2 - 1
        feats = feats * (x1 @ omega)
    feats = feats / math.sqrt(out_dim)
    if add_intercept:
        feats = torch.cat([feats, torch.ones(n, 1, dtype=x.dtype,
                                             device=x.device)], dim=1)
    return feats


def make_regression_dataset(n: int, h: int, *, seed: int = 0,
                            raw_dim: int = 64, noise: float = 1.0,
                            signal_scale: float = 3.0, dtype=torch.float32,
                            device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(n, h) features (h includes the intercept) and (n,) labels, made on
    ``device`` (``None``: the CUDA device) from ``seed``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    x_raw, _ = make_classification(gen, n, raw_dim, dtype=dtype, device=dev)
    feats = random_polynomial_features(gen, x_raw, h - 1, add_intercept=True)
    theta_true = signal_scale * torch.randn(h, generator=gen, dtype=dtype,
                                            device=dev) / math.sqrt(h)
    y = feats @ theta_true + noise * torch.randn(n, generator=gen,
                                                 dtype=dtype, device=dev)
    return feats, y


def make_low_rank_dataset(n: int, h: int, rank: int, *, seed: int = 0,
                          noise: float = 1.0, tail_scale: float = 1e-3,
                          signal_scale: float = 3.0, dtype=torch.float32,
                          device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Planted (numerically) rank-r design in the n ≪ h regime of the
    low-rank ACV strategy, made on ``device`` (``None``: the CUDA device)
    from ``seed``.

    ``X = A @ B + tail_scale · E`` with A (n, r), B (r, h) / √r: the top r
    singular values carry the signal and the tail sits ``tail_scale``
    below them (a small tail keeps the SVD's order and signs determined).
    Labels come from a planted model in the row space plus noise.
    """
    if not 0 < rank <= min(n, h):
        raise ValueError(f"rank must be in (0, min(n={n}, h={h})], got {rank}")
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def normal(*shape):
        return torch.randn(*shape, generator=gen, dtype=dtype, device=dev)

    a = normal(n, rank)
    b = normal(rank, h) / math.sqrt(rank)
    x = a @ b + tail_scale * normal(n, h)
    theta_true = signal_scale * (b.T @ normal(rank)) / math.sqrt(h)
    y = x @ theta_true + noise * normal(n)
    return x, y


def token_stream(generator: torch.Generator, vocab_size: int, batch: int,
                 seq_len: int) -> Iterator[Dict[str, torch.Tensor]]:
    """Endless synthetic LM batches (``src/repro/data/synthetic.py:134``):
    tokens drawn i.i.d. from the Zipf-ish unigram logits
    ``-log1p(arange(V))`` on the generator's device, ``{"tokens": (batch,
    seq_len), "labels": the same shifted by one}`` (int64).  The draws
    differ from ``jax.random``'s; parity tests hand both packages JAX's
    tokens.  On the host a seed gives the same batches on every run; on
    the card ``torch.multinomial`` does not (``scripts/
    probe_token_stream.py``), so a run that must be repeated, as a resumed
    training run, draws on the host."""
    dev = generator.device
    logits = -torch.log1p(torch.arange(vocab_size, dtype=torch.float32,
                                       device=dev))
    probs = torch.softmax(logits, 0)
    while True:
        tokens = torch.multinomial(probs, batch * (seq_len + 1),
                                   replacement=True, generator=generator
                                   ).view(batch, seq_len + 1)
        yield {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}


def cross_source(cfg, generator: torch.Generator, batch: int,
                 seq_len: int) -> Optional[Dict[str, torch.Tensor]]:
    """The ``extra`` of a model's batch, at the sizes of the reference's
    ``extra_specs`` (``src/repro/launch/specs.py:52-65``): for ``audio``
    ``enc_frames`` (batch, seq_len // enc_seq_ratio, d_model), for ``vlm``
    ``image_embeds`` (batch, n_image_tokens, d_model), standard normal in
    the activation dtype on the generator's device (the frontends that
    would make them are stubs in both packages); None for the other
    families."""
    if cfg.family == "audio":
        key, n = "enc_frames", seq_len // cfg.enc_seq_ratio
    elif cfg.family == "vlm":
        key, n = "image_embeds", cfg.n_image_tokens
    else:
        return None
    x = torch.randn((batch, n, cfg.d_model), generator=generator,
                    device=generator.device)
    return {key: x.to(cfg.activation_dtype)}
