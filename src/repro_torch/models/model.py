"""Model assembly for the ``dense`` (attention) and ``ssm`` (Mamba-1)
families: embedding, one module per layer, head; from the JAX package's
``models/model.py``.

The JAX package scans over parameter trees with a leading layer axis; here
the layers are an ``nn.ModuleList``, one module per layer, and
:func:`repro_torch.convert.model_from_numpy` unstacks that axis.  A dense
layer holds ``ln1``, ``attn``, ``ln2`` and ``mlp`` (``_dense_group_spec``,
``model.py:39-49``), a Mamba layer ``ln`` and ``mamba``.  One card, no
sharding.  Entry points, as in the JAX package: ``forward`` (logits),
``loss``, ``init_cache``, ``prefill`` and ``decode``.  The parameters are
trainable: ``forward`` and ``loss`` build a graph when grad is enabled
(attention has its recompute backward, the mixer's two kernels have
backward kernels of their own), with each layer recomputed in the backward
when ``cfg.remat`` (the reference's ``nothing_saveable`` per group,
``model.py:230-232``); that recompute runs right before the layer's
backward, so it keeps the fused scan's segment states for it
(:func:`repro_torch.kernels.ssm_scan.segment_states`).  ``prefill`` and
``decode`` run under ``torch.no_grad``.  The other families of the JAX
package are ``ROADMAP.md`` queue 1 items 2-5.
"""
from __future__ import annotations

import contextlib

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from repro_torch._device import resolve_device
from repro_torch.kernels.ssm_scan import resolve_mixer, segment_states

from . import blocks
from .config import ModelConfig
from .params import Spec, flatten, init_params

__all__ = ["Model"]

# the families the port runs, and the JAX package's others by their item of
# ROADMAP.md queue 1
_FAMILIES = ("dense", "ssm")
_QUEUED = {"moe": "queue 1 item 2", "hybrid": "queue 1 item 3",
          "audio": "queue 1 item 4", "vlm": "queue 1 item 5"}


def _param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=t.is_floating_point())


def _placeholder(shape) -> nn.Parameter:
    """A parameter without storage, until :meth:`Model.load_params`."""
    return _param(torch.empty(shape, device="meta"))


class _Leaves(nn.Module):
    """A group of named parameters (a norm, a Mamba mixer)."""

    def __init__(self, specs: Dict[str, Spec]):
        super().__init__()
        for name, spec in specs.items():
            setattr(self, name, _placeholder(spec.shape))


class _Layer(nn.Module):
    """One layer: a :class:`_Leaves` per group of its spec."""

    def __init__(self, specs: Dict[str, Dict[str, Spec]]):
        super().__init__()
        for name, group in specs.items():
            setattr(self, name, _Leaves(group))


def _layer_spec(cfg: ModelConfig) -> Dict[str, Dict[str, Spec]]:
    if cfg.family == "dense":
        return {"ln1": blocks.norm_spec(cfg),
                "attn": blocks.attention_spec(cfg),
                "ln2": blocks.norm_spec(cfg),
                "mlp": blocks.mlp_spec(cfg)}
    return {"ln": blocks.norm_spec(cfg), "mamba": blocks.mamba_spec(cfg)}


def _dense_layer(layer: _Layer, x: torch.Tensor, cfg: ModelConfig, attend
                 ) -> Tuple[torch.Tensor, Any]:
    """A dense layer (``_dense_group_apply``/``_prefill``/``_decode``,
    ``model.py:59-95``): ``attend(p, h)`` (the attention and its cache) and
    the MLP, each on the normed residual stream.  Returns (x, the cache)."""
    y, cache = attend(layer.attn, blocks.norm_apply(layer.ln1, x, cfg))
    x = x + y
    h = blocks.norm_apply(layer.ln2, x, cfg)
    return x + blocks.mlp_apply(layer.mlp, h, cfg), cache


def _keep_states_in_recompute():
    """remat's (forward, recompute) contexts: the recompute keeps the
    fused scan's segment states for the backward that follows it."""
    return contextlib.nullcontext(), segment_states()


class Model(nn.Module):
    """A ``dense`` (attention) or ``ssm`` (Mamba-1) language model on one
    device.

    ``device=None`` is the CUDA device (``RuntimeError`` without one).
    ``scan`` picks the Mamba mixer's two kernels (the causal convolution
    and the fused scan): ``"auto"`` the kernels for CUDA tensors and their
    plain versions for CPU ones, ``"reference"`` the plain versions
    anywhere, ``"cuda"`` the kernels (``ValueError`` off the card); a dense
    model runs none of the port's kernels and checks the value alike.  The
    weights are ``params`` (dotted name → tensor, see :meth:`load_params`)
    when given, else drawn by
    :func:`~repro_torch.models.params.init_params` from ``generator``
    (default: a generator on the device seeded with 0), on the device.
    """

    def __init__(self, cfg: ModelConfig, *, device=None, scan: str = "auto",
                 generator: Optional[torch.Generator] = None,
                 params: Optional[Dict[str, torch.Tensor]] = None):
        super().__init__()
        if cfg.family not in _FAMILIES:
            where = _QUEUED.get(cfg.family)
            raise NotImplementedError(
                f"family {cfg.family!r}: the port runs {_FAMILIES}"
                + (f"; {cfg.family!r} is ROADMAP.md {where}" if where
                   else ""))
        dev = resolve_device(device)
        resolve_mixer(scan, dev)
        self.cfg, self.scan, self._device = cfg, scan, dev
        v, d = cfg.vocab_size, cfg.d_model
        self.embed = _placeholder((v, d))
        self.final_norm = _Leaves(blocks.norm_spec(cfg))
        self.lm_head = _placeholder((d, v))
        self.groups = nn.ModuleList(_Layer(_layer_spec(cfg))
                                    for _ in range(cfg.n_layers))
        if params is None:
            if generator is None:
                generator = torch.Generator(device=dev).manual_seed(0)
            params = init_params(self.param_specs(), generator,
                                 cfg.parameter_dtype, dev)
        self.load_params(params)

    @property
    def device(self) -> torch.device:
        return self._device

    def param_specs(self) -> Dict[str, Any]:
        """The spec tree; its dotted names are ``named_parameters``'s."""
        cfg = self.cfg
        v, d = cfg.vocab_size, cfg.d_model
        return {
            "embed": Spec((v, d)),
            "final_norm": blocks.norm_spec(cfg),
            "lm_head": Spec((d, v)),
            "groups": [_layer_spec(cfg) for _ in range(cfg.n_layers)],
        }

    @torch.no_grad()
    def load_params(self, params: Dict[str, torch.Tensor]) -> "Model":
        """Take every parameter from ``params`` (dotted name → tensor of the
        spec's shape); tensors on the model's device become its parameters
        as they are, others are copied there."""
        specs = dict(flatten(self.param_specs()))
        if set(params) != set(specs):
            raise ValueError(f"parameters {sorted(set(params) ^ set(specs))} "
                             "missing or unknown")
        for name, t in params.items():
            if tuple(t.shape) != specs[name].shape:
                raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                                 f"{specs[name].shape}")
            mod_name, _, leaf = name.rpartition(".")
            mod = self.get_submodule(mod_name) if mod_name else self
            setattr(mod, leaf, _param(t.to(self._device)))
        return self

    # ---- forward ----

    def _tokens(self, tokens) -> torch.Tensor:
        if isinstance(tokens, np.ndarray):
            tokens = torch.from_numpy(tokens)
        return torch.as_tensor(tokens, device=self.device).long()

    def _embed(self, tokens) -> torch.Tensor:
        return self.embed[self._tokens(tokens)].to(self.cfg.activation_dtype)

    def _head(self, x: torch.Tensor) -> torch.Tensor:
        x = blocks.norm_apply(self.final_norm, x, self.cfg)
        return (x @ self.lm_head.to(x.dtype)).float()

    def _layer(self, layer: _Layer, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        if cfg.family == "ssm":
            h = blocks.norm_apply(layer.ln, x, cfg)
            return x + blocks.mamba_apply(layer.mamba, h, cfg, self.scan)
        return _dense_layer(layer, x, cfg, lambda p, h: (
            blocks.attention_apply(p, h, cfg, window=cfg.sliding_window),
            None))[0]

    def forward(self, tokens, extra: Optional[Dict] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """tokens: (B, S) -> (logits (B, S, V) float32, aux loss 0).
        ``extra`` is the reference's argument (encoder frames, image
        embeddings) and unused by the ``dense`` and ``ssm`` families.  With
        grad enabled and ``cfg.remat``, each layer keeps only its input for
        the backward and is run again there (a Mamba layer's fused scan
        keeping its segment states for the backward that follows)."""
        x = self._embed(tokens)
        remat = self.cfg.remat and torch.is_grad_enabled()
        for layer in self.groups:
            if remat:
                x = checkpoint(self._layer, layer, x, use_reentrant=False,
                               context_fn=_keep_states_in_recompute)
            else:
                x = self._layer(layer, x)
        return self._head(x), torch.zeros((), device=x.device)

    def loss(self, batch: Dict[str, Any], extra: Optional[Dict] = None
             ) -> Tuple[torch.Tensor, Dict]:
        """Mean next-token NLL of ``batch["labels"]`` plus 0.01 · aux, and
        ``{"nll", "aux"}`` (``model.py:296-302``)."""
        logits, aux = self.forward(batch["tokens"], extra)
        labels = self._tokens(batch["labels"])
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, labels[..., None])[..., 0]
        nll = (logz - gold).mean()
        return nll + 0.01 * aux, {"nll": nll, "aux": aux}

    # ---- serving ----

    def init_cache(self, batch: int, cache_len: Optional[int] = None,
                   extra_len: int = 0) -> Dict[str, Any]:
        """An empty cache at position 0 (``model.py:306-352``): per dense
        layer zero k and v of ``min(cache_len, sliding_window)`` slots
        (``cache_len`` required), per Mamba layer the conv tail and the
        scan state (which depend on neither ``cache_len`` nor
        ``extra_len``, the reference's cross-attention source length)."""
        cfg, dev = self.cfg, self.device
        if cfg.family == "ssm":
            return {"pos": 0, "groups": [
                blocks.mamba_init_cache(cfg, batch, cfg.activation_dtype,
                                        dev)
                for _ in range(cfg.n_layers)]}
        if cache_len is None:
            raise ValueError("a dense model's cache needs cache_len")
        attn_len = min(cache_len, cfg.sliding_window or cache_len)
        shape = (batch, attn_len, cfg.n_kv_heads, cfg.head_dim_)
        return {"pos": 0, "groups": [
            {"k": torch.zeros(shape, dtype=cfg.activation_dtype, device=dev),
             "v": torch.zeros(shape, dtype=cfg.activation_dtype, device=dev)}
            for _ in range(cfg.n_layers)]}

    @torch.no_grad()
    def prefill(self, tokens, extra: Optional[Dict] = None,
                cache_len: Optional[int] = None
                ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """Full-sequence forward that also returns the serving cache.
        Returns (last-position logits (B, 1, V) float32, cache).  A dense
        model's cache has ``cache_len`` slots (default S + 128), or the
        sliding window's ring buffer; ``extra`` and, for ``ssm``,
        ``cache_len`` are unused (``model.py:354``)."""
        cfg = self.cfg
        x = self._embed(tokens)
        caches = []
        for layer in self.groups:
            if cfg.family == "ssm":
                h = blocks.norm_apply(layer.ln, x, cfg)
                y, cache = blocks.mamba_prefill(layer.mamba, h, cfg,
                                                self.scan)
                x = x + y
            else:
                x, cache = _dense_layer(
                    layer, x, cfg, lambda p, h: blocks.attention_prefill(
                        p, h, cfg, window=cfg.sliding_window,
                        cache_len=cache_len))
            caches.append(cache)
        return self._head(x[:, -1:]), {"groups": caches, "pos": x.shape[1]}

    @torch.no_grad()
    def decode(self, cache: Dict[str, Any], tokens
               ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """One-token step.  tokens: (B, 1).  Returns (logits (B, 1, V)
        float32, the next cache); ``cache`` is not modified."""
        cfg, pos = self.cfg, cache["pos"]
        x = self._embed(tokens)
        new = []
        for layer, c in zip(self.groups, cache["groups"]):
            if cfg.family == "ssm":
                h = blocks.norm_apply(layer.ln, x, cfg)
                y, c = blocks.mamba_decode(layer.mamba, h, c, cfg, self.scan)
                x = x + y
            else:
                x, c = _dense_layer(
                    layer, x, cfg, lambda p, h, c=c: blocks.attention_decode(
                        p, h, c, pos, cfg, window=cfg.sliding_window))
            new.append(c)
        return self._head(x), {"groups": new, "pos": pos + 1}
