"""Model assembly for the six families of the JAX package's
``models/model.py``: ``dense`` (attention), ``moe`` (attention and a mixture
of experts), ``ssm`` (Mamba-1), ``hybrid`` (RG-LRU and local attention),
``audio`` (an encoder and cross-attention decoder layers) and ``vlm``
(groups of one gated cross-attention layer and dense layers): embedding,
one module per group, head.

The JAX package scans over parameter trees with a leading group axis; here
the groups are an ``nn.ModuleList``, one module per group, and
:func:`repro_torch.convert.model_from_numpy` unstacks that axis.  A dense
layer holds ``ln1``, ``attn``, ``ln2`` and ``mlp``, an MoE layer ``moe``
(with ``moe.shared`` where the configuration has a shared expert) in place
of ``mlp`` (``_dense_group_spec``, ``model.py:39-49``), a Mamba layer
``ln`` and ``mamba``; a hybrid group holds ``rnn`` (a list of
``pattern_rnn`` RG-LRU sublayers: ``ln1``, ``mix``, ``ln2``, ``mlp``) and
a local-attention layer (``aln1``, ``attn``, ``aln2``, ``amlp``), and the
layers past the last full group form ``tail``, a list of RG-LRU sublayers
(``model.py:102-118``, ``:180-185``).  A cross-decoder layer holds ``ln1``,
``attn``, ``lnx``, ``xattn`` (gated cross-attention), ``ln2`` and ``mlp``
(``model.py:130-139``): ``audio`` has ``n_layers`` of them over an encoder
of ``n_enc_layers`` dense layers (``enc_groups``) and ``enc_norm``; a
``vlm`` group holds one as ``cross`` and ``cross_attn_every - 1`` dense
layers as ``self`` (``model.py:142-146``).  The cross-attention source is
``extra["enc_frames"]`` through the encoder, or ``extra["image_embeds"]``
as it is (``model.py:222-225``).  Entry points, as in the JAX package:
``forward`` (logits and the MoE aux loss), ``loss``, ``init_cache``,
``prefill`` and ``decode``; ``abstract`` gives the parameters on the
``meta`` device.  ``Model(cfg, ctx)`` lays the model out over ``ctx``'s
mesh (``model.py:150-203``): every spec carries the reference's axes, the
query heads are padded where the ``"model"`` axis does not divide them,
and the MoE layers run per shard; the model lives whole on the mesh's
first device (the port has no SPMD partitioner).  The parameters are trainable:
``forward`` and ``loss`` build a graph when grad is enabled (attention and
the RG-LRU's recurrence have their custom backwards, the mixer's two
kernels have backward kernels of their own), with each group recomputed in
the backward when ``cfg.remat`` (the reference's ``nothing_saveable`` per
group, ``model.py:230-232``); that recompute runs right before the group's
backward, so it keeps the fused scan's segment states for it
(:func:`repro_torch.kernels.ssm_scan.segment_states`).  ``prefill`` and
``decode`` run under ``torch.no_grad``.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from repro_torch._device import canonical, resolve_device
from repro_torch.distributed.context import MeshCtx
from repro_torch.kernels.ssm_scan import resolve_mixer, segment_states

from . import blocks
from .config import ModelConfig
from .params import Spec, abstract_params, flatten, init_params

__all__ = ["Model", "stack_sizes"]

_FAMILIES = ("dense", "moe", "ssm", "hybrid", "audio", "vlm")
# the cross-attention source of each family that has one: its key of
# ``extra``
_SOURCES = {"audio": "enc_frames", "vlm": "image_embeds"}
# the profiler ranges of the audio encoder and of each cross-attention
ENCODER_RANGE, CROSS_RANGE = "encoder", "cross_attention"


def _param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=t.is_floating_point())


def _placeholder(shape) -> nn.Parameter:
    """A parameter without storage, until :meth:`Model.load_params`."""
    return _param(torch.empty(shape, device="meta"))


class _Group(nn.Module):
    """A spec tree's dict as a module: a parameter per :class:`Spec`, a
    sub-group per dict, an ``nn.ModuleList`` of groups per list, under
    their keys, so that ``named_parameters`` gives the spec tree's dotted
    names (``groups.<i>.moe.shared.wi``, ``groups.<i>.rnn.<j>.mix.wx``)."""

    def __init__(self, specs: Dict[str, Any]):
        super().__init__()
        for name, spec in specs.items():
            if isinstance(spec, Spec):
                setattr(self, name, _placeholder(spec.shape))
            elif isinstance(spec, dict):
                setattr(self, name, _Group(spec))
            else:
                setattr(self, name, nn.ModuleList(_Group(s) for s in spec))


def _attention_layer_spec(cfg: ModelConfig, ctx: MeshCtx) -> Dict[str, Any]:
    """``_dense_group_spec`` (``model.py:39-49``): an MoE layer has ``moe``
    where a dense one has ``mlp``."""
    spec = {"ln1": blocks.norm_spec(cfg),
            "attn": blocks.attention_spec(cfg, ctx),
            "ln2": blocks.norm_spec(cfg)}
    if cfg.family == "moe":
        spec["moe"] = blocks.moe_spec(cfg, ctx)
    else:
        spec["mlp"] = blocks.mlp_spec(cfg, ctx)
    return spec


def _rnn_sublayer_spec(cfg: ModelConfig, ctx: MeshCtx) -> Dict[str, Any]:
    """``model.py:102-108``."""
    return {"ln1": blocks.norm_spec(cfg), "mix": blocks.rglru_spec(cfg, ctx),
            "ln2": blocks.norm_spec(cfg), "mlp": blocks.mlp_spec(cfg, ctx)}


def _xdec_layer_spec(cfg: ModelConfig, ctx: MeshCtx) -> Dict[str, Any]:
    """A decoder layer with cross-attention (``_xdec_group_spec``,
    ``model.py:130-139``)."""
    return {"ln1": blocks.norm_spec(cfg),
            "attn": blocks.attention_spec(cfg, ctx),
            "lnx": blocks.norm_spec(cfg),
            "xattn": blocks.attention_spec(cfg, ctx, cross=True),
            "ln2": blocks.norm_spec(cfg), "mlp": blocks.mlp_spec(cfg, ctx)}


def _layer_spec(cfg: ModelConfig, ctx: MeshCtx) -> Dict[str, Any]:
    """One entry of ``groups``: a layer; for ``hybrid`` a group of
    ``pattern_rnn`` RG-LRU sublayers and one local-attention layer
    (``_hybrid_group_spec``, ``model.py:111-118``); for ``vlm`` one
    cross-decoder layer and ``cross_attn_every - 1`` dense layers
    (``_vlm_group_spec``, ``model.py:142-146``)."""
    if cfg.family == "ssm":
        return {"ln": blocks.norm_spec(cfg),
                "mamba": blocks.mamba_spec(cfg, ctx)}
    if cfg.family == "hybrid":
        return {"rnn": [_rnn_sublayer_spec(cfg, ctx)
                        for _ in range(cfg.pattern_rnn)],
                "aln1": blocks.norm_spec(cfg),
                "attn": blocks.attention_spec(cfg, ctx),
                "aln2": blocks.norm_spec(cfg),
                "amlp": blocks.mlp_spec(cfg, ctx)}
    if cfg.family == "audio":
        return _xdec_layer_spec(cfg, ctx)
    if cfg.family == "vlm":
        return {"cross": _xdec_layer_spec(cfg, ctx),
                "self": [_attention_layer_spec(cfg, ctx)
                         for _ in range(cfg.cross_attn_every - 1)]}
    return _attention_layer_spec(cfg, ctx)


def stack_sizes(cfg: ModelConfig) -> Dict[str, int]:
    """The entries of each stacked list of the spec tree (the reference's
    leading axes): ``groups`` one per layer; for ``hybrid`` one per full
    group of ``pattern_rnn + 1`` layers and, when ``n_layers`` leaves a
    remainder, a ``tail`` of that many RG-LRU sublayers
    (``model.py:180-185``); for ``audio`` also ``enc_groups``, one per
    encoder layer; for ``vlm`` one per ``cross_attn_every`` layers
    (``model.py:186-192``)."""
    if cfg.family == "audio":
        return {"groups": cfg.n_layers, "enc_groups": cfg.n_enc_layers}
    if cfg.family == "vlm":
        return {"groups": cfg.n_layers // cfg.cross_attn_every}
    if cfg.family != "hybrid":
        return {"groups": cfg.n_layers}
    n_full, rem = divmod(cfg.n_layers, cfg.pattern_rnn + 1)
    return {"groups": n_full, "tail": rem} if rem else {"groups": n_full}


@dataclasses.dataclass(frozen=True)
class _Pass:
    """Which entry point runs a layer: ``forward`` (no cache), ``prefill``
    (returns the cache) or ``decode`` (from a cache, at ``pos``); ``ctx``
    the model's mesh."""
    kind: str
    pos: int = 0
    cache_len: Optional[int] = None
    ctx: Optional[MeshCtx] = None


def _attend(p, h, cfg: ModelConfig, run: _Pass, cache, window):
    """Attention of the pass: (y, its cache; None for ``forward``)."""
    if run.kind == "forward":
        return (blocks.attention_apply(p, h, cfg, run.ctx, window=window),
                None)
    if run.kind == "prefill":
        return blocks.attention_prefill(p, h, cfg, run.ctx, window=window,
                                        cache_len=run.cache_len)
    return blocks.attention_decode(p, h, cache, run.pos, cfg, run.ctx,
                                   window=window)


def _recur(p, h, cfg: ModelConfig, run: _Pass, cache):
    """The RG-LRU of the pass: (y, its cache; None for ``forward``)."""
    if run.kind == "forward":
        return blocks.rglru_apply(p, h, cfg), None
    if run.kind == "prefill":
        return blocks.rglru_prefill(p, h, cfg)
    return blocks.rglru_decode(p, h, cache, cfg)


def _rnn_sublayer(sub, x, cfg: ModelConfig, run: _Pass, cache=None):
    """``_apply_rnn_sublayer``/``_prefill_``/``_decode_rnn_sublayer``
    (``model.py:492-522``): the RG-LRU and the MLP, each on the normed
    residual stream.  Returns (x, the cache)."""
    y, cache = _recur(sub.mix, blocks.norm_apply(sub.ln1, x, cfg), cfg, run,
                      cache)
    x = x + y
    h = blocks.norm_apply(sub.ln2, x, cfg)
    return x + blocks.mlp_apply(sub.mlp, h, cfg), cache


def _attention_layer(layer, x, cfg: ModelConfig, run: _Pass, cache=None):
    """``_dense_group_apply``/``_prefill``/``_decode`` (``model.py:
    59-95``): attention with ``cfg.sliding_window``, then the MLP or the
    MoE layer.  Returns (x, the cache, the MoE aux loss or None)."""
    y, c = _attend(layer.attn, blocks.norm_apply(layer.ln1, x, cfg), cfg,
                   run, cache, cfg.sliding_window)
    x = x + y
    h = blocks.norm_apply(layer.ln2, x, cfg)
    if cfg.family == "moe":
        y, aux = blocks.moe_apply(layer.moe, h, cfg, run.ctx)
    else:
        y, aux = blocks.mlp_apply(layer.mlp, h, cfg), None
    return x + y, c, aux


def _xdec_layer(layer, x, src, cfg: ModelConfig, run: _Pass, cache=None):
    """``_apply_``/``_prefill_``/``_decode_xdec_layer`` (``model.py:
    553-592``): self-attention with ``cfg.sliding_window``, gated
    cross-attention over ``src`` (the encoder's output or the image
    embeddings), the MLP.  Prefill's cache is ``{"self", "cross"}``, the
    cross k and v of ``src`` computed once; decode attends over that cross
    cache and returns it as it is, neither cloned nor copied.  The
    cross-attention, with its norm, is the profiler range
    ``cross_attention``."""
    y, self_c = _attend(layer.attn, blocks.norm_apply(layer.ln1, x, cfg),
                        cfg, run, None if cache is None else cache["self"],
                        cfg.sliding_window)
    x = x + y
    with torch.profiler.record_function(CROSS_RANGE):
        h = blocks.norm_apply(layer.lnx, x, cfg)
        if run.kind == "decode":
            y, cross_c = blocks.attention_decode(
                layer.xattn, h, cache["cross"], run.pos, cfg, run.ctx,
                cross=True)
        else:
            y, cross_c = blocks.cross_attention(layer.xattn, h, src, cfg,
                                                run.ctx)
    x = x + y
    h = blocks.norm_apply(layer.ln2, x, cfg)
    x = x + blocks.mlp_apply(layer.mlp, h, cfg)
    return x, None if run.kind == "forward" else {"self": self_c,
                                                  "cross": cross_c}


def _keep_states_in_recompute():
    """remat's (forward, recompute) contexts: the recompute keeps the
    fused scan's segment states for the backward that follows it."""
    return contextlib.nullcontext(), segment_states()


class Model(nn.Module):
    """A language model of the ``dense`` (attention), ``moe`` (attention
    and a mixture of experts), ``ssm`` (Mamba-1), ``hybrid`` (RG-LRU and
    local attention), ``audio`` (an encoder and cross-attention decoder
    layers) or ``vlm`` (gated cross-attention over image embeddings)
    family on one device (``ValueError`` for another family).

    ``ctx`` (a :class:`~repro_torch.distributed.context.MeshCtx`; ``None``
    is ``MeshCtx(None)``, no mesh) lays the model out over its mesh, as the
    reference's ``Model(cfg, ctx)``: the specs' axes, padded query heads,
    the MoE per shard.  ``device=None`` is the mesh's first device under a
    mesh (``ValueError`` for another), else the CUDA device
    (``RuntimeError`` without one); on the ``meta`` device the parameters
    have no storage (the dry run).
    ``scan`` picks the Mamba mixer's two kernels (the causal convolution
    and the fused scan): ``"auto"`` the kernels for CUDA tensors and their
    plain versions for CPU ones, ``"reference"`` the plain versions
    anywhere, ``"cuda"`` the kernels (``ValueError`` off the card); the
    other families run none of the port's kernels and check the value
    alike.  The weights are ``params`` (dotted name → tensor, see
    :meth:`load_params`) when given, else drawn by
    :func:`~repro_torch.models.params.init_params` from ``generator``
    (default: a generator on the device seeded with 0), on the device.
    """

    def __init__(self, cfg: ModelConfig, ctx: Optional[MeshCtx] = None, *,
                 device=None, scan: str = "auto",
                 generator: Optional[torch.Generator] = None,
                 params: Optional[Dict[str, torch.Tensor]] = None):
        super().__init__()
        if cfg.family not in _FAMILIES:
            raise ValueError(f"family {cfg.family!r}: the families are "
                             f"{_FAMILIES}")
        ctx = MeshCtx(None) if ctx is None else ctx
        if ctx.mesh is not None:
            first = ctx.mesh.flat[0]
            if device is not None and canonical(device) != first:
                raise ValueError(f"device {device} is not the mesh's first "
                                 f"device {first}")
            device = first
        dev = resolve_device(device)
        resolve_mixer(scan, dev)
        self.cfg, self.ctx, self.scan, self._device = cfg, ctx, scan, dev
        for name, spec in self.param_specs().items():
            if isinstance(spec, Spec):
                setattr(self, name, _placeholder(spec.shape))
            elif isinstance(spec, dict):
                setattr(self, name, _Group(spec))
            else:
                setattr(self, name, nn.ModuleList(_Group(s) for s in spec))
        if params is None and dev.type == "meta":
            params = self.abstract()
        elif params is None:
            if generator is None:
                generator = torch.Generator(device=dev).manual_seed(0)
            params = init_params(self.param_specs(), generator,
                                 cfg.parameter_dtype, dev)
        self.load_params(params)

    @property
    def device(self) -> torch.device:
        return self._device

    def param_specs(self) -> Dict[str, Any]:
        """The spec tree; its dotted names are ``named_parameters``'s.  The
        reference stacks each list (``groups``, ``tail``, ``enc_groups``)
        along a leading axis (:func:`stack_sizes`), whose axis is ``None``:
        each layer's spec here is the stacked one's without it.  The
        vocabulary over ``"model"`` when it divides (the embedding width
        then over FSDP), else the width (``model.py:155-171``)."""
        cfg, ctx = self.cfg, self.ctx
        v, d = cfg.vocab_size, cfg.d_model
        vocab_ax = "model" if v % ctx.tp_size == 0 else None
        if vocab_ax == "model":
            emb_ax = head_in_ax = "fsdp"
        elif d % ctx.tp_size == 0:
            emb_ax = head_in_ax = "model"
        else:
            emb_ax = head_in_ax = None
        tree: Dict[str, Any] = {
            "embed": Spec((v, d), (vocab_ax, emb_ax)),
            "final_norm": blocks.norm_spec(cfg),
            "lm_head": Spec((d, v), (head_in_ax, vocab_ax)),
        }
        sizes = stack_sizes(cfg)
        tree["groups"] = [_layer_spec(cfg, ctx)
                          for _ in range(sizes["groups"])]
        if "tail" in sizes:
            tree["tail"] = [_rnn_sublayer_spec(cfg, ctx)
                            for _ in range(sizes["tail"])]
        if cfg.family == "audio":
            tree["enc_groups"] = [_attention_layer_spec(cfg, ctx)
                                  for _ in range(sizes["enc_groups"])]
            tree["enc_norm"] = blocks.norm_spec(cfg)
        return tree

    def abstract(self) -> Dict[str, torch.Tensor]:
        """Every parameter as a tensor of its shape and ``param_dtype`` on
        the ``meta`` device, by dotted name (``Model.abstract``)."""
        return abstract_params(self.param_specs(), self.cfg.parameter_dtype)

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

    # ---- layers ----

    def _tokens(self, tokens) -> torch.Tensor:
        if isinstance(tokens, np.ndarray):
            tokens = torch.from_numpy(tokens)
        return torch.as_tensor(tokens, device=self.device).long()

    def _embed(self, tokens) -> torch.Tensor:
        return self.embed[self._tokens(tokens)].to(self.cfg.activation_dtype)

    def _head(self, x: torch.Tensor) -> torch.Tensor:
        x = blocks.norm_apply(self.final_norm, x, self.cfg)
        return (x @ self.lm_head.to(x.dtype)).float()

    def _encode(self, frames: torch.Tensor) -> torch.Tensor:
        """The audio encoder (``Model._encode``, ``model.py:255-267``): per
        layer non-causal self-attention with RoPE and the MLP, each on the
        normed residual stream; then ``enc_norm``.  The profiler range
        ``encoder``."""
        cfg = self.cfg
        h = frames
        with torch.profiler.record_function(ENCODER_RANGE):
            for layer in self.enc_groups:
                n = blocks.norm_apply(layer.ln1, h, cfg)
                h = h + blocks.attention_apply(layer.attn, n, cfg, self.ctx,
                                               causal=False)
                n = blocks.norm_apply(layer.ln2, h, cfg)
                h = h + blocks.mlp_apply(layer.mlp, n, cfg)
            return blocks.norm_apply(self.enc_norm, h, cfg)

    def _source(self, extra: Optional[Dict]) -> Optional[torch.Tensor]:
        """The cross-attention source of a call (``model.py:221-225``):
        ``extra["enc_frames"]`` (B, S_enc, D) through the encoder, or
        ``extra["image_embeds"]`` (B, N_img, D) as it is, each cast to the
        activation dtype first; None for the families without one."""
        key = _SOURCES.get(self.cfg.family)
        if key is None:
            return None
        if not extra or key not in extra:
            raise ValueError(f"a {self.cfg.family} model needs "
                             f"extra[{key!r}]")
        src = torch.as_tensor(extra[key], device=self.device).to(
            self.cfg.activation_dtype)
        return self._encode(src) if self.cfg.family == "audio" else src

    def _group(self, layer: _Group, x: torch.Tensor, run: _Pass,
               cache=None, src: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, Any, Optional[torch.Tensor]]:
        """One entry of ``groups`` in the pass ``run``, ``src`` the
        cross-attention source (``Model._group_apply``/``_group_prefill``/
        ``_group_decode``, ``model.py:270-292``, ``:370-420``,
        ``:422-486``).  Returns (x, its cache; None for ``forward``, the MoE
        aux loss; None for the other families)."""
        cfg = self.cfg
        if cfg.family == "ssm":
            h = blocks.norm_apply(layer.ln, x, cfg)
            if run.kind == "forward":
                y, c = blocks.mamba_apply(layer.mamba, h, cfg, self.scan), None
            elif run.kind == "prefill":
                y, c = blocks.mamba_prefill(layer.mamba, h, cfg, self.scan)
            else:
                y, c = blocks.mamba_decode(layer.mamba, h, cache, cfg,
                                           self.scan)
            return x + y, c, None
        if cfg.family == "hybrid":
            caches = {"rnn": []}
            for j, sub in enumerate(layer.rnn):
                x, c = _rnn_sublayer(sub, x, cfg, run, None if cache is None
                                     else cache["rnn"][j])
                caches["rnn"].append(c)
            y, caches["attn"] = _attend(
                layer.attn, blocks.norm_apply(layer.aln1, x, cfg), cfg, run,
                None if cache is None else cache["attn"], cfg.local_window)
            x = x + y
            h = blocks.norm_apply(layer.aln2, x, cfg)
            x = x + blocks.mlp_apply(layer.amlp, h, cfg)
            return x, None if run.kind == "forward" else caches, None
        if cfg.family == "audio":
            return (*_xdec_layer(layer, x, src, cfg, run, cache), None)
        if cfg.family == "vlm":
            x, xc = _xdec_layer(layer.cross, x, src, cfg, run,
                                None if cache is None else
                                {"self": cache["xself"],
                                 "cross": cache["cross"]})
            selfs = []
            for j, sub in enumerate(layer.self):
                x, c, _ = _attention_layer(sub, x, cfg, run, None if cache
                                           is None else cache["self"][j])
                selfs.append(c)
            if run.kind == "forward":
                return x, None, None
            return x, {"cross": xc["cross"], "xself": xc["self"],
                       "self": selfs}, None
        return _attention_layer(layer, x, cfg, run, cache)

    def _layer(self, layer: _Group, x: torch.Tensor,
               src: Optional[torch.Tensor] = None):
        """A ``forward`` group: (x, the MoE aux loss or None)."""
        x, _, aux = self._group(layer, x, _Pass("forward", ctx=self.ctx),
                                src=src)
        return x, aux

    # ---- forward ----

    def forward(self, tokens, extra: Optional[Dict] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """tokens: (B, S) -> (logits (B, S, V) float32, aux loss float32:
        the MoE layers' sum, 0 for the other families).  ``extra`` holds
        the cross-attention source: ``enc_frames`` (B, S_enc, D) for
        ``audio``, ``image_embeds`` (B, N_img, D) for ``vlm``; the other
        families do not read it.  With grad enabled and ``cfg.remat``, each
        entry of ``groups`` keeps only its inputs (x and the source) for
        the backward and is run again there (a Mamba layer's fused scan
        keeping its segment states for the backward that follows); the
        hybrid's ``tail`` and the audio encoder are not recomputed, as in
        the reference (``model.py:227-245``)."""
        ctx = self.ctx
        x = self._embed(tokens)
        # the reference's placement of the residual stream (sequence over
        # "model" where it divides): checked against the mesh, kept whole
        seq_ax = ("model" if ctx.mesh is not None
                  and x.shape[1] % ctx.tp_size == 0 else None)
        x = ctx.constrain(x, ctx.dp_axes, seq_ax, None)
        src = self._source(extra)
        aux = torch.zeros((), device=x.device)
        remat = self.cfg.remat and torch.is_grad_enabled()
        for layer in self.groups:
            if remat:
                x, a = checkpoint(self._layer, layer, x, src,
                                  use_reentrant=False,
                                  context_fn=_keep_states_in_recompute)
            else:
                x, a = self._layer(layer, x, src)
            if a is not None:
                aux = aux + a
        for sub in getattr(self, "tail", ()):
            x = _rnn_sublayer(sub, x, self.cfg,
                              _Pass("forward", ctx=self.ctx))[0]
        return self._head(x), aux

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
        """An empty cache at position 0 (``model.py:306-352``): per
        attention layer zero k and v of ``min(cache_len, window)`` slots
        (the sliding window, or the hybrid's local window; ``cache_len``
        required), per Mamba layer the conv tail and the scan state, per
        RG-LRU sublayer its conv tail and state; per cross-decoder layer
        also zero cross k and v of ``extra_len`` slots (the source's
        length), under the reference's keys: ``{"self", "cross"}`` per
        audio layer, ``{"cross", "xself", "self": [...]}`` per vlm group.
        The zero cross k and v are not a source's: decoding from this cache
        does not give the forward's cross-attention, in the reference
        either."""
        cfg, dev, dt = self.cfg, self.device, self.cfg.activation_dtype
        if cfg.family == "ssm":
            return {"pos": 0, "groups": [
                blocks.mamba_init_cache(cfg, batch, dt, dev)
                for _ in range(cfg.n_layers)]}
        if cache_len is None:
            raise ValueError(f"a {cfg.family} model's cache needs cache_len")
        window = (cfg.local_window if cfg.family == "hybrid"
                  else cfg.sliding_window)
        slots = min(cache_len, window or cache_len)

        def kv(length: int = slots):
            shape = (batch, length, cfg.n_kv_heads, cfg.head_dim_)
            return {"k": torch.zeros(shape, dtype=dt, device=dev),
                    "v": torch.zeros(shape, dtype=dt, device=dev)}

        sizes = stack_sizes(cfg)
        if cfg.family == "audio":
            return {"pos": 0, "groups": [
                {"self": kv(), "cross": kv(extra_len)}
                for _ in range(sizes["groups"])]}
        if cfg.family == "vlm":
            return {"pos": 0, "groups": [
                {"cross": kv(extra_len), "xself": kv(),
                 "self": [kv() for _ in range(cfg.cross_attn_every - 1)]}
                for _ in range(sizes["groups"])]}
        if cfg.family != "hybrid":
            return {"pos": 0, "groups": [kv() for _ in range(cfg.n_layers)]}
        cache = {"pos": 0, "groups": [
            {"rnn": [blocks.rglru_init_cache(cfg, batch, dt, dev)
                     for _ in range(cfg.pattern_rnn)], "attn": kv()}
            for _ in range(sizes["groups"])]}
        if "tail" in sizes:
            cache["tail"] = [blocks.rglru_init_cache(cfg, batch, dt, dev)
                             for _ in range(sizes["tail"])]
        return cache

    @torch.no_grad()
    def prefill(self, tokens, extra: Optional[Dict] = None,
                cache_len: Optional[int] = None
                ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """Full-sequence forward that also returns the serving cache.
        Returns (last-position logits (B, 1, V) float32, cache).  An
        attention layer's cache has ``cache_len`` slots (default S + 128),
        or its window's ring buffer; a cross-decoder layer's also holds the
        cross k and v of the source (``extra`` as for :meth:`forward`,
        through the encoder once a call).  For ``ssm`` ``cache_len`` is
        unused (``model.py:354``).  The MoE aux loss is dropped."""
        x = self._embed(tokens)
        src = self._source(extra)
        run = _Pass("prefill", cache_len=cache_len, ctx=self.ctx)
        caches = []
        for layer in self.groups:
            x, c, _ = self._group(layer, x, run, src=src)
            caches.append(c)
        cache = {"groups": caches, "pos": x.shape[1]}
        if hasattr(self, "tail"):
            cache["tail"] = []
            for sub in self.tail:
                x, c = _rnn_sublayer(sub, x, self.cfg, run)
                cache["tail"].append(c)
        return self._head(x[:, -1:]), cache

    @torch.no_grad()
    def decode(self, cache: Dict[str, Any], tokens
               ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """One-token step.  tokens: (B, 1).  Returns (logits (B, 1, V)
        float32, the next cache); ``cache`` is not modified, and the next
        cache holds its cross k and v tensors themselves."""
        pos = cache["pos"]
        x = self._embed(tokens)
        run = _Pass("decode", pos=pos, ctx=self.ctx)
        new = []
        for layer, c in zip(self.groups, cache["groups"]):
            x, c, _ = self._group(layer, x, run, c)
            new.append(c)
        out = {"groups": new, "pos": pos + 1}
        if hasattr(self, "tail"):
            out["tail"] = []
            for sub, c in zip(self.tail, cache["tail"]):
                x, c = _rnn_sublayer(sub, x, self.cfg, run, c)
                out["tail"].append(c)
        return self._head(x), out
