"""Abstract inputs with their placements, for every dry-run input
(``src/repro/launch/specs.py``).

Nothing is allocated: parameters, optimizer states and caches are tensors
on the ``meta`` device, each wrapped with its placement as a
:class:`Placed` (the port's ``jax.ShapeDtypeStruct(..., sharding=)``), so
the dry run reads every leaf's local shape and bytes on the production
layout.  Parameters and caches are per layer, under the port's dotted
names (each layer's spec is the reference's stacked one without its
leading ``None``); optimizer states keep the reference's stacked layout,
so they take the stacked specs.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Iterator, Optional, Tuple

import torch

from repro_torch.distributed import sharding as shlib
from repro_torch.distributed.context import MeshCtx
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import Model
from repro_torch.optim._tree import leaves

__all__ = ["Placed", "placed_leaves", "attach", "param_specs_sharded",
           "batch_specs", "extra_specs", "cache_specs", "opt_state_specs"]


@dataclasses.dataclass(frozen=True)
class Placed:
    """A ``meta`` tensor and its placement (``None`` without a mesh)."""
    tensor: torch.Tensor
    sharding: Optional[shlib.NamedSharding]

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(self.tensor.shape)

    @property
    def dtype(self) -> torch.dtype:
        return self.tensor.dtype

    @property
    def local_shape(self) -> Tuple[int, ...]:
        """Each device's block shape."""
        if self.sharding is None:
            return self.shape
        return self.sharding.shard_shape(self.shape)

    @property
    def local_nbytes(self) -> int:
        return math.prod(self.local_shape) * self.tensor.element_size()


def _placed(shape, dtype, ctx: MeshCtx, spec: tuple) -> Placed:
    return Placed(torch.empty(shape, dtype=dtype, device="meta"),
                  ctx.sharding(*spec))


def placed_leaves(tree: Any) -> Iterator[Placed]:
    """The :class:`Placed` leaves of a tree of dicts, lists and tuples."""
    if isinstance(tree, Placed):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from placed_leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from placed_leaves(v)


def attach(tree: Dict[str, torch.Tensor], pspecs: Dict[str, tuple],
           ctx: MeshCtx) -> Dict[str, Placed]:
    """Meta tensors and partition specs by name → :class:`Placed` by
    name."""
    return {name: Placed(t, ctx.sharding(*pspecs[name]))
            for name, t in tree.items()}


def param_specs_sharded(model: Model) -> Dict[str, Placed]:
    """Every parameter of ``model`` on its placement, by dotted name."""
    specs = model.param_specs()
    return attach(model.abstract(), shlib.param_pspecs(specs, model.ctx),
                  model.ctx)


def batch_specs(cfg: ModelConfig, ctx: MeshCtx, batch: int, seq: int, *,
                with_labels: bool) -> Dict[str, Placed]:
    """int32 ``tokens`` (and ``labels``), the batch over the data axes
    when they divide it."""
    spec = (ctx.dp_axes, None) if batch % ctx.dp_size == 0 else (None, None)
    tok = _placed((batch, seq), torch.int32, ctx, spec)
    return {"tokens": tok, "labels": tok} if with_labels else {"tokens": tok}


def extra_specs(cfg: ModelConfig, ctx: MeshCtx, batch: int, seq: int
                ) -> Optional[Dict[str, Placed]]:
    """The cross-attention source of the audio family (``seq //
    enc_seq_ratio`` frames) and the VLM (``n_image_tokens``); ``None``
    for the others."""
    brow = ctx.dp_axes if batch % ctx.dp_size == 0 else None
    if cfg.family == "audio":
        return {"enc_frames": _placed(
            (batch, seq // cfg.enc_seq_ratio, cfg.d_model),
            cfg.activation_dtype, ctx, (brow, None, None))}
    if cfg.family == "vlm":
        return {"image_embeds": _placed(
            (batch, cfg.n_image_tokens, cfg.d_model), cfg.activation_dtype,
            ctx, (brow, None, None))}
    return None


def _cache_leaf_pspec(path: str, shape: Tuple[int, ...], cfg: ModelConfig,
                      ctx: MeshCtx, batch: int) -> tuple:
    """One cache leaf's partition spec, by its name and rank
    (``specs.py:68-113``).  The batch over the data axes when they divide
    it; otherwise (``long_500k``, B = 1) the cache's sequence over them
    (sequence-parallel decode).  Heads and widths follow the weights."""
    dp = ctx.dp_axes
    tp = ctx.tp_size
    b_ok = batch % ctx.dp_size == 0
    leaf = path.split(".")[-1]
    if leaf == "pos":
        return ()
    if leaf in ("k", "v"):                    # (G?, B, S, KV, hd)
        lead = (None,) * (len(shape) - 4)
        kvh = kvd = None
        if cfg.n_kv_heads % tp == 0 and cfg.n_heads % tp == 0:
            kvh = "model"
        elif cfg.n_heads % tp != 0 and cfg.head_dim_ % tp == 0:
            kvd = "model"
        if b_ok:
            return (*lead, dp, None, kvh, kvd)
        seq = shape[len(lead) + 1]
        sp = dp if seq % ctx.dp_size == 0 else None
        return (*lead, None, sp, kvh, kvd)
    if leaf == "conv":                        # (G?, B, K-1, C)
        lead = (None,) * (len(shape) - 3)
        cax = "model" if shape[-1] % tp == 0 else None
        return (*lead, dp if b_ok else None, None, cax)
    if leaf == "h":                  # mamba (G?, B, di, N) / rglru (G?, B, W)
        if shape[-1] == cfg.ssm_state and cfg.family == "ssm":
            lead = (None,) * (len(shape) - 3)
            return (*lead, dp if b_ok else None,
                    "model" if shape[-2] % tp == 0 else None, None)
        lead = (None,) * (len(shape) - 2)
        return (*lead, dp if b_ok else None,
                "model" if shape[-1] % tp == 0 else None)
    return (None,) * len(shape)


def _map_cache(tree: Any, fn, prefix: str = "") -> Any:
    if isinstance(tree, dict):
        return {k: _map_cache(v, fn, f"{prefix}.{k}" if prefix else k)
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_cache(v, fn, f"{prefix}.{i}") for i, v in
                enumerate(tree)]
    return fn(prefix, tree)


def cache_specs(model: Model, batch: int, cache_len: int,
                extra_len: int = 0) -> Dict[str, Any]:
    """``model.init_cache``'s tree (``model`` on the ``meta`` device), each
    leaf a :class:`Placed`; the position ``pos`` an int32 scalar, as the
    reference holds it."""
    cfg, ctx = model.cfg, model.ctx
    cache = model.init_cache(batch, cache_len, extra_len)

    def one(path, leaf):
        if not isinstance(leaf, torch.Tensor):
            leaf = torch.empty((), dtype=torch.int32, device="meta")
        ps = _cache_leaf_pspec(path, tuple(leaf.shape), cfg, ctx, batch)
        return _placed(tuple(leaf.shape), leaf.dtype, ctx, ps)

    return _map_cache(cache, one)


def _flatten_key(name: str) -> tuple:
    """A dotted name's place in ``jax.tree.flatten``'s order: dict keys
    sorted, list entries in order."""
    return tuple(int(c) if c.isdigit() else c for c in name.split("."))


def opt_state_specs(opt_init, model: Model):
    """The optimizer state of ``opt_init`` over ``model``'s abstract
    parameters (on ``meta``), each leaf a :class:`Placed` whose spec comes
    from the parameters' by the reference's rule (``specs.py:131-165``): a
    leaf of a parameter's (stacked) shape takes the spec of the first such
    parameter in ``jax.tree.flatten``'s order; else the first parameter one
    rank above it whose shape less its last dimension (a row factor) or
    less its second-to-last (a column factor) is the leaf's, less that
    dimension's entry; else replicated."""
    ctx = model.ctx
    pspecs = shlib.param_pspecs(model.param_specs(), ctx)
    params = model.abstract()
    stacked = []
    for leaf in leaves(params):
        ps = pspecs[leaf.parts[0][0]]
        stacked.append((leaf.name, leaf.shape,
                        ((None,) + ps) if leaf.stacked else ps))
    by_shape: Dict[Tuple[int, ...], tuple] = {}
    for _, shape, ps in sorted(stacked, key=lambda e: _flatten_key(e[0])):
        by_shape.setdefault(shape, ps)

    def one(t: torch.Tensor) -> Placed:
        shape = tuple(t.shape)
        ps = by_shape.get(shape)
        if ps is None:
            for pshape, cand in by_shape.items():
                if len(pshape) == len(shape) + 1:
                    if pshape[:-1] == shape:                  # row factor
                        ps = cand[:-1] if cand else None
                        break
                    if pshape[:-2] + pshape[-1:] == shape:    # col factor
                        ps = (cand[:-2] + cand[-1:]) if cand else None
                        break
        return _placed(shape, t.dtype, ctx, () if ps is None else ps)

    state = opt_init(params)
    return type(state)(*(
        {name: one(t) for name, t in f.items()} if isinstance(f, dict)
        else one(f) for f in state))
