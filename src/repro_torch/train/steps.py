"""Step builders (``src/repro/train/steps.py``).

``make_train_step``: loss → gradients (with optional microbatch
accumulation and int8 error-feedback compression) → optimizer update.  The
port's model owns its weights, so ``params`` is the model; the optimizer
updates them in place and the step returns the same object, as the
reference returns its donated tree's successor.

``make_serve_steps``: the (prefill, decode) pair.

On a mesh over a world of ranks every rank runs the step on its blocks.
It takes the whole batch, of which the model keeps its rows (when the data
axes divide them), and its loss is the whole batch's.  The gradient is the
SPMD program's: each rank differentiates ``loss / world size`` through
the collectives' transposes (:mod:`repro_torch.distributed.collectives`),
then sums each leaf's gradient over the axes the leaf is replicated over
(an FSDP leaf arrives reduce-scattered over its FSDP axis through its
gather's backward).  ``grad_norm`` counts each distinct block once.  With
``compress_grads`` a block is quantized with its whole leaf's scale (its
max |·| taken over the ranks holding the leaf's other blocks), so every
rank computes what one process computes on the whole gradient.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.nn as nn

from repro_torch.distributed import collectives as coll
from repro_torch.distributed import compression
from repro_torch.distributed.sharding import _axes
from repro_torch.models.model import Model

__all__ = ["make_train_step", "make_serve_steps", "loss_and_grads"]


def _bind(model: Model, params) -> Model:
    """The model whose weights ``params`` are: the port's models own their
    weights, so ``params`` is a model (``model`` itself, or another one of
    its architecture, such as ``convert.model_from_numpy``'s output)."""
    if not isinstance(params, nn.Module):
        raise TypeError(f"params must be the model (the port's models own "
                        f"their weights), got {type(params).__name__}")
    return params


def _split(tree: Optional[Dict], i: int, n: int) -> Optional[Dict]:
    """Microbatch ``i`` of ``n``: rows [i·B/n, (i+1)·B/n) of every leaf, as
    the reference's ``reshape(n, B // n, …)`` splits them."""
    if tree is None:
        return None
    out = {}
    for key, x in tree.items():
        x = torch.as_tensor(x)
        if x.shape[0] % n:
            raise ValueError(f"{key}: batch {x.shape[0]} is not a multiple "
                             f"of microbatches={n}")
        m = x.shape[0] // n
        out[key] = x[i * m:(i + 1) * m]
    return out


def _leaf_axes(net: Model) -> Dict[str, Tuple[Tuple[str, ...],
                                              Tuple[str, ...]]]:
    """Per parameter on a rank mesh: (the mesh axes its blocks split
    over, the axes it is replicated over)."""
    mesh = net.ctx.mesh
    out = {}
    for name, sh in net.param_shardings().items():
        split = {a for e in sh.spec for a in _axes(e)}
        out[name] = (tuple(a for a in mesh.axis_names if a in split),
                     tuple(a for a in mesh.axis_names if a not in split))
    return out


def _raw_grads(net: Model, loss: torch.Tensor, named: Dict) -> Dict:
    """The gradient of ``loss`` by parameter name; on a rank mesh of
    ``loss / world size`` through the collectives (not yet summed over
    replicated axes)."""
    seed = None
    if net.ctx.ranks:
        seed = torch.full_like(loss, 1.0 / net.ctx.world.size)
    return dict(zip(named, torch.autograd.grad(loss, list(named.values()),
                                               grad_outputs=seed)))


@torch.no_grad()
def _reduce(net: Model, grads: Dict) -> Dict:
    """On a rank mesh, each leaf's gradient summed over the axes it is
    replicated over: every rank then holds its block of the gradient."""
    if not net.ctx.ranks:
        return grads
    w = net.ctx.world
    axes = _leaf_axes(net)
    return {n: coll.psum(g, axes[n][1], w) if axes[n][1] else g
            for n, g in grads.items()}


def loss_and_grads(net: Model, batch: Dict, extra: Optional[Dict] = None):
    """(loss, metrics, gradients by parameter name) of one batch, the
    gradients reduced as the train step takes them (on a rank mesh this
    rank's blocks of the whole batch's gradient)."""
    named = dict(net.named_parameters())
    loss, metrics = net.loss(batch, extra)
    grads = _reduce(net, _raw_grads(net, loss, named))
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads


def _grad_norm(net: Model, grads: Dict) -> torch.Tensor:
    """The float32 root of the summed squares; on a rank mesh each
    distinct block counted once (a replicated leaf's square sum divided by
    its copies, then summed over the world)."""
    if not net.ctx.ranks:
        return torch.sqrt(sum(g.float().square().sum()
                              for g in grads.values()))
    ctx, axes = net.ctx, _leaf_axes(net)
    sq = sum(g.float().square().sum()
             / math.prod(ctx.axis_size(a) for a in axes[n][1])
             for n, g in grads.items())
    return torch.sqrt(coll.psum(sq, ctx.mesh.axis_names, ctx.world))


def make_train_step(model: Model, optimizer: Tuple[Callable, Callable], *,
                    microbatches: int = 1,
                    compress_grads: bool = False) -> Callable:
    """Returns ``train_step(params, opt_state, batch, extra=None) ->
    (params, opt_state, metrics)``.

    ``microbatches`` splits the batch and accumulates the gradients in
    float32 buffers, then divides (the reference's float32 ``g0``,
    ``steps.py:64-70``; the gradients of one microbatch come in the
    parameters' dtype).  ``compress_grads``: ``opt_state`` is ``(inner,
    residual)``, the residual float32 zeros of every parameter at first
    (``optim._tree.zeros_like_tree``); the gradient goes through
    ``ef_compress_tree`` before the optimizer.  ``metrics``: ``loss``,
    ``nll``, ``aux`` and ``grad_norm`` (the float32 root of the summed
    squares), 0-d tensors on the device.
    """
    _, opt_update = optimizer
    if microbatches < 1:
        raise ValueError(f"microbatches must be >= 1, got {microbatches}")

    def train_step(params, opt_state, batch: Dict,
                   extra: Optional[Dict] = None):
        net = _bind(model, params)
        named = dict(net.named_parameters())
        leaves = list(named.values())
        if microbatches == 1:
            loss, metrics, grads = loss_and_grads(net, batch, extra)
        else:
            acc = {n: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device) for n, p in named.items()}
            loss = torch.zeros((), dtype=torch.float32,
                               device=leaves[0].device)
            for i in range(microbatches):
                lm, _ = net.loss(_split(batch, i, microbatches),
                                 _split(extra, i, microbatches))
                for a, g in zip(acc.values(),
                                _raw_grads(net, lm, named).values()):
                    a.add_(g.float())
                loss = loss + lm.detach()
            grads = _reduce(net, {n: a.div_(microbatches)
                                  for n, a in acc.items()})
            loss = loss / microbatches
            metrics = {"nll": loss,
                       "aux": torch.zeros((), dtype=torch.float32,
                                          device=loss.device)}
        if compress_grads:
            inner, residual = opt_state
            amax_of = None
            if net.ctx.ranks:
                split = {n: a[0] for n, a in _leaf_axes(net).items()}
                amax_of = lambda n, m: coll.pmax(m, split[n], net.ctx.world) \
                    if split[n] else m
            grads, residual = compression.ef_compress_tree(grads, residual,
                                                           amax_of)
        grad_norm = _grad_norm(net, grads)
        if compress_grads:
            params, inner = opt_update(grads, inner, params)
            new_opt: Any = (inner, residual)
        else:
            params, new_opt = opt_update(grads, opt_state, params)
        metrics = dict(metrics, loss=loss, grad_norm=grad_norm)
        return params, new_opt, metrics

    return train_step


def make_serve_steps(model: Model):
    """``(prefill_step, decode_step)``: ``prefill_step(params, tokens,
    extra=None, cache_len=None)`` and ``decode_step(params, cache,
    tokens)``, ``params`` as :func:`make_train_step` takes it."""

    def prefill_step(params, tokens, extra=None, cache_len=None):
        return _bind(model, params).prefill(tokens)

    def decode_step(params, cache, tokens):
        return _bind(model, params).decode(cache, tokens)

    return prefill_step, decode_step
