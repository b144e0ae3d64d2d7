"""Step builders (``src/repro/train/steps.py``).

``make_train_step``: loss → gradients (with optional microbatch
accumulation and int8 error-feedback compression) → optimizer update.  The
port's model owns its weights, so ``params`` is the model; the optimizer
updates them in place and the step returns the same object, as the
reference returns its donated tree's successor.

``make_serve_steps``: the (prefill, decode) pair.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.nn as nn

from repro_torch.distributed import compression
from repro_torch.models.model import Model

__all__ = ["make_train_step", "make_serve_steps"]


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
            loss, metrics = net.loss(batch, extra)
            grads = dict(zip(named, torch.autograd.grad(loss, leaves)))
            loss = loss.detach()
            metrics = {k: v.detach() for k, v in metrics.items()}
        else:
            acc = {n: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device) for n, p in named.items()}
            loss = torch.zeros((), dtype=torch.float32,
                               device=leaves[0].device)
            for i in range(microbatches):
                lm, _ = net.loss(_split(batch, i, microbatches),
                                 _split(extra, i, microbatches))
                for a, g in zip(acc.values(),
                                torch.autograd.grad(lm, leaves)):
                    a.add_(g.float())
                loss = loss + lm.detach()
            grads = {n: a.div_(microbatches) for n, a in acc.items()}
            loss = loss / microbatches
            metrics = {"nll": loss,
                       "aux": torch.zeros((), dtype=torch.float32,
                                          device=loss.device)}
        if compress_grads:
            inner, residual = opt_state
            grads, residual = compression.ef_compress_tree(grads, residual)
        grad_norm = torch.sqrt(sum(g.float().square().sum()
                                   for g in grads.values()))
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
