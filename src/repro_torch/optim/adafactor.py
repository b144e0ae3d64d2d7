"""Adafactor (factored second moment, no first moment) as an
``(init, update)`` pair (``src/repro/optim/adafactor.py``).

The rule depends on a leaf's shape: a leaf of two or more axes keeps row
and column factors of its second moment, and each leaf's update is clipped
by its own RMS.  So the state and the rule follow the reference's leaves
(:mod:`._tree`): a layer leaf is the stack of the port's per-layer tensors,
the layer axis first; a per-layer vector (a norm scale, ``dt_bias``) is
therefore factored over (layer, channel) as in the reference, and the
clipping RMS is taken over all layers of a leaf.  Per-leaf float32 maths;
``update`` works in place under ``no_grad`` (parameters and factors), one
layer at a time, forming a layer's update twice (for the leaf's RMS, then
to apply it) rather than holding a whole stack of updates.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Tuple

import torch

from ._tree import leaves, named_tensors

__all__ = ["AdafactorState", "adafactor"]


class AdafactorState(NamedTuple):
    step: torch.Tensor            # () int32
    vr: Dict[str, torch.Tensor]   # row factors (or the full v of a vector)
    vc: Dict[str, torch.Tensor]   # column factors (or a (1,) zero)


def _factored_u(gf, vr, vc, vr_mean, eps):
    denom = (vr[..., None] / vr_mean[..., None]) * vc[..., None, :]
    return gf * torch.rsqrt(denom + eps)


def _refuse_ranks(params) -> None:
    """Adafactor's factored statistics and its clip span the whole leaf:
    on a mesh over a world of ranks, where a rank holds a block, it is
    ROADMAP queue 1 item 8c."""
    ctx = getattr(params, "ctx", None)
    if ctx is not None and ctx.ranks:
        raise NotImplementedError(
            "Adafactor on a mesh of ranks: its factored statistics span "
            "whole leaves (ROADMAP queue 1 item 8c)")


def adafactor(lr: float = 1e-3, decay: float = 0.8, eps: float = 1e-30,
              clip_threshold: float = 1.0, weight_decay: float = 0.0):
    def init(params) -> AdafactorState:
        _refuse_ranks(params)
        ls = leaves(named_tensors(params))
        dev = ls[0].parts[0][1].device
        vr, vc = {}, {}
        for leaf in ls:
            shape = leaf.shape
            if len(shape) >= 2:
                vr[leaf.name] = torch.zeros(shape[:-1], device=dev)
                vc[leaf.name] = torch.zeros(shape[:-2] + shape[-1:],
                                            device=dev)
            else:
                vr[leaf.name] = torch.zeros(shape, device=dev)
                vc[leaf.name] = torch.zeros((1,), device=dev)
        return AdafactorState(torch.zeros((), dtype=torch.int32, device=dev),
                              vr, vc)

    @torch.no_grad()
    def update(grads: Dict[str, torch.Tensor], state: AdafactorState,
               params) -> Tuple[Any, AdafactorState]:
        """``grads`` by the port's parameter names; returns (params, the
        new state), both updated in place."""
        _refuse_ranks(params)
        step = state.step + 1
        beta = 1.0 - step.float() ** (-decay)

        def apply(p, u, scale):
            p32 = p.float()
            p.copy_(p32 - lr * (u / scale + weight_decay * p32))

        for leaf in leaves(named_tensors(params)):
            vr, vc = state.vr[leaf.name], state.vc[leaf.name]
            parts = [(p, grads[name]) for name, p in leaf.parts]
            if not leaf.stacked:
                (p, g), = parts
                gf = g.float()
                g2 = gf * gf + eps
                if len(leaf.shape) >= 2:
                    vr.mul_(beta).add_((1 - beta) * g2.mean(-1))
                    vc.mul_(beta).add_((1 - beta) * g2.mean(-2))
                    u = _factored_u(gf, vr, vc, vr.mean(-1, keepdim=True),
                                    eps)
                else:
                    vr.mul_(beta).add_((1 - beta) * g2)
                    u = gf * torch.rsqrt(vr + eps)
                rms = torch.sqrt((u * u).mean() + eps)
                apply(p, u, torch.clamp(rms / clip_threshold, min=1.0))
                continue
            # a stack of layers: (L, *per-layer shape), factored
            vector = len(leaf.shape) == 2     # per-layer vectors
            if vector:
                # vr (L,): per layer; vc (C,): over the layers
                g2_sum = None
                for i, (p, g) in enumerate(parts):
                    gf = g.float()
                    g2 = gf * gf + eps
                    vr[i].mul_(beta).add_((1 - beta) * g2.mean())
                    g2_sum = g2 if g2_sum is None else g2_sum + g2
                vc.mul_(beta).add_((1 - beta) * (g2_sum / len(parts)))
                vr_mean = vr.mean(-1, keepdim=True)

                def u_of(i, g):
                    return _factored_u(g.float(), vr[i:i + 1], vc, vr_mean,
                                       eps)[0]
            else:
                for i, (p, g) in enumerate(parts):
                    gf = g.float()
                    g2 = gf * gf + eps
                    vr[i].mul_(beta).add_((1 - beta) * g2.mean(-1))
                    vc[i].mul_(beta).add_((1 - beta) * g2.mean(-2))

                def u_of(i, g):
                    return _factored_u(g.float(), vr[i], vc[i],
                                       vr[i].mean(-1, keepdim=True), eps)
            ssq = sum((u_of(i, g) ** 2).sum() for i, (_, g) in
                      enumerate(parts))
            n = sum(p.numel() for p, _ in parts)
            rms = torch.sqrt(ssq / n + eps)
            scale = torch.clamp(rms / clip_threshold, min=1.0)
            for i, (p, g) in enumerate(parts):
                apply(p, u_of(i, g), scale)
        return params, AdafactorState(step, state.vr, state.vc)

    return init, update
