"""AdamW as an ``(init, update)`` pair (``src/repro/optim/adamw.py``).

The state keeps the reference's layout (``AdamWState(step, mu, nu)``, one
moment tensor per reference leaf, the layer axis first; see
:mod:`._tree`), in ``state_dtype``; the maths is per leaf in float32, as
the reference's.  ``update`` works in place under ``no_grad``: the
parameters and the moments are overwritten and returned, so the card never
holds a second copy of the weights.  The step count stays on the device.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Tuple

import torch

from ._tree import leaves, named_tensors

__all__ = ["AdamWState", "adamw"]


class AdamWState(NamedTuple):
    step: torch.Tensor            # () int32
    mu: Dict[str, torch.Tensor]   # by the reference's leaf names
    nu: Dict[str, torch.Tensor]


def adamw(lr: float = 3e-4, b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8, weight_decay: float = 0.1,
          state_dtype: torch.dtype = torch.float32):
    def init(params) -> AdamWState:
        ls = leaves(named_tensors(params))
        dev = ls[0].parts[0][1].device

        def zeros():
            return {leaf.name: torch.zeros(leaf.shape, dtype=state_dtype,
                                           device=dev) for leaf in ls}

        return AdamWState(torch.zeros((), dtype=torch.int32, device=dev),
                          zeros(), zeros())

    @torch.no_grad()
    def update(grads: Dict[str, torch.Tensor], state: AdamWState,
               params) -> Tuple[Any, AdamWState]:
        """``grads`` by the port's parameter names; returns (params, the
        new state), both updated in place."""
        step = state.step + 1
        t = step.float()
        c1 = 1.0 - b1 ** t
        c2 = 1.0 - b2 ** t
        for leaf in leaves(named_tensors(params)):
            mu, nu = state.mu[leaf.name], state.nu[leaf.name]
            for i, (name, p) in enumerate(leaf.parts):
                m = mu[i] if leaf.stacked else mu
                v = nu[i] if leaf.stacked else nu
                gf = grads[name].float()
                m32, v32 = m.float(), v.float()
                m32.mul_(b1).add_(gf * (1 - b1))
                v32.mul_(b2).add_(gf * (1 - b2) * gf)
                u = (m32 / c1).div_((v32 / c2).sqrt_().add_(eps))
                p32 = p.float()
                u.add_(p32 * weight_decay)
                p.copy_(p32.sub_(u.mul_(lr)))
                m.copy_(m32)
                v.copy_(v32)
        return params, AdamWState(step, state.mu, state.nu)

    return init, update
