"""Carry state from the JAX package into the port.

Each function takes the reference's objects — or anything with the same
fields holding array-likes (``numpy.asarray`` is applied to every field) —
and builds the port's counterpart on ``device``: ``None`` means the CUDA
device, as for every entry point (``RuntimeError`` without one); pass
``device="cpu"`` for the CPU.  This is what lets both packages compute on
the same numbers; it imports neither ``jax`` nor ``repro``.
"""
from __future__ import annotations

import numpy as np
import torch

from ._device import resolve_device
from .core.folds import FoldData
from .core.packing import PackedFactor
from .core.picholesky import PiCholesky
from .models.config import ModelConfig
from .models.model import Model, stack_sizes
from .models.params import flatten
from .optim.adafactor import AdafactorState
from .optim.adamw import AdamWState
from .optim.gauss_newton import GNState

__all__ = ["folds_from_numpy", "picholesky_from_numpy",
           "packed_factor_from_numpy", "gn_state_from_numpy",
           "params_from_numpy", "model_from_numpy", "opt_state_from_numpy"]


def _tensor(a, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True)).to(
        resolve_device(device))


def folds_from_numpy(folds, device=None) -> FoldData:
    """A reference ``FoldData`` (hess, grad, fold_hess, fold_grad, x_folds,
    y_folds) as the port's."""
    return FoldData(*(_tensor(getattr(folds, name), device)
                      for name in ("hess", "grad", "fold_hess", "fold_grad",
                                   "x_folds", "y_folds")))


def picholesky_from_numpy(model, device=None) -> PiCholesky:
    """A fitted reference ``PiCholesky`` (theta, center, h, block)."""
    return PiCholesky(theta=_tensor(model.theta, device),
                      center=_tensor(model.center, device),
                      h=int(model.h), block=int(model.block))


def packed_factor_from_numpy(pf, device=None) -> PackedFactor:
    """A reference ``PackedFactor`` (vec, h, block)."""
    return PackedFactor(_tensor(pf.vec, device), int(pf.h),
                        int(pf.block))


def gn_state_from_numpy(state, device=None) -> GNState:
    """A reference Gauss–Newton ``GNState`` (model, lam, lo, hi)."""
    return GNState(model=picholesky_from_numpy(state.model, device),
                   lam=_tensor(state.lam, device), lo=_tensor(state.lo, device),
                   hi=_tensor(state.hi, device))


def params_from_numpy(cfg: ModelConfig, params, device=None
                      ) -> dict:
    """A reference ``Model(cfg)`` tree (nested dicts of arrays: parameters,
    or gradients of the same shapes) by the port's dotted names: the
    leading group axis of ``groups`` (and of the hybrid's ``tail``)
    unstacked (``groups.mamba.wx`` (L, d, di) becomes ``groups.<i>.mamba.
    wx`` (d, di), ``groups.rnn.0.mix.wx`` (G, d, W) ``groups.<i>.rnn.0.
    mix.wx``, ``groups.moe.shared.wi`` ``groups.<i>.moe.shared.wi``),
    every leaf keeping its values."""
    dev = resolve_device(device)
    sizes = stack_sizes(cfg)
    flat = {}
    for name, leaf in flatten(params):
        head, _, rest = name.partition(".")
        if head in sizes:
            stacked = np.asarray(leaf)
            if stacked.shape[0] != sizes[head]:
                raise ValueError(f"{name}: {stacked.shape[0]} entries, the "
                                 f"configuration has {sizes[head]}")
            for i in range(sizes[head]):
                flat[f"{head}.{i}.{rest}"] = _tensor(stacked[i], dev)
        else:
            flat[name] = _tensor(leaf, dev)
    return flat


def model_from_numpy(cfg: ModelConfig, params, device=None,
                     scan: str = "auto", ctx=None) -> Model:
    """A reference ``Model(cfg, ctx).init`` tree (nested dicts of arrays)
    as the port's :class:`~repro_torch.models.Model` over the same mesh
    (``ctx``, a :class:`~repro_torch.distributed.context.MeshCtx`: its
    padded ``wq``, ``wo`` and ``bq`` included), whose parameters are
    :func:`params_from_numpy`'s; ``device=None`` is the mesh's first
    device under a mesh.  The model is what a train step takes as its
    ``params``."""
    if device is None and ctx is not None and ctx.mesh is not None:
        device = ctx.mesh.flat[0]
    dev = resolve_device(device)
    return Model(cfg, ctx, device=dev, scan=scan,
                 params=params_from_numpy(cfg, params, dev))


def opt_state_from_numpy(state, device=None):
    """A reference ``AdamWState(step, mu, nu)`` or ``AdafactorState(step,
    vr, vc)`` (fields of array-likes, the trees nested dicts) as the
    port's, which keeps the reference's layout: each tree by the
    reference's dotted leaf names, the layer axis first."""
    fields = getattr(type(state), "_fields", ())
    kinds = {("step", "mu", "nu"): AdamWState,
             ("step", "vr", "vc"): AdafactorState}
    if tuple(fields) not in kinds:
        raise TypeError(f"not an AdamW or Adafactor state: fields {fields}")
    dev = resolve_device(device)
    step = torch.as_tensor(np.array(state.step), dtype=torch.int32,
                           device=dev)
    trees = [{name: _tensor(leaf, dev) for name, leaf in
              flatten(getattr(state, f))} for f in fields[1:]]
    return kinds[tuple(fields)](step, *trees)
