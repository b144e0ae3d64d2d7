"""Carry state from the JAX package into the port.

Each function takes the reference's objects — or anything with the same
fields holding array-likes (``numpy.asarray`` is applied to every field) —
and builds the port's counterpart on ``device``.  This is what lets both
packages compute on the same numbers; it imports neither ``jax`` nor
``repro``.
"""
from __future__ import annotations

import numpy as np
import torch

from .core.folds import FoldData
from .core.packing import PackedFactor
from .core.picholesky import PiCholesky
from .optim.gauss_newton import GNState

__all__ = ["folds_from_numpy", "picholesky_from_numpy",
           "packed_factor_from_numpy", "gn_state_from_numpy"]


def _tensor(a, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def folds_from_numpy(folds, device="cpu") -> FoldData:
    """A reference ``FoldData`` (hess, grad, fold_hess, fold_grad, x_folds,
    y_folds) as the port's."""
    return FoldData(*(_tensor(getattr(folds, name), device)
                      for name in ("hess", "grad", "fold_hess", "fold_grad",
                                   "x_folds", "y_folds")))


def picholesky_from_numpy(model, device="cpu") -> PiCholesky:
    """A fitted reference ``PiCholesky`` (theta, center, h, block)."""
    return PiCholesky(theta=_tensor(model.theta, device),
                      center=_tensor(model.center, device),
                      h=int(model.h), block=int(model.block))


def packed_factor_from_numpy(pf, device="cpu") -> PackedFactor:
    """A reference ``PackedFactor`` (vec, h, block)."""
    return PackedFactor(_tensor(pf.vec, device), int(pf.h),
                        int(pf.block))


def gn_state_from_numpy(state, device="cpu") -> GNState:
    """A reference Gauss–Newton ``GNState`` (model, lam, lo, hi)."""
    return GNState(model=picholesky_from_numpy(state.model, device),
                   lam=_tensor(state.lam, device), lo=_tensor(state.lo, device),
                   hi=_tensor(state.hi, device))
