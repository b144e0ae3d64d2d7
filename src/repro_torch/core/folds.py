"""Shared CV data types: fold statistics, hold-out metric, result record.

The fold trick: with ``H_f = X_fᵀX_f`` per fold, the training Hessian of
fold f is ``H − H_f`` (one pass over the data).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .._device import resolve_device

__all__ = ["FoldData", "make_folds", "holdout_nrmse", "CVResult"]


@dataclasses.dataclass(frozen=True)
class FoldData:
    """Per-fold sufficient statistics + raw held-out blocks."""
    hess: torch.Tensor        # (h, h) total XᵀX
    grad: torch.Tensor        # (h,)   total Xᵀy
    fold_hess: torch.Tensor   # (k, h, h)
    fold_grad: torch.Tensor   # (k, h)
    x_folds: torch.Tensor     # (k, n_f, h)
    y_folds: torch.Tensor     # (k, n_f)

    def to(self, device) -> "FoldData":
        return FoldData(*(getattr(self, f.name).to(device)
                          for f in dataclasses.fields(self)))

    @property
    def device(self) -> torch.device:
        return self.hess.device


def make_folds(x, y, k: int, *, device=None) -> FoldData:
    """Split (n, h) design and (n,) labels into k contiguous folds (the
    remainder rows are dropped) on ``device`` (``None``: the CUDA device)."""
    dev = resolve_device(device)
    x = torch.as_tensor(x, device=dev)
    y = torch.as_tensor(y, device=dev)
    n_f = x.shape[0] // k
    x = x[: n_f * k].reshape(k, n_f, -1)
    y = y[: n_f * k].reshape(k, n_f)
    fold_hess = torch.einsum("kni,knj->kij", x, x)
    fold_grad = torch.einsum("kni,kn->ki", x, y)
    return FoldData(fold_hess.sum(0), fold_grad.sum(0), fold_hess, fold_grad,
                    x, y)


def holdout_nrmse(theta: torch.Tensor, x_hold: torch.Tensor,
                  y_hold: torch.Tensor) -> torch.Tensor:
    """Normalized RMSE on held-out rows: theta (…, h), x_hold (…, n_f, h),
    y_hold (…, n_f), leading dims broadcast.  The normalizer is the
    population standard deviation (``correction=0``).  θ and the rows are
    promoted to one dtype (float32 solutions of a mixed policy on float64
    data score at float64), as ``jnp`` promotes."""
    dt = torch.promote_types(theta.dtype, x_hold.dtype)
    pred = (x_hold.to(dt) @ theta.to(dt)[..., None])[..., 0]
    mse = torch.mean((pred - y_hold) ** 2, dim=-1)
    denom = torch.std(y_hold, dim=-1, correction=0) + 1e-30
    return torch.sqrt(mse) / denom


@dataclasses.dataclass
class CVResult:
    lams: np.ndarray           # dense candidate grid
    errors: np.ndarray         # (q,) mean hold-out error across folds
    best_lam: float
    best_error: float
    n_exact_chol: int          # factorizations actually performed
    extras: dict = dataclasses.field(default_factory=dict)

    @staticmethod
    def from_errors(lams, errors, n_exact, **extras) -> "CVResult":
        """Rank a hold-out curve.  The argmin runs over the finite entries;
        an empty curve raises ``ValueError`` and a curve with no finite
        value raises ``FloatingPointError``."""
        lams = np.asarray(lams)
        errors = np.asarray(errors)
        if errors.size == 0:
            raise ValueError("cannot rank an empty hold-out curve "
                             "(no λ was evaluated)")
        finite = np.isfinite(errors)
        if not finite.any():
            raise FloatingPointError(
                "hold-out curve has no finite value: every λ produced a "
                "non-finite mean error (singular fold? overflow → try "
                "precision='fp64'); refusing to rank a curve that cannot be "
                "compared")
        i = int(np.flatnonzero(finite)[np.argmin(errors[finite])])
        return CVResult(lams, errors, float(lams[i]), float(errors[i]),
                        n_exact, dict(extras))
