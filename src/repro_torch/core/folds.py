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


def _pad2(a: torch.Tensor, dim: int) -> torch.Tensor:
    """``a`` with a zero slice appended along ``dim`` where it has one."""
    if a.shape[dim] > 1:
        return a
    return torch.cat([a, torch.zeros_like(a)], dim)


def _row_mean(a: torch.Tensor) -> torch.Tensor:
    """Mean over the last axis, each row summed alike whatever it is
    batched with.  On the card the rows (…, r, n) are the columns of one
    batched GEMM with a (2, n) ones matrix, padded to at least two
    batches and two columns: cuBLAS sums a column of a batched GEMM alike
    for any batch and column count from two up, where a gemv, a plain
    GEMM and the reduction kernel pick their summation order by the
    shape (``scripts/probe_holdout_batch.py``).  On the CPU it is
    ``torch.mean``, whose kernel sums every row alike, where the BLAS gemv
    does not (``torch.std``'s one-pass kernel neither)."""
    if not a.is_cuda:
        return torch.mean(a, dim=-1)
    n = a.shape[-1]
    b = a.reshape(-1, a.shape[-2] if a.ndim > 1 else 1, n)   # (B, r, n)
    nb, r = b.shape[:2]
    bt = _pad2(_pad2(b, 1), 0).mT
    ones = a.new_ones(bt.shape[0], 2, n)
    return ((ones @ bt)[:nb, 0, :r] / n).reshape(a.shape[:-1])


def _predict(theta: torch.Tensor, x_hold: torch.Tensor) -> torch.Tensor:
    """x_hold (…, n_f, h) · θ (…, h) → (…, n_f), each (fold, λ)'s rows
    summed alike whatever folds and λs are batched beside it.  On the
    card, for θ (…, c, h) against x_hold (…, 1, n_f, h) with the same
    leading dims (the engine's scores), one batched GEMM with a fold a
    batch and a λ a column, padded to at least two of each (see
    :func:`_row_mean`), laid out as :func:`_row_mean` reads it.  The GEMM
    also never materializes the broadcast (…, c, n_f, h) copy of the rows.
    On the CPU, and for other shapes, the broadcast product."""
    if x_hold.is_cuda and x_hold.ndim == theta.ndim + 1 \
            and x_hold.ndim >= 3 and x_hold.shape[-3] == 1 \
            and theta.shape[:-2] == x_hold.shape[:-3]:
        c, h = theta.shape[-2:]
        x = x_hold.squeeze(-3)
        xb = x.reshape(-1, *x.shape[-2:])                 # (B, n_f, h)
        tb = theta.reshape(-1, c, h)                      # (B, c, h)
        nb = xb.shape[0]
        out = (_pad2(xb, 0) @ _pad2(_pad2(tb, 1), 0).mT).mT[:nb, :c]
        return out.contiguous().reshape(*x.shape[:-2], c, x.shape[-2])
    return (x_hold @ theta[..., None])[..., 0]


def holdout_nrmse(theta: torch.Tensor, x_hold: torch.Tensor,
                  y_hold: torch.Tensor) -> torch.Tensor:
    """Normalized RMSE on held-out rows: theta (…, h), x_hold (…, n_f, h),
    y_hold (…, n_f), leading dims broadcast.  The normalizer is the
    population standard deviation, in two passes as ``jnp.std`` takes it.
    The predictions are :func:`_predict`'s and every mean is
    :func:`_row_mean`'s, so a (fold, λ)'s score does not depend on the
    folds and λs it is batched with: the λ chunk and the mesh's fold
    groups change no bit of the curve.  θ and the rows are promoted to one
    dtype (float32 solutions of a mixed policy on float64 data score at
    float64), as ``jnp`` promotes."""
    dt = torch.promote_types(theta.dtype, x_hold.dtype)
    pred = _predict(theta.to(dt), x_hold.to(dt))
    mse = _row_mean((pred - y_hold) ** 2)
    dev = y_hold - _row_mean(y_hold)[..., None]
    denom = torch.sqrt(_row_mean(dev * dev)) + 1e-30
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
