"""Host-loop CV drivers: the reference implementations the engine is held
to, on the paper's dense-factor route.

The folds run as a Python loop, one fold at a time, with the λ grid
batched inside each fold — an execution structure independent of the
batched :class:`~repro_torch.core.engine.CVEngine` (folds as a batch
dimension, λ chunks streamed through the fused interpolant solve), which is
what makes these drivers its oracle:

* ``host_cv_exact_cholesky`` factorizes every (fold, λ) and substitutes;
* ``host_cv_picholesky`` runs Algorithm 1 as the paper writes it: fit Θ,
  evaluate the dense interpolated factors L(λ) (``eval_factor``), then
  forward and back substitution on each;
* ``host_cv_pinrmse`` interpolates the hold-out curve itself from g exact
  evaluations (the §6.5 straw-man);
* ``host_cv_svd`` runs the SVD family on each fold's raw training rows
  (the other folds in ascending order).

The Cholesky drivers take ``backend=`` (``'auto'``: the CUDA kernels when
the folds lie on a CUDA device, ``torch.linalg`` on the CPU).
"""
from __future__ import annotations

import torch

from . import picholesky, solvers
from .backends import BackendLike, resolve_backend
from .folds import CVResult, FoldData, holdout_nrmse

__all__ = ["host_cv_exact_cholesky", "host_cv_picholesky", "host_cv_pinrmse",
           "host_cv_svd"]


def _fold_train_stats(folds: FoldData, f: int):
    return folds.hess - folds.fold_hess[f], folds.grad - folds.fold_grad[f]


def _fold_errors(folds: FoldData, f: int, thetas: torch.Tensor):
    """thetas (q, h) → the (q,) hold-out curve of fold f."""
    return holdout_nrmse(thetas, folds.x_folds[f], folds.y_folds[f])


def _grid(folds: FoldData, lams) -> torch.Tensor:
    return picholesky.lam_tensor(lams, folds.device).reshape(-1)


def host_cv_exact_cholesky(folds: FoldData, lams, *,
                           backend: BackendLike = "auto") -> CVResult:
    """Chol baseline: k·q exact factorizations, one fold at a time."""
    bk = resolve_backend(backend, device=folds.device)
    lams = _grid(folds, lams)
    k = folds.fold_hess.shape[0]
    errs = []
    for f in range(k):
        h_tr, g_tr = _fold_train_stats(folds, f)
        thetas = solvers.solve_cholesky_sweep(h_tr, g_tr, lams, backend=bk)
        errs.append(_fold_errors(folds, f, thetas))
    curve = torch.stack(errs).mean(0)
    return CVResult.from_errors(lams.cpu().numpy(), curve.cpu().numpy(),
                                k * lams.shape[0])


def host_cv_picholesky(folds: FoldData, lams, g: int = 4, degree: int = 2, *,
                       block: int = 128, basis: str = "monomial",
                       backend: BackendLike = "auto") -> CVResult:
    """piCholesky CV: k·g exact factorizations + interpolation for the
    rest, through the dense interpolated factors."""
    bk = resolve_backend(backend, device=folds.device)
    lams = _grid(folds, lams)
    k = folds.fold_hess.shape[0]
    sample = picholesky.choose_sample_lambdas(
        float(lams[0]), float(lams[-1]), g, device=folds.device)
    errs = []
    for f in range(k):
        h_tr, g_tr = _fold_train_stats(folds, f)
        model = picholesky.fit(h_tr, sample, degree, block=block, basis=basis,
                               backend=bk)
        l_interp = model.eval_factor(lams, backend=bk)          # (q, h, h)
        thetas = solvers.solve_from_factor(
            l_interp, g_tr.expand(lams.shape[0], -1), bk)       # (q, h)
        errs.append(_fold_errors(folds, f, thetas))
    curve = torch.stack(errs).mean(0)
    return CVResult.from_errors(lams.cpu().numpy(), curve.cpu().numpy(),
                                k * g, sample_lams=sample.cpu().numpy())


def host_cv_pinrmse(folds: FoldData, lams, g: int = 4, degree: int = 2, *,
                    backend: BackendLike = "auto") -> CVResult:
    """PINRMSE straw-man (§6.5): interpolate the hold-out-error curve itself
    from g exact evaluations — shown by the paper to select wrong λs.  The
    polynomial fit runs at the curve's dtype."""
    lams = _grid(folds, lams)
    sample = picholesky.choose_sample_lambdas(
        float(lams[0]), float(lams[-1]), g, device=folds.device)
    exact = host_cv_exact_cholesky(folds, sample, backend=backend)
    t = torch.as_tensor(exact.errors, device=folds.device)
    v = picholesky.vandermonde(sample, degree).to(t.dtype)
    theta = torch.linalg.solve(v.T @ v, v.T @ t)
    errs = picholesky.vandermonde(lams, degree).to(t.dtype) @ theta
    k = folds.fold_hess.shape[0]
    return CVResult.from_errors(lams.cpu().numpy(), errs.cpu().numpy(), k * g,
                                sample_lams=sample.cpu().numpy())


def host_cv_svd(folds: FoldData, lams, mode: str = "full", k_trunc: int = 0,
                omega=None) -> CVResult:
    """SVD / t-SVD / r-SVD baselines on the raw design matrix, one fold at
    a time.  ``mode='randomized'`` projects every fold with one Gaussian
    test matrix: ``omega`` (h, k_trunc + 10), by default drawn from a
    generator seeded 0."""
    lams = _grid(folds, lams)
    k, n_f, h = folds.x_folds.shape
    errs = []
    for f in range(k):
        others = [i for i in range(k) if i != f]
        x_tr = folds.x_folds[others].reshape((k - 1) * n_f, h)
        y_tr = folds.y_folds[others].reshape(-1)
        factors = solvers.svd_ridge_factors(x_tr, y_tr, mode, k_trunc,
                                            omega=omega)
        errs.append(_fold_errors(folds, f,
                                 solvers.svd_ridge_sweep(factors, lams)))
    curve = torch.stack(errs).mean(0)
    return CVResult.from_errors(lams.cpu().numpy(), curve.cpu().numpy(), 0)
