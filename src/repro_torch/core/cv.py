"""k-fold cross-validation drivers (§6): thin wrappers over
:class:`~repro_torch.core.engine.CVEngine`, one per paper algorithm —
``cv_exact_cholesky``, ``cv_picholesky``, ``cv_picholesky_warmstart``,
``cv_svd`` and ``cv_pinrmse`` — plus ``cv_multilevel_cholesky`` (MChol,
§6.2), a host-side search whose every level is one batched factorization
of the k folds.  ``device=None`` runs on the CUDA device;
``backend='auto'`` picks the CUDA kernels there and ``torch.linalg`` on
the CPU.  ``chol_fn=`` replaces the backend's factorization (it takes a
(…, h, h) batch); ``mesh=`` splits the engine's sweep over a folds × λ
mesh (``None``, ``'auto'`` or a CV ``Mesh``)."""
from __future__ import annotations

import numpy as np
import torch

from .._device import resolve_device
from . import picholesky, solvers
from .backends import BackendLike, resolve_backend
from .engine import CVEngine, make_strategy
from .folds import CVResult, FoldData, holdout_nrmse, make_folds

__all__ = ["FoldData", "make_folds", "holdout_nrmse", "CVResult",
           "cv_exact_cholesky", "cv_picholesky", "cv_picholesky_warmstart",
           "cv_multilevel_cholesky", "cv_svd", "cv_pinrmse"]


def _sample_lams(result: CVResult, g: int) -> np.ndarray:
    """The g sample shifts spanning the result's grid, as the drivers
    report them in ``extras['sample_lams']``."""
    lams = np.asarray(result.lams)
    return picholesky.choose_sample_lambdas(
        float(lams[0]), float(lams[-1]), g, device="cpu").numpy()


def cv_exact_cholesky(folds: FoldData, lams, chol_fn=None, *,
                      backend: BackendLike = "auto", precision=None,
                      device=None, mesh=None) -> CVResult:
    """Chol baseline: k·q exact factorizations."""
    eng = CVEngine(make_strategy("exact", chol_fn=chol_fn), backend=backend,
                   precision=precision, device=device, mesh=mesh)
    return eng.run(folds, lams)


def cv_picholesky(folds: FoldData, lams, g: int = 4, degree: int = 2, *,
                  block: int = 128, basis: str = "monomial", chol_fn=None,
                  backend: BackendLike = "auto", precision=None,
                  device=None, mesh=None) -> CVResult:
    """piCholesky CV: k·g exact factorizations + interpolation for the
    rest.  ``extras['sample_lams']`` holds the g sample shifts."""
    eng = CVEngine(make_strategy("picholesky", g=g, degree=degree,
                                 block=block, basis=basis, chol_fn=chol_fn),
                   backend=backend, block=block, precision=precision,
                   device=device, mesh=mesh)
    result = eng.run(folds, lams)
    result.extras["sample_lams"] = _sample_lams(result, g)
    return result


def cv_picholesky_warmstart(folds: FoldData, lams, g_first: int = 4,
                            g_rest: int = 2, degree: int = 2, *,
                            mu: float = 1e-6, block: int = 128, chol_fn=None,
                            backend: BackendLike = "auto", precision=None,
                            device=None, mesh=None) -> CVResult:
    """piCholesky with cross-fold warm-starting (§7): a fold-0 anchor fit
    (``g_first`` factorizations), then per fold a refit of the residual
    from ``g_rest`` factorizations with the scale-relative damping ``mu``
    (:class:`~repro_torch.core.engine.PiCholeskyWarmstart`).  Total
    factorizations g_first + k·g_rest; ``extras['sample_lams']`` holds the
    ``g_first`` anchor shifts."""
    eng = CVEngine(make_strategy("picholesky_warmstart", g_first=g_first,
                                 g_rest=g_rest, degree=degree, mu=mu,
                                 block=block, chol_fn=chol_fn),
                   backend=backend, block=block, precision=precision,
                   device=device, mesh=mesh)
    result = eng.run(folds, lams)
    result.extras["sample_lams"] = _sample_lams(result, g_first)
    return result


def cv_multilevel_cholesky(folds: FoldData, c: float, s: float = 1.5,
                           s0: float = 0.0025, chol_fn=None, *,
                           backend: BackendLike = "auto",
                           device=None) -> CVResult:
    """MChol (§6.2): binary search in log₁₀ λ with exact factorizations
    (``src/repro/core/cv.py:137``).

    From the range [10^(c−s), 10^(c+s)], each level evaluates the three
    shifts 10^(c−s), 10^c, 10^(c+s) (a λ already visited, keyed on its
    Python float, is not evaluated again), recenters on the argmin and
    halves s, while s > s0.  One evaluation factorizes the k folds' shifted
    Hessians in one batched call and costs k factorizations.  The result's
    grid is the visited λs in ascending order; ``extras['visited_lams']``
    keeps the order of the visits.
    """
    dev = resolve_device(device)
    folds = folds.to(dev)
    bk = resolve_backend(backend, device=dev)
    k = folds.fold_hess.shape[0]
    h_tr = folds.hess[None] - folds.fold_hess
    g_tr = folds.grad[None] - folds.fold_grad
    visited_lams, visited_errs, n_chol = [], [], 0

    def mean_err(lam: float) -> float:
        nonlocal n_chol
        theta = solvers.solve_cholesky(
            h_tr, g_tr, torch.tensor(lam, dtype=h_tr.dtype, device=dev),
            chol_fn, bk)
        n_chol += k
        return float(holdout_nrmse(theta, folds.x_folds,
                                   folds.y_folds).mean())

    cache: dict[float, float] = {}
    while s > s0:
        cands = [10.0 ** (c - s), 10.0 ** c, 10.0 ** (c + s)]
        errs = []
        for lam in cands:
            if lam not in cache:
                cache[lam] = mean_err(lam)
                visited_lams.append(lam)
                visited_errs.append(cache[lam])
            errs.append(cache[lam])
        c = float(np.log10(cands[int(np.argmin(errs))]))
        s /= 2.0
    order = np.argsort(visited_lams)
    return CVResult.from_errors(
        np.asarray(visited_lams)[order], np.asarray(visited_errs)[order],
        n_chol, visited_lams=list(visited_lams))


def cv_svd(folds: FoldData, lams, mode: str = "full", k_trunc: int = 0,
           omega=None, *, backend: BackendLike = "auto",
           device=None, mesh=None) -> CVResult:
    """SVD / t-SVD / r-SVD baselines on the raw design matrix;
    ``mode='randomized'`` projects with ``omega`` (h, k_trunc + 10), by
    default a Gaussian matrix drawn from a generator seeded 0."""
    eng = CVEngine(make_strategy("svd", mode=mode, k_trunc=k_trunc,
                                 omega=omega),
                   backend=backend, device=device, mesh=mesh)
    return eng.run(folds, lams)


def cv_pinrmse(folds: FoldData, lams, g: int = 4, degree: int = 2,
               chol_fn=None, *, backend: BackendLike = "auto",
               precision=None, device=None, mesh=None) -> CVResult:
    """PINRMSE straw-man (§6.5): interpolate the hold-out-error curve itself
    from g exact evaluations — shown by the paper to select wrong λs.
    ``extras['sample_lams']`` holds the g evaluated shifts."""
    eng = CVEngine(make_strategy("pinrmse", g=g, degree=degree,
                                 chol_fn=chol_fn),
                   backend=backend, precision=precision, device=device,
                   mesh=mesh)
    result = eng.run(folds, lams)
    result.extras["sample_lams"] = _sample_lams(result, g)
    return result
