"""k-fold cross-validation drivers (§6): thin wrappers over
:class:`~repro_torch.core.engine.CVEngine`.  ``device=None`` runs on the
CUDA device; ``backend='auto'`` picks the CUDA kernels there and
``torch.linalg`` on the CPU."""
from __future__ import annotations

import numpy as np

from . import picholesky
from .backends import BackendLike
from .engine import CVEngine, make_strategy
from .folds import CVResult, FoldData, holdout_nrmse, make_folds

__all__ = ["FoldData", "make_folds", "holdout_nrmse", "CVResult",
           "cv_exact_cholesky", "cv_picholesky"]


def cv_exact_cholesky(folds: FoldData, lams, *, backend: BackendLike = "auto",
                      precision=None, device=None) -> CVResult:
    """Chol baseline: k·q exact factorizations."""
    eng = CVEngine(make_strategy("exact"), backend=backend,
                   precision=precision, device=device)
    return eng.run(folds, lams)


def cv_picholesky(folds: FoldData, lams, g: int = 4, degree: int = 2, *,
                  block: int = 128, basis: str = "monomial",
                  backend: BackendLike = "auto", precision=None,
                  device=None) -> CVResult:
    """piCholesky CV: k·g exact factorizations + interpolation for the
    rest.  ``extras['sample_lams']`` holds the g sample shifts."""
    eng = CVEngine(make_strategy("picholesky", g=g, degree=degree,
                                 block=block, basis=basis),
                   backend=backend, block=block, precision=precision,
                   device=device)
    result = eng.run(folds, lams)
    lams = np.asarray(result.lams)
    result.extras["sample_lams"] = picholesky.choose_sample_lambdas(
        float(lams[0]), float(lams[-1]), g, device="cpu").numpy()
    return result
