"""Core of the port: packing, precision, backends, piCholesky, solvers,
folds, the CV engine with every paper strategy (the sketched one over
:mod:`.sketch`), its warm-replay factor cache (:mod:`.factor_cache`),
staged sweep, λ search, interpolant selection and anchor advice
(:mod:`.bound`), its drivers (MChol among them), the host-loop drivers and
``RidgeCV``."""
from . import (backends, bound, cv, cv_host, engine, factor_cache,  # noqa
               folds, packing, picholesky, precision, ridge_cv, sketch,
               solvers)
from .backends import CountingBackend, resolve_backend, retile_backend
from .cv import cv_exact_cholesky, cv_multilevel_cholesky, cv_picholesky, \
    cv_picholesky_warmstart, cv_pinrmse, cv_svd
from .cv_host import host_cv_exact_cholesky, host_cv_picholesky, \
    host_cv_pinrmse, host_cv_svd
from .engine import CVEngine, SweepChunk, make_strategy
from .factor_cache import FactorCache
from .folds import CVResult, FoldData, holdout_nrmse, make_folds
from .picholesky import PiCholesky, fit as fit_picholesky, \
    select_interpolant
from .precision import PrecisionPolicy, resolve_precision
from .ridge_cv import RidgeCV

__all__ = ["CVEngine", "SweepChunk", "make_strategy", "FactorCache",
           "PiCholesky", "fit_picholesky", "PrecisionPolicy",
           "resolve_precision", "CVResult", "FoldData",
           "holdout_nrmse", "make_folds", "cv_exact_cholesky",
           "cv_picholesky", "cv_picholesky_warmstart",
           "cv_multilevel_cholesky", "cv_svd", "cv_pinrmse",
           "host_cv_exact_cholesky", "host_cv_picholesky", "host_cv_pinrmse",
           "host_cv_svd", "CountingBackend", "resolve_backend",
           "retile_backend", "select_interpolant", "RidgeCV"]
