"""Core of the port: packing, precision, backends, piCholesky, solvers,
folds, the CV engine with every paper strategy but the sketched one, its
drivers (MChol among them), the host-loop drivers and ``RidgeCV``."""
from .backends import CountingBackend, resolve_backend, retile_backend
from .cv import cv_exact_cholesky, cv_multilevel_cholesky, cv_picholesky, \
    cv_picholesky_warmstart, cv_pinrmse, cv_svd
from .cv_host import host_cv_exact_cholesky, host_cv_picholesky, \
    host_cv_pinrmse, host_cv_svd
from .engine import CVEngine, make_strategy
from .folds import CVResult, FoldData, holdout_nrmse, make_folds
from .picholesky import select_interpolant
from .ridge_cv import RidgeCV

__all__ = ["CVEngine", "make_strategy", "CVResult", "FoldData",
           "holdout_nrmse", "make_folds", "cv_exact_cholesky",
           "cv_picholesky", "cv_picholesky_warmstart",
           "cv_multilevel_cholesky", "cv_svd", "cv_pinrmse",
           "host_cv_exact_cholesky", "host_cv_picholesky", "host_cv_pinrmse",
           "host_cv_svd", "CountingBackend", "resolve_backend",
           "retile_backend", "select_interpolant", "RidgeCV"]
