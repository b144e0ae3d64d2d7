"""Core of the port: packing, precision, backends, piCholesky, solvers,
folds, the CV engine and its drivers, and the host-loop drivers."""
from .cv import cv_exact_cholesky, cv_picholesky
from .cv_host import host_cv_exact_cholesky, host_cv_picholesky, \
    host_cv_pinrmse
from .engine import CVEngine, make_strategy
from .folds import CVResult, FoldData, holdout_nrmse, make_folds

__all__ = ["CVEngine", "make_strategy", "CVResult", "FoldData",
           "holdout_nrmse", "make_folds", "cv_exact_cholesky",
           "cv_picholesky", "host_cv_exact_cholesky", "host_cv_picholesky",
           "host_cv_pinrmse"]
