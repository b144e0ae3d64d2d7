"""RidgeCV — k-fold cross-validated ridge with the piCholesky λ sweep, the
end-to-end entry point (``src/repro/core/ridge_cv.py:26``).

The fold statistics, the sweep and the refit at λ* run where ``device=``
says (``None``: the CUDA device).  ``ctx=`` (a
:class:`~repro_torch.distributed.context.MeshCtx`) places the rows on its
mesh's first device (``MeshCtx(None)``: nowhere else), and ``cv_mesh=``
(``None``, ``'auto'`` or a CV ``Mesh``) splits the sweep over folds × λs
(:class:`~repro_torch.core.engine.CVEngine` ``mesh=``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch

from .._device import resolve_device
from ..distributed.context import MeshCtx
from . import cv as cvlib
from . import picholesky, solvers
from .backends import resolve_backend
from .precision import resolve_precision

__all__ = ["RidgeCV"]

METHODS = ("pichol", "exact")


@dataclasses.dataclass
class RidgeCV:
    """k-fold cross-validated ridge; ``method`` ``'pichol'`` (the
    piCholesky sweep) or ``'exact'`` (a factorization at every λ)."""

    k_folds: int = 5
    n_lambdas: int = 31
    lam_lo: float = 1e-3
    lam_hi: float = 1e2
    g_samples: int = 4
    degree: int = 2
    block: int = 128
    method: str = "pichol"
    ctx: Optional[MeshCtx] = None
    backend: object = "auto"        # 'auto' | 'cuda' | 'reference' | backend
    cv_mesh: object = None          # None | 'auto' | CV Mesh for the λ sweep
    precision: object = None        # PrecisionPolicy | preset name | None
    device: Optional[Union[str, torch.device]] = None

    def __post_init__(self):
        if self.ctx is not None and not isinstance(self.ctx, MeshCtx):
            raise TypeError(f"ctx must be a MeshCtx or None, got "
                            f"{type(self.ctx).__name__}")
        from ..distributed.sharding import is_cv_mesh
        if not is_cv_mesh(self.cv_mesh) \
                and self.cv_mesh not in (None, "auto"):
            raise ValueError(f"cv_mesh must be None, 'auto' or a CV Mesh; "
                             f"got {self.cv_mesh!r}")
        if self.method not in METHODS:
            raise ValueError(f"unknown method {self.method!r}; expected one "
                             f"of {METHODS}")

    def lambdas(self) -> torch.Tensor:
        """The (n_lambdas,) float64 log-spaced grid over [lam_lo, lam_hi],
        with ``jnp.logspace``'s arithmetic."""
        return picholesky.choose_sample_lambdas(
            self.lam_lo, self.lam_hi, self.n_lambdas,
            device=resolve_device(self.device))

    def fit(self, x, y) -> cvlib.CVResult:
        dev = resolve_device(self.device)
        ctx = self.ctx or MeshCtx(None)
        if ctx.mesh is not None:
            x = ctx.constrain(torch.as_tensor(x), ctx.dp_axes, None)
            y = ctx.constrain(torch.as_tensor(y), ctx.dp_axes)
        folds = cvlib.make_folds(x, y, self.k_folds, device=dev)
        lams = self.lambdas()
        if self.method == "exact":
            return cvlib.cv_exact_cholesky(folds, lams, backend=self.backend,
                                           mesh=self.cv_mesh,
                                           precision=self.precision,
                                           device=dev)
        return cvlib.cv_picholesky(folds, lams, g=self.g_samples,
                                   degree=self.degree, block=self.block,
                                   backend=self.backend, mesh=self.cv_mesh,
                                   precision=self.precision, device=dev)

    def fit_theta(self, x, y):
        """CV-select λ*, then solve on the full data at λ* (through the
        same backend).  λ* is taken at the policy's fit dtype (float32 at
        the least), never the data's: on a bf16 design the data's dtype
        would round the selected regularizer to another model."""
        dev = resolve_device(self.device)
        x = torch.as_tensor(x, device=dev)
        y = torch.as_tensor(y, device=dev)
        result = self.fit(x, y)
        pol = resolve_precision(self.precision)
        bk = resolve_backend(self.backend, block=self.block, precision=pol,
                             device=dev)
        lam = torch.tensor(result.best_lam, dtype=pol.fit_dtype(x.dtype),
                           device=dev)
        theta = solvers.solve_cholesky(x.T @ x, x.T @ y, lam, backend=bk)
        return theta, result
