"""Cholesky-family ridge solvers (§3.2) on the normal-equation data
``H = XᵀX`` (…, h, h) and ``g = Xᵀy`` (…, h).  Leading dimensions are batch
dimensions; every factorize/substitute step goes through one ``backend=``.
"""
from __future__ import annotations

import torch

from .backends import BackendLike, resolve_backend

__all__ = ["solve_from_factor", "solve_packed", "solve_interpolant_sweep",
           "solve_cholesky", "solve_cholesky_sweep"]


def solve_from_factor(l, g: torch.Tensor,
                      backend: BackendLike = "reference") -> torch.Tensor:
    """Forward + back substitution: solve L Lᵀ θ = g.  ``l`` is a dense
    factor or a :class:`~repro_torch.core.packing.PackedFactor`."""
    return resolve_backend(backend).solve_from_factor(l, g)


def solve_packed(pf, g: torch.Tensor,
                 backend: BackendLike = "reference") -> torch.Tensor:
    """Packed-domain solve L Lᵀ θ = g on tile-packed factor(s) (…, P);
    ``g`` (h,) or (h, m) is shared by every factor → (…, h[, m])."""
    return resolve_backend(backend).solve_packed(pf, g)


def solve_interpolant_sweep(model, lams, g: torch.Tensor,
                            backend: BackendLike = "reference"
                            ) -> torch.Tensor:
    """θ(λ) for a λ chunk straight from a fitted
    :class:`~repro_torch.core.picholesky.PiCholesky`: fused Horner
    evaluation + packed substitution, no (q, h, h) intermediate.
    g (…, h) → (…, q, h)."""
    return model.solve(lams, g, backend=backend)


def solve_cholesky(hessian: torch.Tensor, g: torch.Tensor, lam,
                   backend: BackendLike = "reference") -> torch.Tensor:
    """Exact Cholesky solve for one λ."""
    bk = resolve_backend(backend)
    eye = torch.eye(hessian.shape[-1], dtype=hessian.dtype,
                    device=hessian.device)
    return bk.solve_from_factor(bk.cholesky(hessian + lam * eye), g)


def solve_cholesky_sweep(hessian: torch.Tensor, g: torch.Tensor,
                         lams: torch.Tensor,
                         backend: BackendLike = "reference") -> torch.Tensor:
    """Exact Cholesky at every λ — the O(q d³) cost piCholesky amortizes:
    hessian (…, h, h), g (…, h), lams (q,) → (…, q, h), all λs factored in
    one batched call."""
    bk = resolve_backend(backend)
    h = hessian.shape[-1]
    eye = torch.eye(h, dtype=hessian.dtype, device=hessian.device)
    a = hessian[..., None, :, :] + lams[:, None, None] * eye
    gs = g[..., None, :].expand(*g.shape[:-1], lams.shape[0], h)
    return bk.solve_from_factor(bk.cholesky(a), gs)
