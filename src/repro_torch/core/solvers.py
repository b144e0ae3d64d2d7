"""Ridge solvers (§3.2).

* The Cholesky family on the normal-equation data ``H = XᵀX`` (…, h, h)
  and ``g = Xᵀy`` (…, h): every factorize/substitute step goes through one
  ``backend=``, and ``chol_fn=`` overrides the factorization alone.
* The SVD family (SVD, t-SVD, r-SVD) and the low-rank ACV factors on the
  raw design X: one λ-independent factorization, then every λ by scaling.
  They factorize with ``torch.linalg.svd``/``qr``, as the reference does
  with ``jnp.linalg`` (no Pallas kernel runs there either).

Leading dimensions are batch dimensions (folds).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from .backends import BackendLike, resolve_backend

__all__ = ["solve_from_factor", "solve_packed", "solve_interpolant_sweep",
           "solve_cholesky", "solve_cholesky_sweep", "svd_ridge_factors",
           "svd_ridge_sweep", "solve_svd", "solve_truncated_svd",
           "randomized_range_finder", "solve_randomized_svd",
           "LowRankFactors", "lowrank_ridge_factors", "lowrank_ridge_sweep"]

SVD_MODES = ("full", "truncated", "randomized")


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
                   chol_fn: Optional[Callable] = None,
                   backend: BackendLike = "reference") -> torch.Tensor:
    """Exact Cholesky solve for one λ: hessian (…, h, h), g (…, h).
    ``chol_fn`` (default the backend's ``cholesky``) factorizes the
    shifted (…, h, h) batch.  A λ tensor of a wider dtype than the Hessian
    widens the shifted matrix to it, as ``jnp`` promotes (a float32 λ on a
    bf16 Hessian is not rounded to bf16)."""
    bk = resolve_backend(backend)
    chol = chol_fn or bk.cholesky
    if isinstance(lam, torch.Tensor):
        hessian = hessian.to(torch.promote_types(hessian.dtype, lam.dtype))
        lam = lam.to(hessian.device)
    eye = torch.eye(hessian.shape[-1], dtype=hessian.dtype,
                    device=hessian.device)
    return bk.solve_from_factor(chol(hessian + lam * eye), g)


def solve_cholesky_sweep(hessian: torch.Tensor, g: torch.Tensor,
                         lams: torch.Tensor,
                         chol_fn: Optional[Callable] = None,
                         backend: BackendLike = "reference") -> torch.Tensor:
    """Exact Cholesky at every λ — the O(q d³) cost piCholesky amortizes:
    hessian (…, h, h), g (…, h), lams (q,) → (…, q, h), all λs factored in
    one batched call (of ``chol_fn`` when given)."""
    bk = resolve_backend(backend)
    chol = chol_fn or bk.cholesky
    h = hessian.shape[-1]
    eye = torch.eye(h, dtype=hessian.dtype, device=hessian.device)
    a = hessian[..., None, :, :] + lams[:, None, None] * eye
    gs = g[..., None, :].expand(*g.shape[:-1], lams.shape[0], h)
    return bk.solve_from_factor(chol(a), gs)


# ------------------------------------------------------------- SVD family


def randomized_range_finder(x: torch.Tensor, k: int,
                            generator: Optional[torch.Generator] = None,
                            oversample: int = 10, n_iter: int = 2, *,
                            omega: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """Halko–Martinsson–Tropp randomized range finder with power iteration:
    x (…, n, h) → an orthonormal basis (…, n, p) of its range, p = min(h,
    k + oversample).  The Gaussian test matrix is ``omega`` (h, p) when
    given (shared by the batch), else drawn from ``generator`` (default: a
    generator seeded 0 on x's device)."""
    h = x.shape[-1]
    p = min(h, k + oversample)
    if omega is None:
        if generator is None:
            generator = torch.Generator(device=x.device).manual_seed(0)
        omega = torch.randn(h, p, generator=generator, dtype=x.dtype,
                            device=x.device)
    elif tuple(omega.shape) != (h, p):
        raise ValueError(f"omega must be (h, p) = ({h}, {p}) for k={k}, "
                         f"oversample={oversample}; got "
                         f"{tuple(omega.shape)}")
    q, _ = torch.linalg.qr(x @ omega.to(x.device, x.dtype))
    for _ in range(n_iter):
        q, _ = torch.linalg.qr(x.mT @ q)
        q, _ = torch.linalg.qr(x @ q)
    return q


def svd_ridge_factors(x: torch.Tensor, y: torch.Tensor, mode: str = "full",
                      k: int = 0, generator: Optional[torch.Generator] = None,
                      *, omega: Optional[torch.Tensor] = None):
    """λ-independent factor stage shared by the SVD family: x (…, n, h),
    y (…, n) → ``(s, vt, uty)`` with θ(λ) = vtᵀ diag(s/(s²+λ)) uty.

    ``mode``: ``'full'`` | ``'truncated'`` (top-k) | ``'randomized'``
    (the range finder, then top-k; ``generator``/``omega`` as for
    :func:`randomized_range_finder`)."""
    if mode == "full":
        u, s, vt = torch.linalg.svd(x, full_matrices=False)
    elif mode == "truncated":
        u, s, vt = torch.linalg.svd(x, full_matrices=False)
        u, s, vt = u[..., :k], s[..., :k], vt[..., :k, :]
    elif mode == "randomized":
        q = randomized_range_finder(x, k, generator, omega=omega)
        ub, s, vt = torch.linalg.svd(q.mT @ x, full_matrices=False)
        u = q @ ub
        u, s, vt = u[..., :k], s[..., :k], vt[..., :k, :]
    else:
        raise ValueError(f"unknown SVD mode {mode!r}; expected one of "
                         f"{SVD_MODES}")
    return s, vt, (u.mT @ y[..., None])[..., 0]


def svd_ridge_sweep(factors, lams: torch.Tensor) -> torch.Tensor:
    """θ(λ) for every λ from a :func:`svd_ridge_factors` result:
    (…, q, h)."""
    s, vt, uty = factors
    lams = lams.reshape(-1).to(s.device, s.dtype)
    s2 = s * s
    d = s[..., None, :] / (s2[..., None, :] + lams[:, None])     # (…, q, r)
    return (d * uty[..., None, :]) @ vt


def solve_svd(x: torch.Tensor, y: torch.Tensor,
              lams: torch.Tensor) -> torch.Tensor:
    """Full-SVD baseline (Eq. 11): factorize X once, reuse across all λ."""
    return svd_ridge_sweep(svd_ridge_factors(x, y, "full"), lams)


def solve_truncated_svd(x: torch.Tensor, y: torch.Tensor, lams: torch.Tensor,
                        k: int) -> torch.Tensor:
    """t-SVD baseline: keep only the top-k singular triplets."""
    return svd_ridge_sweep(svd_ridge_factors(x, y, "truncated", k), lams)


def solve_randomized_svd(x: torch.Tensor, y: torch.Tensor,
                         lams: torch.Tensor, k: int,
                         generator: Optional[torch.Generator] = None, *,
                         omega: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """r-SVD baseline [13]: approximate top-k SVD via random projection."""
    return svd_ridge_sweep(svd_ridge_factors(x, y, "randomized", k,
                                             generator, omega=omega), lams)


# ---------------------------------------------------------------- low rank


@dataclasses.dataclass(frozen=True)
class LowRankFactors:
    """Spectral factors of a (rank-truncated) fold Hessian:
    H̃ = vtᵀ diag(evals) vt.

    ``vt`` holds every computed right singular vector of the training
    design (…, r₀, h), r₀ = min(n, h); ``evals`` the squared singular
    values, **zeroed** (not dropped) beyond the requested rank, so the
    truncated directions solve at 1/λ through the same ``1/(e+λ)`` and no
    ``g − V Vᵀ g`` cancellation appears.  λ-independent."""

    vt: torch.Tensor
    evals: torch.Tensor


def lowrank_ridge_factors(x: torch.Tensor, rank: Optional[int] = None,
                          precision=None) -> LowRankFactors:
    """Low-rank ACV factor stage (Stephenson et al., arXiv:2008.10547): the
    SVD of the (…, n, h) training design.  ``rank`` keeps the top-r
    curvature directions (``None``: all min(n, h)); ``precision`` stores
    ``vt`` and ``evals`` at its storage dtype."""
    _, s, vt = torch.linalg.svd(x, full_matrices=False)
    evals = s * s
    if rank is not None:
        r = min(int(rank), s.shape[-1])
        keep = torch.arange(evals.shape[-1], device=evals.device) < r
        evals = torch.where(keep, evals, torch.zeros((), dtype=evals.dtype,
                                                     device=evals.device))
    if precision is not None:
        vt = vt.to(precision.store_dtype(vt.dtype))
        evals = evals.to(precision.store_dtype(evals.dtype))
    return LowRankFactors(vt=vt, evals=evals)


def lowrank_ridge_sweep(factors: LowRankFactors, g: torch.Tensor,
                        lams: torch.Tensor, compute_dtype=None
                        ) -> torch.Tensor:
    """θ(λ) = Vᵀ diag(1/(e+λ)) V g for every λ: g (…, h) → (…, q, h).

    The Woodbury form of (H̃ + λI)⁻¹g for H̃ = Vᵀ diag(e) V; g = Xᵀy lies
    in the row space of V, so no 1/λ null-space term is needed.  Exact (up
    to rounding) when no eval was truncated.  Computed at
    ``compute_dtype`` (default: g's dtype promoted with float32)."""
    dt = compute_dtype or torch.promote_types(g.dtype, torch.float32)
    vt = factors.vt.to(dt)
    evals = factors.evals.to(dt)
    vg = (vt @ g.to(dt)[..., None])[..., 0]                    # (…, r₀)
    lams = lams.reshape(-1).to(vt.device, dt)
    coef = vg[..., None, :] / (evals[..., None, :] + lams[:, None])
    return coef @ vt
