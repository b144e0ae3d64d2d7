"""piCholesky (Algorithm 1): polynomial interpolation of Cholesky factors.

Factorize ``L^s = chol(H + λ_s I)`` exactly at ``g`` sample shifts, fit an
order-``r`` polynomial to every entry of the tile-packed factors by one
least-squares solve (``Θ = (VᵀV)⁻¹VᵀT``), and evaluate the fit anywhere on
the λ grid at ``O(r d²)`` per value.  Leading dimensions of the Hessian (and
of Θ) are batch dimensions — the CV engine passes every fold at once.

Basis options: ``'monomial'`` (V[s,k] = λ_s^k, the paper's) and
``'centered'`` (V[s,k] = (λ_s − mean λ_s)^k).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .._device import resolve_device
from . import packing
from .backends import BackendLike, resolve_backend

__all__ = ["PiCholesky", "fit", "vandermonde", "choose_sample_lambdas",
           "evaluate", "evaluate_packed", "lam_tensor", "refine_solutions"]


def lam_tensor(lam, device) -> torch.Tensor:
    """λ (scalar or vector) as a tensor on ``device``.  A tensor keeps its
    dtype; anything else goes through numpy, so a Python float is float64,
    as ``jnp.asarray`` makes it in the reference's 64-bit mode."""
    if isinstance(lam, torch.Tensor):
        return lam.to(device)
    return torch.as_tensor(np.asarray(lam), device=device)


def vandermonde(lams: torch.Tensor, degree: int, center=0.0) -> torch.Tensor:
    """g × (degree+1) observation matrix V."""
    x = lams - center
    return torch.pow(x[:, None], torch.arange(degree + 1, device=x.device
                                              ).to(x.dtype)[None, :])


def choose_sample_lambdas(lo, hi, g: int, spacing: str = "log", *,
                          dtype=torch.float64, device=None) -> torch.Tensor:
    """The g sample shifts spanning [lo, hi]: ``logspace(log10 lo,
    log10 hi, g)`` (or evenly spaced), computed in ``dtype`` with the same
    arithmetic as ``jnp.linspace`` — ``start·(1−s) + stop·s`` with the last
    node set to ``stop`` exactly — and ``log10 x = log x / log 10``.
    ``device=None`` is the CUDA device."""
    lo = torch.as_tensor(lo, dtype=dtype, device=resolve_device(device))
    hi = torch.as_tensor(hi, dtype=dtype, device=lo.device)
    if spacing == "log":
        ten = torch.tensor(10.0, dtype=dtype, device=lo.device)
        lo, hi = torch.log(lo) / torch.log(ten), torch.log(hi) / torch.log(ten)
    if g == 1:
        lin = lo[None]
    else:
        step = torch.arange(g - 1, device=lo.device).to(dtype) / (g - 1)
        lin = torch.cat([lo * (1 - step) + hi * step, hi[None]])
    return torch.pow(torch.tensor(10.0, dtype=dtype, device=lo.device),
                     lin) if spacing == "log" else lin


@dataclasses.dataclass(frozen=True)
class PiCholesky:
    """Fitted interpolant: ``theta`` (…, r+1, P) coefficients over the
    packed layout, ``center`` the basis center."""

    theta: torch.Tensor
    center: torch.Tensor
    h: int
    block: int

    @property
    def degree(self) -> int:
        return self.theta.shape[-2] - 1

    def eval_packed(self, lam) -> torch.Tensor:
        """Horner evaluation at scalar or vector λ → (…, [q,] P)."""
        lam = lam_tensor(lam, self.theta.device)
        x = (lam - self.center).to(self.theta.dtype)
        scalar = x.ndim == 0
        x = x.reshape(-1)
        lead = self.theta.shape[:-2]
        acc = self.theta.new_zeros((*lead, x.shape[0], self.theta.shape[-1]))
        for k in range(self.degree, -1, -1):
            acc = acc * x[:, None] + self.theta[..., k, None, :]
        return acc[..., 0, :] if scalar else acc

    def eval_packed_factor(self, lam) -> packing.PackedFactor:
        """Interpolated factor(s) in the packed layout: vec (…, [q,] P)."""
        return packing.PackedFactor(self.eval_packed(lam), self.h,
                                    self.block)

    def solve(self, lam, g: torch.Tensor,
              backend: BackendLike = "reference") -> torch.Tensor:
        """θ(λ) = (H + λI)⁻¹ g for a λ chunk by the fused packed pipeline:
        g (…, h) → (…, q, h)."""
        lam = lam_tensor(lam, self.theta.device).reshape(-1)
        return resolve_backend(backend).interp_solve(
            self.theta, lam, g, h=self.h, block=self.block,
            center=self.center)

    def eval_factor(self, lam,
                    backend: BackendLike = "reference") -> torch.Tensor:
        """Dense interpolated factor(s) L(λ): (…, q, h, h) for a vector λ,
        (…, h, h) for a scalar one — the dense-factor route of Algorithm 1
        (evaluate, then substitute).  On the ``cuda`` backend one pass of
        the ``interp_factors`` kernel over Θ writes every L(λ)."""
        lam = lam_tensor(lam, self.theta.device)
        out = resolve_backend(backend).interp_factors(
            self.theta, lam.reshape(-1), h=self.h, block=self.block,
            center=self.center)
        return out[..., 0, :, :] if lam.ndim == 0 else out


def fit(hessian: torch.Tensor | None, sample_lams: torch.Tensor,
        degree: int = 2, *, block: int = 128, basis: str = "monomial",
        factors=None, backend: BackendLike = "reference") -> PiCholesky:
    """Algorithm 1.  ``hessian``: (…, h, h) SPD; ``sample_lams``: (g,) with
    g > degree.  ``factors`` skips the factorization: dense (…, g, h, h) or
    a :class:`~repro_torch.core.packing.PackedFactor` with vec (…, g, P),
    consumed without an unpack (then ``hessian`` may be ``None``).

    The normal equations run at the policy's fit dtype; Θ is stored at its
    storage dtype.
    """
    if hessian is None and factors is None:
        raise ValueError("fit needs a hessian to factorize or "
                         "precomputed factors; got neither")
    if hessian is not None:
        h = hessian.shape[-1]
    elif isinstance(factors, packing.PackedFactor):
        h = factors.h
    else:
        h = factors.shape[-1]
    g = sample_lams.shape[0]
    if g <= degree:
        raise ValueError(f"need g > r: got g={g}, r={degree}")
    if basis not in ("monomial", "centered"):
        raise ValueError(f"unknown basis {basis!r}; "
                         "expected 'monomial' or 'centered'")
    bk = resolve_backend(backend)

    if isinstance(factors, packing.PackedFactor):
        if factors.block != block or factors.h != h:
            raise ValueError(
                f"packed factors have (h={factors.h}, block={factors.block});"
                f" fit called with (h={h}, block={block})")
        targets = factors.vec
    else:
        if factors is None:
            eye = torch.eye(h, dtype=hessian.dtype, device=hessian.device)
            lam = sample_lams.to(hessian.device)[:, None, None]
            factors = bk.cholesky(hessian[..., None, :, :] + lam * eye)
        targets = bk.pack_tril(factors, block)              # (…, g, P)

    center = (sample_lams.mean() if basis == "centered"
              else sample_lams.new_zeros(()))
    fit_dtype = bk.precision.fit_dtype(targets.dtype)
    store_dtype = bk.precision.store_dtype(targets.dtype)
    # Θ = (VᵀV)⁻¹ (Vᵀ T), with the (r+1)×(r+1) solve applied to Vᵀ (g
    # columns) before the product with T: a batched LU solve against the
    # P ≈ 6·10⁵ columns of VᵀT spends most of its time swapping rows.
    # That solve runs on the host: on the card torch.linalg.solve launches
    # cuBLAS trsm kernels and reads its status back to the host all the
    # same, and elementwise tensor operations cost more launches than it.
    v = vandermonde(sample_lams.cpu(), degree, center.cpu()).to(fit_dtype)
    proj = torch.linalg.solve(v.T @ v, v.T).to(targets.device)  # (r+1, g)
    theta = proj @ targets.to(fit_dtype)                    # (…, r+1, P)
    return PiCholesky(theta=theta.to(store_dtype),
                      center=center.to(fit_dtype).to(targets.device),
                      h=h, block=block)


def evaluate_packed(model: PiCholesky, lams) -> packing.PackedFactor:
    """Interpolated factors at a λ grid, still tile-packed: vec (…, q, P)."""
    return model.eval_packed_factor(lams)


def evaluate(model: PiCholesky, lams) -> torch.Tensor:
    """Dense interpolated factors (…, q, h, h); the sweep path consumes
    :func:`evaluate_packed` / :meth:`PiCholesky.solve` instead."""
    return model.eval_factor(lams)


def refine_solutions(model: PiCholesky, hessian: torch.Tensor,
                     g: torch.Tensor, lams, thetas: torch.Tensor,
                     backend: BackendLike = "reference",
                     iters: int | None = None) -> torch.Tensor:
    """Iterative refinement of ``interp_solve`` solutions, the accuracy half
    of the ``bf16_refined`` policy (``src/repro/core/picholesky.py:298``).

    Each sweep forms the residual ``r(λ) = g − (H + λI) θ(λ)`` at the
    policy's accumulation dtype (exact λ, not the bf16 one Horner used) and
    corrects θ by one more fused interpolant solve with the per-λ residuals
    as right-hand sides.  Batched over folds: ``hessian`` (…, h, h), ``g``
    (…, h), ``lams`` (q,), ``thetas`` (…, q, h) — or (…, h) for a scalar
    λ.  Returns ``thetas`` itself when the iteration count is 0; ``iters``
    overrides the policy's ``refine_iters``.
    """
    bk = resolve_backend(backend)
    iters = bk.precision.refine_iters if iters is None else int(iters)
    if iters <= 0:
        return thetas
    ad = bk.precision.accum_dtype(model.theta.dtype)
    lam = lam_tensor(lams, model.theta.device)
    single = lam.ndim == 0
    lam = lam.reshape(-1)
    hs = hessian.to(ad)
    gs = g.to(ad)[..., None, :]
    lam_col = lam.to(ad)[:, None]
    th = (thetas[..., None, :] if single else thetas).to(ad)   # (…, q, h)
    for _ in range(iters):
        # H is symmetric: θ H is (H θᵀ)ᵀ, one batched product per fold
        resid = gs - (th @ hs + lam_col * th)
        delta = bk.interp_solve(model.theta, lam, resid, h=model.h,
                                block=model.block, center=model.center,
                                rhs_per_lam=True)
        th = th + delta.to(ad)
    return th[..., 0, :] if single else th
