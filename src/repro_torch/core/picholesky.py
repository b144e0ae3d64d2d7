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
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from .._device import resolve_device
from . import packing
from .backends import BackendLike, resolve_backend

__all__ = ["PiCholesky", "fit", "vandermonde", "choose_sample_lambdas",
           "evaluate", "evaluate_packed", "lam_tensor", "refine_solutions",
           "loo_interp_scores", "select_interpolant"]

BASES = ("monomial", "centered")


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
        chol_fn: Optional[Callable] = None, factors=None,
        backend: BackendLike = "reference") -> PiCholesky:
    """Algorithm 1.  ``hessian``: (…, h, h) SPD; ``sample_lams``: (g,) with
    g > degree.  ``chol_fn`` (default the backend's ``cholesky``)
    factorizes the (…, g, h, h) batch of shifted Hessians in one call.
    ``factors`` skips the factorization: dense (…, g, h, h) or a
    :class:`~repro_torch.core.packing.PackedFactor` with vec (…, g, P),
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
    _check_basis(basis)
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
            factors = (chol_fn or bk.cholesky)(
                hessian[..., None, :, :] + lam * eye)
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
    lams_host = sample_lams.cpu()
    distinct = torch.unique(lams_host).numel()
    if distinct <= degree:
        # coincident shifts (a one-λ grid collapses every anchor onto it):
        # VᵀV is singular and any Θ the solve returns is rounding noise
        raise FloatingPointError(
            f"the degree-{degree} fit needs {degree + 1} distinct sample "
            f"shifts, got {distinct} distinct of {g}: the normal equations "
            "are singular (a λ grid with no range?)")
    v = vandermonde(lams_host, degree, center.cpu()).to(fit_dtype)
    proj = torch.linalg.solve(v.T @ v, v.T).to(targets.device)  # (r+1, g)
    # one 2-D product per leading index: a batched product may take another
    # library kernel (another summation order) for another batch size, and
    # a fold's Θ must not depend on how many folds share the call
    # (CVEngine.run_batch stacks several problems' folds)
    t = targets.to(fit_dtype)
    flat = t.reshape(-1, *t.shape[-2:])
    theta = torch.stack([proj @ t_i for t_i in flat]).reshape(
        *t.shape[:-2], proj.shape[0], t.shape[-1])          # (…, r+1, P)
    return PiCholesky(theta=theta.to(store_dtype),
                      center=center.to(fit_dtype).to(targets.device),
                      h=h, block=block)


def _check_basis(basis: str) -> None:
    if basis not in BASES:
        raise ValueError(f"unknown basis {basis!r}; "
                         "expected 'monomial' or 'centered'")


def loo_interp_scores(targets: torch.Tensor, sample_lams, degrees:
                      Sequence[int], *, bases: Sequence[str] = ("monomial",),
                      backend: BackendLike = "reference") -> dict:
    """Leave-one-anchor-out CV scores of candidate (degree, basis) pairs
    (``src/repro/core/picholesky.py:182``).

    ``targets``: tile-packed anchor factors, (g, P) or (k, g, P).  For each
    held-out anchor s the candidate is fitted by the normal equations on
    the other g − 1 anchors and evaluated at λ_s; its score is the mean
    over anchors and folds of ‖prediction − T_s‖ / ‖T_s‖.  A fit is linear
    in the targets, so every held-out prediction of a candidate is one
    (g, g) weight matrix applied to T: the (r+1)² solves run on the host
    and the targets see one GEMM per candidate, at the policy's fit dtype.
    A candidate needs g − 1 > degree (``ValueError`` otherwise).

    Returns ``{(degree, basis): float}``.
    """
    t = torch.as_tensor(targets)
    if t.ndim == 2:
        t = t[None]                                        # (k=1, g, P)
    lam = lam_tensor(sample_lams, "cpu").reshape(-1)
    g = int(lam.shape[0])
    for r in degrees:
        if g - 1 <= int(r):
            raise ValueError(
                f"leave-one-out selection needs g - 1 > degree: "
                f"g={g} anchors cannot score degree {r}")
    fit_dtype = resolve_backend(backend).precision.fit_dtype(t.dtype)
    t = t.to(fit_dtype)
    lam = lam.to(fit_dtype)
    tiny = torch.finfo(fit_dtype).tiny
    norms = torch.linalg.vector_norm(t, dim=-1) + tiny     # (k, g)
    scores: dict = {}
    for basis in bases:
        _check_basis(basis)
        center = lam.mean() if basis == "centered" else lam.new_zeros(())
        for r in degrees:
            v = vandermonde(lam, int(r), center)           # (g, r+1)
            weights = []
            for s in range(g):
                vw = v.clone()
                vw[s] = 0                                  # drop anchor s
                weights.append(v[s] @ torch.linalg.solve(vw.T @ v, vw.T))
            w = torch.stack(weights).to(t.device)          # (g, g)
            pred = w @ t                                   # (k, g, P)
            errs = torch.linalg.vector_norm(pred - t, dim=-1) / norms
            scores[(int(r), basis)] = float(errs.mean())
    return scores


def select_interpolant(targets: torch.Tensor, sample_lams,
                       degrees: Optional[Sequence[int]] = None, *,
                       bases: Sequence[str] = BASES,
                       backend: BackendLike = "reference") -> dict:
    """Choose the interpolant (degree, basis) by :func:`loo_interp_scores`
    (``src/repro/core/picholesky.py:249``).  ``degrees=None`` tries every
    scorable degree 1 .. g−2.  Ties break toward the lowest degree: the
    candidates are taken basis by basis in ascending degree, and only a
    strictly better score displaces the incumbent.

    Returns ``dict(degree=, basis=, score=, scores={'basis/r': float})``.
    """
    g = int(lam_tensor(sample_lams, "cpu").reshape(-1).shape[0])
    if degrees is None:
        degrees = tuple(range(1, g - 1))
    degrees = tuple(int(r) for r in degrees)
    if not degrees:
        raise ValueError(f"no candidate degrees to select from "
                         f"(g={g} anchors admit degrees 1..{g - 2})")
    scores = loo_interp_scores(targets, sample_lams, degrees, bases=bases,
                               backend=backend)
    best_key, best = None, None
    for basis in bases:
        for r in degrees:
            s = scores[(r, basis)]
            if best is None or s < best:
                best_key, best = (r, basis), s
    return dict(degree=best_key[0], basis=best_key[1], score=best,
                scores={f"{b}/r{r}": s for (r, b), s in scores.items()})


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
