"""Theorem 4.4 / 4.7 error-bound machinery, small d and exact
(``src/repro/core/bound.py``).

The Taylor expansion of the Cholesky map C(A + λI), the remainder
magnitude R_[a,b], the piCholesky uniform bound and the anchor advisor, in
plain float64 ``torch.linalg`` on the input's device.  Operators act on the
row-major vec(·) of full d×d matrices, so M is d²×d² and the cost is
O(d⁶): meant for d ≲ 48 (the engine's advisor passes a 32-wide probe).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

__all__ = ["m_operator", "taylor_factor", "remainder_r", "picholesky_bound",
           "anchor_advisor"]


@functools.lru_cache(maxsize=None)
def _transpose_perm(d: int) -> np.ndarray:
    t = np.zeros((d * d, d * d))
    for i in range(d):
        for j in range(d):
            t[i * d + j, j * d + i] = 1.0
    return t


def _kron_op(x: torch.Tensor) -> torch.Tensor:
    """M vec_r(Γ) = vec_r(Γ Xᵀ + X Γᵀ) for any Γ: (I⊗X) + (X⊗I)·T, T the
    transpose permutation (the Cholesky perturbation Γ is lower
    triangular, not symmetric, so T stays)."""
    d = x.shape[0]
    x = x.contiguous()       # a factor from torch.linalg is column-major
    eye = torch.eye(d, dtype=x.dtype, device=x.device)
    t = torch.as_tensor(_transpose_perm(d), dtype=x.dtype, device=x.device)
    return torch.kron(eye, x) + torch.kron(x, eye) @ t


def m_operator(a: torch.Tensor, s) -> torch.Tensor:
    """M_s = [[C(A + sI)]] (d²×d²), transpose-corrected."""
    d = a.shape[0]
    l = torch.linalg.cholesky(a + s * torch.eye(d, dtype=a.dtype,
                                                device=a.device))
    return _kron_op(l)


def _solve_lower_structured(m: torch.Tensor, v: torch.Tensor,
                            d: int) -> torch.Tensor:
    """M x = v for x = vec(Γ), Γ lower triangular: least squares over M's
    columns on the tril support (DS_L is invertible there only, Thm 4.1)."""
    mask = torch.tril(torch.ones(d, d, dtype=torch.bool,
                                 device=m.device)).reshape(-1)
    cols = torch.nonzero(mask).reshape(-1)
    x_sub = torch.linalg.lstsq(m[:, cols], v[:, None]).solution[:, 0]
    x = m.new_zeros(d * d)
    x[cols] = x_sub
    return x


def taylor_factor(a: torch.Tensor, lam, lam_c) -> torch.Tensor:
    """p_TS(λ; λ_c): second-order Taylor approximation of C(A + λI)
    (Thm 4.4)."""
    d = a.shape[0]
    eye = torch.eye(d, dtype=a.dtype, device=a.device)
    l_c = torch.linalg.cholesky(a + lam_c * eye)
    m = _kron_op(l_c)
    v_i = eye.reshape(-1)
    d1 = _solve_lower_structured(m, v_i, d)                    # M⁻¹ v_I
    e = _kron_op(d1.reshape(d, d))                             # E_c
    d2 = _solve_lower_structured(m, e @ d1, d)                 # M⁻¹ E M⁻¹ v_I
    dl = (lam - lam_c) * d1 - 0.5 * (lam - lam_c) ** 2 * d2
    return l_c + dl.reshape(d, d)


def remainder_r(a: torch.Tensor, lo: float, hi: float,
                n_grid: int = 9) -> torch.Tensor:
    """R_[lo,hi] (Thm 4.4): max over s of
    ‖M⁻¹E‖₂²‖M⁻¹v_I‖₂ + ‖M⁻¹‖₂‖M⁻¹E‖₂‖M⁻¹v_I‖₂²."""
    d = a.shape[0]
    v_i = torch.eye(d, dtype=a.dtype, device=a.device).reshape(-1)

    def term(s):
        m = m_operator(a, s)
        m_inv = torch.linalg.pinv(m)
        m_inv_vi = _solve_lower_structured(m, v_i, d)
        m_inv_e = m_inv @ _kron_op(m_inv_vi.reshape(d, d))
        n_mie = torch.linalg.matrix_norm(m_inv_e, 2)
        n_miv = torch.linalg.vector_norm(m_inv_vi)
        n_mi = torch.linalg.matrix_norm(m_inv, 2)
        return n_mie ** 2 * n_miv + n_mi * n_mie * n_miv ** 2

    grid = torch.linspace(lo, hi, n_grid, dtype=a.dtype)
    return torch.max(torch.stack([term(float(s)) for s in grid]))


def anchor_advisor(a: torch.Tensor, anchors, n_grid: int = 5) -> dict:
    """Where is the interpolant weakest, and where should the next anchor
    go?  Scores each adjacent-anchor interval [λ_i, λ_{i+1}] by
    γ_i³ · R_[λ_i, λ_{i+1}] (γ_i the half-width; R on ``n_grid`` shifts)
    and proposes the log-midpoint of the worst.  ``a`` must be small (a
    probe submatrix).  Returns ``dict(intervals, scores, worst,
    proposal)``."""
    arr = np.sort(np.asarray(anchors, dtype=float).ravel())
    if arr.shape[0] < 2:
        raise ValueError(f"need at least 2 anchors to score intervals, "
                         f"got {arr.shape[0]}")
    if np.any(arr <= 0):
        raise ValueError("anchor advisor works over log-λ: "
                         "anchors must be positive")
    intervals = list(zip(arr[:-1], arr[1:]))
    scores = []
    for lo, hi in intervals:
        gamma = 0.5 * (hi - lo)
        r = float(remainder_r(a, float(lo), float(hi), n_grid=n_grid))
        scores.append(gamma ** 3 * r)
    worst = int(np.argmax(scores))
    lo, hi = intervals[worst]
    proposal = float(10.0 ** (0.5 * (np.log10(lo) + np.log10(hi))))
    return dict(intervals=[(float(lo), float(hi)) for lo, hi in intervals],
                scores=[float(s) for s in scores], worst=worst,
                proposal=proposal)


def picholesky_bound(a: torch.Tensor, sample_lams: torch.Tensor, lam_c: float,
                     gamma: float) -> torch.Tensor:
    """Right-hand side of Theorem 4.7 (uniform over [λ_c−γ, λ_c+γ])."""
    from .picholesky import vandermonde

    d = a.shape[0]
    big_d = d * (d + 1) / 2.0
    g = sample_lams.shape[0]
    w = float(torch.max(torch.abs(sample_lams - lam_c)))
    v = vandermonde(sample_lams, 2)
    v_pinv_norm = torch.linalg.matrix_norm(torch.linalg.pinv(v), 2)
    r = remainder_r(a, lam_c - gamma, lam_c + gamma)
    return ((gamma ** 3 + (g * 1.0) ** 0.5 * w ** 3 * (1 + gamma ** 2)
             * (lam_c + 1) * v_pinv_norm) * r / big_d ** 0.5)
