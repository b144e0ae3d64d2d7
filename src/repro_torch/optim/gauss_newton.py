"""Damped Gauss–Newton updates for dense readout heads, accelerated by
piCholesky across the damping schedule.

A GN step on a least-squares head solves ``(H + λI) δ = g`` where the
damping λ is adapted every few steps — the Cholesky-under-diagonal-shift
sweep the paper accelerates.  The piCholesky interpolant is fitted once
over the damping range; each step evaluates the dense interpolated factor
L(λ) and substitutes (the Newton use from the paper's abstract), with λ
clipped to the fitted range.  On a CUDA device a step runs the
``interp_factors`` kernel and then the dense trsm kernel.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Tuple

import torch

from repro_torch.core import picholesky, solvers
from repro_torch.core.backends import BackendLike, resolve_backend

__all__ = ["damped_gauss_newton_head", "GNState"]


@dataclasses.dataclass(frozen=True)
class GNState:
    model: picholesky.PiCholesky
    lam: torch.Tensor
    lo: torch.Tensor
    hi: torch.Tensor


def damped_gauss_newton_head(
    hessian: torch.Tensor,
    lam_range: Tuple[float, float] = (1e-4, 1e1),
    g_samples: int = 6,
    degree: int = 2,
    block: int = 128,
    *,
    backend: BackendLike = "auto",
) -> Tuple[GNState, Callable]:
    """Returns (state, step_fn); step_fn(state, grad, lam) -> (delta, state).

    ``delta = (H + λI)⁻¹ grad`` via the interpolated factor.  ``backend``
    ``'auto'`` follows the Hessian's device (the CUDA kernels on a card).
    """
    bk = resolve_backend(backend, device=hessian.device)
    dev = hessian.device
    lo, hi = lam_range
    sample = picholesky.choose_sample_lambdas(lo, hi, g_samples, device=dev)
    model = picholesky.fit(hessian, sample, degree, block=block,
                           basis="centered", backend=bk)
    f64 = dict(dtype=torch.float64, device=dev)
    state = GNState(model=model, lam=torch.tensor((lo * hi) ** 0.5, **f64),
                    lo=torch.tensor(lo, **f64), hi=torch.tensor(hi, **f64))

    def step(state: GNState, grad: torch.Tensor, lam):
        lam = torch.clamp(picholesky.lam_tensor(lam, dev), state.lo,
                          state.hi)                 # stay in fitted range
        l_fac = state.model.eval_factor(lam, backend=bk)
        delta = solvers.solve_from_factor(l_fac, grad, bk)
        return delta, dataclasses.replace(state, lam=lam)

    return state, step
