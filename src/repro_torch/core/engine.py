"""CV engine: the batched fold × λ sweep.

The paper's experiment is a dense grid of independent ridge solves — k folds
by q regularizers.  :class:`CVEngine` runs it as

* ``prepare`` — replicated setup (the piCholesky sample shifts),
* ``fold_state`` — the heavy λ-independent stage, every fold at once (folds
  are a leading batch dimension of every tensor),
* ``fold_errors`` — solve and score, streamed over the λ grid in
  ``lam_chunk``-sized chunks, so only one chunk's solves are live at a time.

All linear algebra goes through one ``backend=`` switch
(:mod:`repro_torch.core.backends`): the CUDA kernels on the card, plain
``torch.linalg`` on the CPU.  A :class:`~repro_torch.core.backends.
CountingBackend` sees each stage under its label (``prepare``,
``fold_state``, ``fold_errors``).

Strategies (the paper's algorithms, ``src/repro/core/engine.py:167-600``):

* ``exact`` — k·q factorizations;
* ``picholesky`` — k·g factorizations + the fused interpolant sweep;
* ``picholesky_warmstart`` — a fold-0 anchor fit, then per fold a refit of
  the residual from ``g_rest`` factorizations;
* ``pinrmse`` — the hold-out curve itself interpolated from g exact
  evaluations (the §6.5 straw-man);
* ``svd`` — SVD / t-SVD / r-SVD of the raw training design;
* ``low_rank`` — low-rank ACV through the Woodbury identity.

MChol (§6.2) is a host-side driver (:func:`repro_torch.core.cv.
cv_multilevel_cholesky`): its search is decision-dependent.
``picholesky_sketched`` waits for ``core/sketch.py``.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Optional, Union

import numpy as np
import torch

from .._device import resolve_device
from . import packing, picholesky, solvers
from .backends import BackendLike, LinalgBackend, resolve_backend
from .folds import CVResult, FoldData, holdout_nrmse
from .precision import PrecisionLike

__all__ = ["CVEngine", "ExactCholesky", "PiCholeskyStrategy",
           "PiCholeskyWarmstart", "PinrmseStrategy", "SVDStrategy",
           "LowRankStrategy", "make_strategy", "STRATEGIES",
           "LAM_CHUNK_BUDGET_BYTES", "auto_lam_chunk", "chunk_lams"]

#: byte budget the ``lam_chunk='auto'`` heuristic sizes one chunk's packed
#: factors against.  The same value as the JAX package's, so both packages
#: cut a grid into the same chunks.
LAM_CHUNK_BUDGET_BYTES = 16 * 1024 * 1024


def auto_lam_chunk(h: int, block: int, dtype, budget: int) -> int:
    """λ-chunk size whose per-chunk packed working set fits ``budget``."""
    return max(1, int(budget // packing.packed_nbytes(h, block, dtype)))


def chunk_lams(lams: torch.Tensor, chunk: int):
    """(q,) → ((q_pad // chunk), chunk) plus q.  The last chunk is
    edge-padded by repeating the last λ (an SPD shift that always
    factorizes); callers cut the padded entries off."""
    if chunk <= 0:
        raise ValueError(f"chunk must be positive, got {chunk}")
    q = lams.shape[0]
    pad = (-q) % chunk
    if pad:
        lams = torch.cat([lams, lams[-1:].expand(pad)])
    return lams.reshape(-1, chunk), q


def _sample_grid(lams: torch.Tensor, g: int) -> torch.Tensor:
    """g log-spaced sample shifts spanning the dense grid."""
    return picholesky.choose_sample_lambdas(lams[0], lams[-1], g,
                                            dtype=lams.dtype,
                                            device=lams.device)


def _errors_from_thetas(thetas: torch.Tensor, x_f: torch.Tensor,
                        y_f: torch.Tensor) -> torch.Tensor:
    """thetas (k, c, h), x_f (k, n_f, h), y_f (k, n_f) → (k, c)."""
    return holdout_nrmse(thetas, x_f[:, None], y_f[:, None])


def _other_folds(x_folds: torch.Tensor) -> torch.Tensor:
    """Each fold's training rows, the k − 1 other folds in the reference's
    order ``(f + 1 + arange(k − 1)) % k`` (``src/repro/core/engine.py:472``):
    (k, n_f, …) → (k, (k − 1)·n_f, …)."""
    k, n_f = x_folds.shape[:2]
    f = torch.arange(k, device=x_folds.device)
    others = (f[:, None] + 1 + torch.arange(k - 1, device=x_folds.device)
              ) % k                                        # (k, k − 1)
    return x_folds[others].reshape(k, (k - 1) * n_f, *x_folds.shape[2:])


class StrategyBase:
    def prepare(self, x_folds, y_folds, h_tr, g_tr, lams, bk):
        return ()

    def fold_state(self, h_tr, g_tr, aux, bk):
        return ()


@dataclasses.dataclass(frozen=True, eq=False)
class ExactCholesky(StrategyBase):
    """Chol baseline: factorize at every (fold, λ) — k·q factorizations."""

    chol_fn: Optional[Callable] = None
    name: str = "exact"

    def n_exact_chol(self, k, q):
        return k * q

    def fold_errors(self, state, h_tr, g_tr, x_f, y_f, lams, aux, bk):
        thetas = solvers.solve_cholesky_sweep(h_tr, g_tr, lams, self.chol_fn,
                                              bk)
        return _errors_from_thetas(thetas, x_f, y_f)


class _InterpolantErrors:
    """The λ stage of the piCholesky family: the fused interpolant solve
    of every fold at the chunk, corrected by
    :func:`~repro_torch.core.picholesky.refine_solutions` under a refining
    policy (``bf16_refined``)."""

    def fold_errors(self, state, h_tr, g_tr, x_f, y_f, lams, aux, bk):
        thetas = state.solve(lams, g_tr, backend=bk)        # (k, c, h)
        if bk.precision.refine_iters:   # bf16_refined: fp32 residual sweep
            thetas = picholesky.refine_solutions(state, h_tr, g_tr, lams,
                                                 thetas, backend=bk)
        return _errors_from_thetas(thetas, x_f, y_f)


@dataclasses.dataclass(frozen=True, eq=False)
class PiCholeskyStrategy(_InterpolantErrors, StrategyBase):
    """Algorithm 1 per fold: g exact factorizations + a polynomial fit;
    the dense sweep reads the interpolant only (fused Horner + packed
    substitution, no factor of the sweep is materialized)."""

    g: int = 4
    degree: int = 2
    block: int = 128
    basis: str = "monomial"
    chol_fn: Optional[Callable] = None
    name: str = "picholesky"

    def n_exact_chol(self, k, q):
        return k * self.g

    def prepare(self, x_folds, y_folds, h_tr, g_tr, lams, bk):
        return _sample_grid(lams, self.g)

    def fold_state(self, h_tr, g_tr, aux, bk):
        return picholesky.fit(h_tr, aux, self.degree, block=self.block,
                              basis=self.basis, chol_fn=self.chol_fn,
                              backend=bk)


@dataclasses.dataclass(frozen=True, eq=False)
class PiCholeskyWarmstart(_InterpolantErrors, StrategyBase):
    """Cross-fold warm-starting (paper §7 future work;
    ``src/repro/core/engine.py:369``).

    An anchor fit on fold 0 (``g_first`` factorizations over the λ range,
    in ``prepare``) gives the coefficient prior Θ⁰.  Every fold then refits
    only the residual from ``g_rest`` fresh factorizations,

        Θ_f = Θ⁰ + argmin_Δ ‖V_r Δ − (T_f − V_r Θ⁰)‖² + μ‖S Δ‖²,

    S² = diag(V_rᵀV_r), so the damping is relative per monomial order.  All
    folds refresh at once: one Cholesky call over the (k, g_rest) shifted
    Hessians and one ``pack_tril``.  The damped (r+1)² solve runs on the
    host at the policy's fit dtype and is applied to V_rᵀ first, then to
    the residual targets (the reference solves against V_rᵀ R; the two
    differ by summation order, amplified by the condition of the barely
    regularized normal matrix when g_rest ≤ degree).
    """

    g_first: int = 4
    g_rest: int = 2
    degree: int = 2
    mu: float = 1e-6
    block: int = 128
    chol_fn: Optional[Callable] = None
    name: str = "picholesky_warmstart"

    def n_exact_chol(self, k, q):
        # anchor fit + one refresh per fold (fold 0's refresh is performed)
        return self.g_first + k * max(self.g_rest, 1)

    def prepare(self, x_folds, y_folds, h_tr, g_tr, lams, bk):
        chol = self.chol_fn or bk.cholesky
        base = picholesky.fit(h_tr[0], _sample_grid(lams, self.g_first),
                              self.degree, block=self.block, chol_fn=chol,
                              backend=bk)
        sample_rest = _sample_grid(lams, max(self.g_rest, 1))
        # the residual regression runs at the policy's fit dtype
        fit_dtype = bk.precision.fit_dtype(h_tr.dtype)
        v_rest = picholesky.vandermonde(sample_rest.cpu(), self.degree
                                        ).to(fit_dtype)
        gram = v_rest.T @ v_rest
        lhs = gram + self.mu * torch.diag(torch.diag(gram))
        # (r+1)² solve on the host, as the Θ fit's (picholesky.fit)
        proj = torch.linalg.solve(lhs, v_rest.T)          # (r+1, g_rest)
        return dict(sample_rest=sample_rest,
                    v_rest=v_rest.to(h_tr.device),
                    proj=proj.to(h_tr.device),
                    base_theta=base.theta, center=base.center)

    def fold_state(self, h_tr, g_tr, aux, bk):
        chol = self.chol_fn or bk.cholesky
        h = h_tr.shape[-1]
        eye = torch.eye(h, dtype=h_tr.dtype, device=h_tr.device)
        lam = aux["sample_rest"][:, None, None]
        factors = chol(h_tr[:, None] + lam * eye)         # (k, g_rest, h, h)
        v, base = aux["v_rest"], aux["base_theta"]
        t = bk.pack_tril(factors, self.block).to(v.dtype)  # (k, g_rest, P)
        resid = t - v @ base.to(v.dtype)
        theta = (base.to(v.dtype) + aux["proj"] @ resid).to(base.dtype)
        return picholesky.PiCholesky(theta=theta, center=aux["center"],
                                     h=h, block=self.block)


@dataclasses.dataclass(frozen=True, eq=False)
class PinrmseStrategy(StrategyBase):
    """PINRMSE straw-man (§6.5; ``src/repro/core/engine.py:550``):
    interpolate the hold-out-error curve itself from g exact evaluations —
    the paper shows it selects wrong λs.  The k·g evaluations (one batched
    Cholesky call and the dense trsm) and the curve fit at the policy's
    fit dtype run in ``prepare``; the (r+1)² solve of the fit runs on the
    host."""

    g: int = 4
    degree: int = 2
    chol_fn: Optional[Callable] = None
    name: str = "pinrmse"

    def n_exact_chol(self, k, q):
        return k * self.g

    def prepare(self, x_folds, y_folds, h_tr, g_tr, lams, bk):
        sample = _sample_grid(lams, self.g)
        thetas = solvers.solve_cholesky_sweep(h_tr, g_tr, sample,
                                              self.chol_fn, bk)
        mean_err = _errors_from_thetas(thetas, x_folds, y_folds).mean(0)
        fit_dtype = bk.precision.fit_dtype(mean_err.dtype)
        # the (r+1)² solve on the host: on the card torch.linalg.solve
        # launches library triangular solves
        v = picholesky.vandermonde(sample.cpu(), self.degree).to(fit_dtype)
        theta = torch.linalg.solve(v.T @ v, v.T @ mean_err.cpu().to(fit_dtype))
        return theta.to(h_tr.device)

    def fold_errors(self, state, h_tr, g_tr, x_f, y_f, lams, aux, bk):
        v = picholesky.vandermonde(lams, self.degree).to(aux.dtype)
        # the same curve on every fold, so the mean is the curve itself
        return (v @ aux).expand(x_f.shape[0], -1)


@dataclasses.dataclass(frozen=True, eq=False)
class SVDStrategy(StrategyBase):
    """SVD / t-SVD / r-SVD baselines on the raw design matrix
    (``src/repro/core/engine.py:451``).  Each fold's training rows are the
    other folds' raw rows, stacked once in ``prepare`` ((k, (k − 1)·n_f,
    h)); ``fold_state`` factors every fold in one batched call.

    ``mode='randomized'`` projects every fold with one Gaussian test
    matrix: ``omega`` (h, k_trunc + 10) when given, else drawn from a
    generator seeded 0 (:func:`~repro_torch.core.solvers.
    randomized_range_finder`)."""

    mode: str = "full"                 # full | truncated | randomized
    k_trunc: int = 0
    omega: Optional[torch.Tensor] = None
    name: str = "svd"

    def n_exact_chol(self, k, q):
        return 0

    def prepare(self, x_folds, y_folds, h_tr, g_tr, lams, bk):
        return _other_folds(x_folds), _other_folds(y_folds)

    def fold_state(self, h_tr, g_tr, aux, bk):
        return solvers.svd_ridge_factors(*aux, self.mode, self.k_trunc,
                                         omega=self.omega)

    def fold_errors(self, state, h_tr, g_tr, x_f, y_f, lams, aux, bk):
        return _errors_from_thetas(solvers.svd_ridge_sweep(state, lams),
                                   x_f, y_f)


@dataclasses.dataclass(frozen=True, eq=False)
class LowRankStrategy(StrategyBase):
    """Low-rank ACV (Stephenson, Udell & Broderick, arXiv:2008.10547;
    ``src/repro/core/engine.py:486``) for the n ≪ h regime: ``fold_state``
    SVDs every fold's (n_tr, h) training design into
    :class:`~repro_torch.core.solvers.LowRankFactors`; ``fold_errors``
    sweeps the grid through the Woodbury identity.  Equal to the exact
    ridge path when ``rank`` ≥ rank(X) (``None``: full min(n_tr, h)), the
    rank-r ACV approximation below it.  No factorization of H."""

    rank: Optional[int] = None
    name: str = "low_rank"

    def n_exact_chol(self, k, q):
        return 0

    def descriptor(self) -> str:
        return f"lowrank/r{'full' if self.rank is None else int(self.rank)}"

    def prepare(self, x_folds, y_folds, h_tr, g_tr, lams, bk):
        return _other_folds(x_folds)

    def fold_state(self, h_tr, g_tr, aux, bk):
        return solvers.lowrank_ridge_factors(aux, self.rank,
                                             precision=bk.precision)

    def fold_errors(self, state, h_tr, g_tr, x_f, y_f, lams, aux, bk):
        thetas = solvers.lowrank_ridge_sweep(
            state, g_tr, lams,
            compute_dtype=bk.precision.accum_dtype(g_tr.dtype))
        return _errors_from_thetas(thetas, x_f, y_f)


STRATEGIES = {
    "exact": ExactCholesky,
    "picholesky": PiCholeskyStrategy,
    "picholesky_warmstart": PiCholeskyWarmstart,
    "svd": SVDStrategy,
    "low_rank": LowRankStrategy,
    "pinrmse": PinrmseStrategy,
}


def make_strategy(name: str, **params):
    try:
        return STRATEGIES[name](**params)
    except KeyError:
        raise ValueError(
            f"unknown strategy {name!r}; have {sorted(STRATEGIES)}") from None


@dataclasses.dataclass
class CVEngine:
    """Batched k-fold × λ sweep runner.

    strategy:  a strategy instance or registry name.
    backend:   ``'auto'`` (CUDA kernels on a CUDA device, ``torch.linalg``
               on the CPU) | ``'cuda'`` | ``'reference'`` | a backend.
    block:     kernel tile size (both factorization and solve tiles).
    lam_chunk: λ streaming: ``'auto'`` sizes a chunk so its packed factors
               fit :data:`LAM_CHUNK_BUDGET_BYTES`; an ``int`` fixes it;
               ``None`` solves the whole grid in one call.
    precision: the pipeline's precision policy.
    device:    where the sweep runs; ``None`` is the CUDA device (and
               raises without one).
    """

    strategy: Union[str, StrategyBase]
    backend: BackendLike = "auto"
    block: Optional[int] = None
    lam_chunk: Union[None, int, str] = "auto"
    precision: PrecisionLike = None
    device: Optional[Union[str, torch.device]] = None

    def __post_init__(self):
        if isinstance(self.strategy, str):
            self.strategy = make_strategy(self.strategy)
        self._device = resolve_device(self.device)
        self._bk: LinalgBackend = resolve_backend(
            self.backend, block=self.block, precision=self.precision,
            device=self._device)
        self._prec = self._bk.precision

    def _stage_scope(self, label: str):
        """The counting scope of a stage-counting backend
        (:class:`~repro_torch.core.backends.CountingBackend`), else none."""
        stage = getattr(self._bk, "stage", None)
        return stage(label) if callable(stage) else contextlib.nullcontext()

    @staticmethod
    def _check_lams(lams, device) -> torch.Tensor:
        """A 1-D, non-empty λ grid on ``device``, or ``ValueError``."""
        lams = torch.as_tensor(lams, device=device)
        if lams.ndim != 1:
            raise ValueError(
                f"λ grid must be 1-D, got shape {tuple(lams.shape)}")
        if lams.shape[0] == 0:
            raise ValueError("empty λ grid (q=0): the sweep needs at least "
                             "1 candidate λ value(s)")
        return lams

    def _resolve_chunk(self, h: int, dtype) -> Optional[int]:
        if self.lam_chunk is None:
            return None
        if self.lam_chunk == "auto":
            block = getattr(self.strategy, "block", None) or self.block or 128
            return auto_lam_chunk(h, block, self._prec.store_dtype(dtype),
                                  LAM_CHUNK_BUDGET_BYTES)
        chunk = int(self.lam_chunk)
        if chunk <= 0:
            raise ValueError(f"lam_chunk must be positive, got {chunk}")
        return chunk

    def _stream_errors(self, errors_at, lams, h, dtype) -> torch.Tensor:
        """``errors_at`` over the grid, one λ chunk at a time → (k, q)."""
        q = lams.shape[0]
        chunk = self._resolve_chunk(h, dtype)
        if chunk is None or chunk >= q:
            return errors_at(lams)
        chunks, _ = chunk_lams(lams, chunk)
        return torch.cat([errors_at(c) for c in chunks], dim=1)[:, :q]

    def run(self, folds: FoldData, lams) -> CVResult:
        lams_t = self._check_lams(lams, self._device)
        folds = folds.to(self._device)
        strat, bk = self.strategy, self._bk
        k = folds.fold_hess.shape[0]
        q = lams_t.shape[0]
        h_tr = folds.hess[None] - folds.fold_hess
        g_tr = folds.grad[None] - folds.fold_grad
        with self._stage_scope("prepare"):
            aux = strat.prepare(folds.x_folds, folds.y_folds, h_tr, g_tr,
                                lams_t, bk)
        with self._stage_scope("fold_state"):
            state = strat.fold_state(h_tr, g_tr, aux, bk)

        def errors_at(lams_c):
            return strat.fold_errors(state, h_tr, g_tr, folds.x_folds,
                                     folds.y_folds, lams_c, aux, bk)

        with self._stage_scope("fold_errors"):
            errs = self._stream_errors(errors_at, lams_t, h_tr.shape[-1],
                                       h_tr.dtype)
        errs = errs.cpu().numpy()[:, :q]
        return CVResult.from_errors(
            lams_t.cpu().numpy(), errs.mean(0), strat.n_exact_chol(k, q),
            engine=dict(strategy=strat.name, backend=bk.name,
                        precision=self._prec.name, lam_chunk=self.lam_chunk,
                        device=str(self._device)))
