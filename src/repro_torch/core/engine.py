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
``torch.linalg`` on the CPU.  Strategies: ``exact`` (k·q factorizations)
and ``picholesky`` (k·g factorizations + the fused interpolant sweep).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

import numpy as np
import torch

from .._device import resolve_device
from . import packing, picholesky, solvers
from .backends import BackendLike, LinalgBackend, resolve_backend
from .folds import CVResult, FoldData, holdout_nrmse
from .precision import PrecisionLike

__all__ = ["CVEngine", "ExactCholesky", "PiCholeskyStrategy",
           "make_strategy", "STRATEGIES", "LAM_CHUNK_BUDGET_BYTES",
           "auto_lam_chunk", "chunk_lams"]

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


class StrategyBase:
    def prepare(self, x_folds, y_folds, h_tr, g_tr, lams, bk):
        return ()

    def fold_state(self, h_tr, g_tr, aux, bk):
        return ()


@dataclasses.dataclass(frozen=True, eq=False)
class ExactCholesky(StrategyBase):
    """Chol baseline: factorize at every (fold, λ) — k·q factorizations."""

    name: str = "exact"

    def n_exact_chol(self, k, q):
        return k * q

    def fold_errors(self, state, h_tr, g_tr, x_f, y_f, lams, aux, bk):
        thetas = solvers.solve_cholesky_sweep(h_tr, g_tr, lams, bk)
        return _errors_from_thetas(thetas, x_f, y_f)


@dataclasses.dataclass(frozen=True, eq=False)
class PiCholeskyStrategy(StrategyBase):
    """Algorithm 1 per fold: g exact factorizations + a polynomial fit;
    the dense sweep reads the interpolant only (fused Horner + packed
    substitution, no factor of the sweep is materialized).  Under a
    refining policy (``bf16_refined``) each chunk's solves are corrected
    by :func:`~repro_torch.core.picholesky.refine_solutions`."""

    g: int = 4
    degree: int = 2
    block: int = 128
    basis: str = "monomial"
    name: str = "picholesky"

    def n_exact_chol(self, k, q):
        return k * self.g

    def prepare(self, x_folds, y_folds, h_tr, g_tr, lams, bk):
        return _sample_grid(lams, self.g)

    def fold_state(self, h_tr, g_tr, aux, bk):
        return picholesky.fit(h_tr, aux, self.degree, block=self.block,
                              basis=self.basis, backend=bk)

    def fold_errors(self, state, h_tr, g_tr, x_f, y_f, lams, aux, bk):
        thetas = state.solve(lams, g_tr, backend=bk)        # (k, c, h)
        if bk.precision.refine_iters:   # bf16_refined: fp32 residual sweep
            thetas = picholesky.refine_solutions(state, h_tr, g_tr, lams,
                                                 thetas, backend=bk)
        return _errors_from_thetas(thetas, x_f, y_f)


STRATEGIES = {"exact": ExactCholesky, "picholesky": PiCholeskyStrategy}


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
        aux = strat.prepare(folds.x_folds, folds.y_folds, h_tr, g_tr, lams_t,
                            bk)
        state = strat.fold_state(h_tr, g_tr, aux, bk)

        def errors_at(lams_c):
            return strat.fold_errors(state, h_tr, g_tr, folds.x_folds,
                                     folds.y_folds, lams_c, aux, bk)

        errs = self._stream_errors(errors_at, lams_t, h_tr.shape[-1],
                                   h_tr.dtype)
        errs = errs.cpu().numpy()[:, :q]
        return CVResult.from_errors(
            lams_t.cpu().numpy(), errs.mean(0), strat.n_exact_chol(k, q),
            engine=dict(strategy=strat.name, backend=bk.name,
                        precision=self._prec.name, lam_chunk=self.lam_chunk,
                        device=str(self._device)))
