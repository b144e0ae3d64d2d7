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
* ``picholesky_sketched`` — piCholesky over sketched anchor Hessians
  with IHS-refined solves;
* ``svd`` — SVD / t-SVD / r-SVD of the raw training design;
* ``low_rank`` — low-rank ACV through the Woodbury identity.

MChol (§6.2) is a host-side driver (:func:`repro_torch.core.cv.
cv_multilevel_cholesky`): its search is decision-dependent.

Around the sweep (``src/repro/core/engine.py:1101-2156``):

* ``cache=`` — the warm-replay path (:mod:`repro_torch.core.factor_cache`):
  a fingerprint hit skips ``fold_state``, an anchor hit refits Θ with no
  factorization, a miss runs the cold stage and populates the cache;
* :meth:`CVEngine.sweep_async` / :meth:`CVEngine.run_async` — the staged
  sweep, one partial curve per λ chunk, with early stopping; pipelined
  (no host sync between stages, one chunk of look-ahead) or serial;
* :meth:`CVEngine.search` — adaptive λ refinement in fixed-width waves;
* :meth:`CVEngine.select_interpolant`, :meth:`CVEngine.with_interpolant`
  and :meth:`CVEngine.advise_anchor` (:mod:`repro_torch.core.bound`);
* :meth:`CVEngine.run_batch` — one stacked ``fold_state`` for a batch's
  cold problems (:mod:`repro_torch.serving`).

And the reference's distribution and tuning (``src/repro/core/engine.py:
653-720, 780-941``):

* ``mesh=`` — a (folds × λ) :class:`~repro_torch.distributed.sharding.
  Mesh` of devices (``cv_mesh``): fold group i's state lives on its row's
  devices, the λ grid is padded to the λ axis and split over it, and the
  errors are gathered onto the engine's device;
* ``donate=`` — the sweep drops its own training Hessians (and
  gradients) once the state stage has consumed them and the λ stage does
  not read them;
* ``tune=`` — :mod:`repro_torch.distributed.autotune` prices the block ×
  λ-chunk × mesh lattice from launch plans and a derived engine runs the
  chosen configuration;
* :meth:`CVEngine.sweep_temp_bytes` / :meth:`CVEngine.replay_temp_bytes`
  — the sweep's measured peak memory on the card.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import (Any, Callable, Iterator, Optional, Protocol, Union,
                    runtime_checkable)

import numpy as np
import torch

from .._device import resolve_device
from ..distributed import sharding as shardlib
from ..distributed.sharding import auto_lam_chunk, chunk_lams
from . import factor_cache as cachelib
from . import packing, picholesky, solvers
from . import sketch as sketchlib
from .backends import BackendLike, LinalgBackend, resolve_backend
from .folds import CVResult, FoldData, holdout_nrmse
from .precision import PrecisionLike, map_tensors

__all__ = ["CVEngine", "CVStrategy", "SweepChunk", "ExactCholesky",
           "PiCholeskyStrategy", "PiCholeskySketched", "PiCholeskyWarmstart",
           "PinrmseStrategy", "SVDStrategy", "LowRankStrategy",
           "make_strategy", "STRATEGIES", "LAM_CHUNK_BUDGET_BYTES",
           "auto_lam_chunk", "chunk_lams"]

#: byte budget the ``lam_chunk='auto'`` heuristic sizes one chunk's packed
#: factors against.  The same value as the JAX package's, so both packages
#: cut a grid into the same chunks (:func:`~repro_torch.distributed.
#: sharding.auto_lam_chunk`; a chunk sized for the card comes from the
#: tuner's ladder).
LAM_CHUNK_BUDGET_BYTES = 16 * 1024 * 1024


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


@runtime_checkable
class CVStrategy(Protocol):
    """What the engine asks of an algorithm (``src/repro/core/engine.py:
    109``); every strategy of :data:`STRATEGIES` satisfies it.  The port's
    strategies run every fold at once: folds are the leading dimension of
    ``h_tr`` (k, h, h), ``g_tr`` (k, h) and the state."""

    name: str

    def n_exact_chol(self, k: int, q: int) -> int: ...

    def prepare(self, x_folds, y_folds, h_tr, g_tr, lams, bk): ...

    def fold_state(self, h_tr, g_tr, aux, bk): ...

    def fold_errors(self, state, h_tr, g_tr, x_f, y_f, lams, aux, bk): ...


class StrategyBase:
    """Default no-op ``prepare`` / ``fold_state``; not cacheable."""

    #: True when ``fold_state`` is a pure per-fold function of (h_tr_f,
    #: g_tr_f, anchors, params, backend) and ``prepare`` depends only on the
    #: λ grid: :meth:`CVEngine.run_batch` may then stack several problems'
    #: folds into one ``fold_state`` call and slice the state back.
    batchable_state: bool = False

    def prepare(self, x_folds, y_folds, h_tr, g_tr, lams, bk):
        return ()

    def fold_state(self, h_tr, g_tr, aux, bk):
        return ()

    #: ``launch_plan(p)``: the port's kernel calls of one sweep, as
    #: :class:`~repro_torch.distributed.plan_cost.Launch` records priced by
    #: the :class:`~repro_torch.distributed.plan_cost.PlanBuilder` ``p``
    #: (what ``tune=`` prices).  ``None``: the strategy runs none of the
    #: port's kernels, and ``tune=`` refuses it.
    launch_plan = None

    def errors_read(self, bk) -> frozenset:
        """Which of the training statistics ``fold_errors`` reads
        (``'h_tr'``, ``'g_tr'``): ``donate`` drops the others once the
        state stage has run."""
        return frozenset(("h_tr", "g_tr"))

    def cache_meta(self, lams) -> Optional[dict]:
        """Warm-replay cache support (``src/repro/core/engine.py:149``):
        ``None`` (not cacheable), or ``dict(anchors=<(g,) λ grid the fit
        factorizes at>, params=<static fit parameters>[, sketch=<anchor
        production descriptor>])``.  A cacheable strategy's ``fold_state``
        is a pure function of (training Hessians, anchors, params,
        backend), and its ``fold_errors`` never reads ``aux`` (a replayed
        sweep runs with ``aux=()``)."""
        return None


@dataclasses.dataclass(frozen=True, eq=False)
class ExactCholesky(StrategyBase):
    """Chol baseline: factorize at every (fold, λ) — k·q factorizations."""

    chol_fn: Optional[Callable] = None
    name: str = "exact"

    def n_exact_chol(self, k, q):
        return k * q

    def launch_plan(self, p):
        # each trip factors the chunk's shifted Hessians, then the trsm pair
        nb = p.k_loc * p.c
        return [p.cholesky("fold_errors", nb, p.trips),
                p.trsm_pair("fold_errors", nb, p.trips)]

    def fold_errors(self, state, h_tr, g_tr, x_f, y_f, lams, aux, bk):
        thetas = solvers.solve_cholesky_sweep(h_tr, g_tr, lams, self.chol_fn,
                                              bk)
        return _errors_from_thetas(thetas, x_f, y_f)


class _InterpolantErrors:
    """The λ stage of the piCholesky family: the fused interpolant solve
    of every fold at the chunk, corrected by
    :func:`~repro_torch.core.picholesky.refine_solutions` under a refining
    policy (``bf16_refined``)."""

    def errors_read(self, bk) -> frozenset:
        return frozenset(("h_tr", "g_tr") if bk.precision.refine_iters
                         else ("g_tr",))

    def refine_iters(self, precision) -> int:
        """Refinement sweeps ``fold_errors`` runs after the solve."""
        return precision.refine_iters

    def _state_plan(self, p, stage, nb):
        return [p.cholesky(stage, nb), p.pack(stage, nb, self.block)]

    def _errors_plan(self, p):
        # interp_solve once a trip; each refinement sweep once more, with a
        # right-hand side per λ
        out = [p.interp("fold_errors", self.block, self.degree, p.trips)]
        iters = self.refine_iters(p.precision)
        if iters:
            out.append(p.interp("fold_errors", self.block, self.degree,
                                p.trips * iters, rhs_per_lam=True))
        return out

    def fold_errors(self, state, h_tr, g_tr, x_f, y_f, lams, aux, bk):
        thetas = state.solve(lams, g_tr, backend=bk)        # (k, c, h)
        if self.refine_iters(bk.precision):   # bf16_refined: fp32 residual
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
    batchable_state = True

    def n_exact_chol(self, k, q):
        return k * self.g

    def launch_plan(self, p):
        return (self._state_plan(p, "fold_state", p.k_loc * self.g)
                + self._errors_plan(p))

    def prepare(self, x_folds, y_folds, h_tr, g_tr, lams, bk):
        return _sample_grid(lams, self.g)

    def fold_state(self, h_tr, g_tr, aux, bk):
        return picholesky.fit(h_tr, aux, self.degree, block=self.block,
                              basis=self.basis, chol_fn=self.chol_fn,
                              backend=bk)

    def cache_meta(self, lams):
        if self.chol_fn is not None:     # an opaque override: unkeyable
            return None
        return dict(anchors=_sample_grid(lams, self.g),
                    params=dict(strategy=self.name, g=self.g,
                                degree=self.degree, block=self.block,
                                basis=self.basis))

    def _fit_with_anchors(self, hess, anchors, bk):
        """(Θ, packed anchors at the storage dtype): the anchor factors of
        every fold in one Cholesky call, packed, and Θ fitted from them
        (the same arithmetic as :meth:`fold_state`)."""
        h = hess.shape[-1]
        eye = torch.eye(h, dtype=hess.dtype, device=hess.device)
        factors = bk.cholesky(hess[:, None] + anchors[:, None, None] * eye)
        vec = bk.pack_tril(factors, self.block)             # (k, g, P)
        pf = packing.PackedFactor(vec=vec, h=h, block=self.block)
        model = picholesky.fit(hess, anchors, self.degree, block=self.block,
                               basis=self.basis, factors=pf, backend=bk)
        # fit from the full-precision targets, cache at the storage dtype
        return model, vec.to(bk.precision.store_dtype(vec.dtype))

    def fold_state_and_anchors(self, h_tr, g_tr, aux, bk):
        """``fold_state`` that also returns the packed anchor factors
        (k, g, P), so the engine can cache them: a later fit of another
        degree or basis over the same anchors refits from them with no
        factorization (``src/repro/core/engine.py:240``)."""
        return self._fit_with_anchors(h_tr, aux, bk)

    def anchor_hessian(self, h_tr, x_folds, bk):
        """The Hessians the anchor factorizations run on: the training
        Hessians here; the sketched subclass substitutes its sketched
        grams, so interpolant selection scores the targets the sweep
        fits."""
        return h_tr


@dataclasses.dataclass(frozen=True, eq=False)
class PiCholeskySketched(PiCholeskyStrategy):
    """Algorithm 1 over sketched anchor Hessians — the Iterative Hessian
    Sketch (Pilanci & Wainwright, arXiv:1411.0347) behind the piCholesky
    seam (``src/repro/core/engine.py:264``).

    Each fold's anchors factorize ``H̃_f = (S X_tr)ᵀ(S X_tr)`` from
    ``m ≪ n`` sketched rows of its training design (the other folds' raw
    rows, stacked per fold), so forming the anchor Hessian costs O(m·h²)
    instead of O(n·h²).  ``fold_errors`` corrects the interpolated solves
    by ``sketch.ihs_iters`` (+ the policy's ``refine_iters``) sweeps of
    :func:`~repro_torch.core.picholesky.refine_solutions` with the exact
    Hessian: the sketched factor preconditions, the residual is exact.

    ``draws`` injects the sketch's random parts, one dict per fold (the
    :func:`~repro_torch.core.sketch.draw_sketch` layout); ``None`` draws
    them from the plan's generators.  Injected draws are not described by
    the plan, so such a strategy is not cacheable.  ``fold_state`` reads
    raw fold rows and fold indices: not batchable.
    """

    sketch: Optional[sketchlib.SketchPlan] = None
    draws: Optional[tuple] = None
    name: str = "picholesky_sketched"
    batchable_state = False

    def __post_init__(self):
        object.__setattr__(self, "sketch", sketchlib.as_plan(self.sketch))

    def _plan(self) -> sketchlib.SketchPlan:
        if self.sketch is None:
            raise ValueError(
                "picholesky_sketched needs a SketchPlan: pass "
                "CVEngine(sketch=...) or PiCholeskySketched(sketch=...)")
        return self.sketch

    def anchor_hessian(self, h_tr, x_folds, bk) -> torch.Tensor:
        """(k, h, h) sketched grams, one fold at a time (a fold's training
        rows are the other folds', in the reference's order)."""
        plan = self._plan()
        k, n_f, h = x_folds.shape
        ad = bk.precision.accum_dtype(x_folds.dtype)
        out = []
        for f in range(k):
            others = [(f + 1 + j) % k for j in range(k - 1)]
            x_tr = x_folds[others].reshape((k - 1) * n_f, h)
            draws = None if self.draws is None else {
                n: d.to(x_tr.device) for n, d in self.draws[f].items()}
            out.append(sketchlib.sketched_gram(
                plan, x_tr, f, accum_dtype=ad, draws=draws).to(x_tr.dtype))
        return torch.stack(out)

    def prepare(self, x_folds, y_folds, h_tr, g_tr, lams, bk):
        self._plan()
        return dict(anchors=_sample_grid(lams, self.g), x=x_folds)

    def fold_state(self, h_tr, g_tr, aux, bk):
        return picholesky.fit(self.anchor_hessian(None, aux["x"], bk),
                              aux["anchors"], self.degree, block=self.block,
                              basis=self.basis, chol_fn=self.chol_fn,
                              backend=bk)

    def fold_state_and_anchors(self, h_tr, g_tr, aux, bk):
        return self._fit_with_anchors(
            self.anchor_hessian(None, aux["x"], bk), aux["anchors"], bk)

    def errors_read(self, bk) -> frozenset:
        return frozenset(("h_tr", "g_tr"))

    def refine_iters(self, precision) -> int:
        return self._plan().ihs_iters + precision.refine_iters

    def fold_errors(self, state, h_tr, g_tr, x_f, y_f, lams, aux, bk):
        # the IHS loop is refine_solutions with the exact Hessian; never
        # reads aux (warm replay runs with aux=())
        thetas = state.solve(lams, g_tr, backend=bk)
        iters = self.refine_iters(bk.precision)
        if iters:
            thetas = picholesky.refine_solutions(state, h_tr, g_tr, lams,
                                                 thetas, backend=bk,
                                                 iters=iters)
        return _errors_from_thetas(thetas, x_f, y_f)

    def cache_meta(self, lams):
        meta = super().cache_meta(lams)
        if meta is None or self.draws is not None:
            return None
        meta["sketch"] = self._plan().descriptor()
        return meta


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

    def launch_plan(self, p):
        # fold 0's anchor fit in prepare, then every fold's refresh
        return (self._state_plan(p, "prepare", self.g_first)
                + self._state_plan(p, "fold_state",
                                   p.k_loc * max(self.g_rest, 1))
                + self._errors_plan(p))

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

    def cache_meta(self, lams):
        if self.chol_fn is not None:
            return None
        # Θ_f depends on both node sets: the fold-0 anchor fit and the
        # per-fold residual refresh grid
        anchors = torch.cat([_sample_grid(lams, self.g_first),
                             _sample_grid(lams, max(self.g_rest, 1))])
        return dict(anchors=anchors,
                    params=dict(strategy=self.name, g_first=self.g_first,
                                g_rest=self.g_rest, degree=self.degree,
                                mu=self.mu, block=self.block))


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

    def launch_plan(self, p):
        # the k·g evaluations in prepare, on every fold; no λ stage kernel
        return [p.cholesky("prepare", p.k * self.g),
                p.trsm_pair("prepare", p.k * self.g, 1)]

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

    def errors_read(self, bk) -> frozenset:
        return frozenset()

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

    def errors_read(self, bk) -> frozenset:
        return frozenset()

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

    def errors_read(self, bk) -> frozenset:
        return frozenset(("g_tr",))

    def fold_errors(self, state, h_tr, g_tr, x_f, y_f, lams, aux, bk):
        thetas = solvers.lowrank_ridge_sweep(
            state, g_tr, lams,
            compute_dtype=bk.precision.accum_dtype(g_tr.dtype))
        return _errors_from_thetas(thetas, x_f, y_f)

    def cache_meta(self, lams):
        # a λ-independent state: an empty anchor grid, so every grid over
        # the same problem derives the same key; block 0 (unpacked state)
        return dict(anchors=lams.new_zeros((0,)),
                    params=dict(strategy=self.name, block=0,
                                rank=-1 if self.rank is None
                                else int(self.rank)),
                    sketch=self.descriptor())


STRATEGIES = {
    "exact": ExactCholesky,
    "picholesky": PiCholeskyStrategy,
    "picholesky_sketched": PiCholeskySketched,
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
class SweepChunk:
    """One completed λ chunk of a staged sweep — a partial error curve
    (``src/repro/core/engine.py:616``).  ``best_lam`` / ``best_error``
    track the running minimum over every chunk streamed so far;
    ``stopped`` marks the chunk at which early stopping ended the stream."""

    index: int               # chunk position in the stream
    start: int               # grid offset of this chunk's first λ
    n_chunks: int            # chunks the full stream would have
    lams: np.ndarray         # (c,) this chunk's λs (padding stripped)
    fold_errors: np.ndarray  # (k, c) per-fold hold-out errors
    errors: np.ndarray       # (c,) fold-mean partial curve
    best_lam: float          # running argmin λ
    best_error: float        # running min mean error
    stopped: bool            # early stop fired at this chunk
    n_exact_chol: int        # factorizations for the grid evaluated so far
    cache: Optional[dict]    # cache record (None without a cache)


def _read_async(e: torch.Tensor):
    """Start copying ``e`` to the host behind the work queued so far and
    return a function that waits for that copy only and gives the numpy
    array.  On the card the copy goes into pinned memory on the current
    stream with an event after it, so work launched later (the next λ
    chunk) keeps running while the host waits; a plain ``.cpu()`` would
    wait for it too."""
    e = e.detach()
    if e.device.type != "cuda":
        return e.numpy
    host = torch.empty(e.shape, dtype=e.dtype, pin_memory=True)
    host.copy_(e, non_blocking=True)
    done = torch.cuda.Event()
    done.record(torch.cuda.current_stream(e.device))

    def wait():
        done.synchronize()
        return host.numpy()

    return wait


def _fold_slice(state, lo: int, hi: int, k_total: int):
    """Folds ``lo:hi`` of a batched-over-folds state: every tensor whose
    leading dimension is the fold count is sliced; the rest (a shared
    center) is kept."""
    return map_tensors(
        lambda v: v[lo:hi] if v.ndim and v.shape[0] == k_total else v, state)


def _to(tree, device):
    """Every tensor of ``tree`` on ``device``."""
    return map_tensors(lambda t: t.to(device), tree)


def _on(device: torch.device):
    """The current CUDA device set to ``device`` (nothing for the CPU)."""
    return torch.cuda.device(device) if device.type == "cuda" \
        else contextlib.nullcontext()


class _GroupStates(list):
    """A fitted state per fold group of a mesh, each on its group's first
    device (the state stage of a ``batchable_state`` strategy, split)."""


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
    cache:     a :class:`~repro_torch.core.factor_cache.FactorCache`: on a
               fingerprint hit of a cacheable strategy (``cache_meta``)
               ``fold_state`` is skipped and the cached state replays the
               grid; on a miss the cold stage runs and populates the cache.
    reuse:     ``'exact'`` (default), ``'covering'`` (also a cached Θ whose
               anchor range covers the grid's) or ``False`` (write only).
    cache_anchors: also cache the packed anchor factors, so a later fit of
               another degree or basis over the same anchors refits Θ with
               no factorization.
    sketch:    a :class:`~repro_torch.core.sketch.SketchPlan` (or its dict)
               promoting ``picholesky`` to :class:`PiCholeskySketched`.
    mesh:      ``None`` (one device), ``'auto'`` (a folds × λ mesh over
               every CUDA device; with one device the sweep runs unsharded,
               and ``extras['engine']['mesh']`` is ``None``) or a
               :class:`~repro_torch.distributed.sharding.Mesh` over the
               CV axes (``cv_mesh``, ``make_cv_mesh``).  Fold
               group i's state lives on row i's devices (a
               ``batchable_state`` strategy fits it there); the λ grid is
               edge-padded to the λ axis and split over it, and the errors
               are gathered onto ``device``.  The fold axis must divide k.
    donate:    drop the sweep's own training Hessians and gradients once
               the state stage has consumed them, where the λ stage does
               not read them (``errors_read``); ``None`` is ``True`` on the
               card and ``False`` on the CPU.  The caller's ``FoldData`` is
               never touched; the errors are the same bits.
    tune:      ``False``; ``'auto'``, which prices the block × λ-chunk ×
               mesh lattice of each new geometry from its launch plans
               (:mod:`repro_torch.distributed.autotune`, nothing runs) and
               runs the predicted-fastest configuration through a derived
               engine; or a ``TunedConfig``, which pins one.  ``'auto'``
               refuses a strategy without a launch plan (``svd``,
               ``low_rank``) with ``ValueError``.
    tune_cache: a ``TuningCache`` shared across engines (``None`` with
               ``tune='auto'``: a private one).
    tune_lattice: lattice overrides for ``autotune.tune`` (``blocks``,
               ``chunks``, ``mesh_shapes``, ``hw``, ``devices``).
    """

    strategy: Union[str, StrategyBase]
    backend: BackendLike = "auto"
    block: Optional[int] = None
    lam_chunk: Union[None, int, str] = "auto"
    precision: PrecisionLike = None
    device: Optional[Union[str, torch.device]] = None
    cache: Optional[cachelib.FactorCache] = None
    reuse: Union[bool, str] = "exact"
    cache_anchors: bool = False
    sketch: Optional[Any] = None
    mesh: Any = None
    donate: Optional[bool] = None
    tune: Any = False
    tune_cache: Any = None
    tune_lattice: Optional[dict] = None

    def __post_init__(self):
        from ..distributed.autotune import TunedConfig
        if not isinstance(self.tune, TunedConfig) \
                and self.tune not in (False, "auto"):
            raise ValueError(f"tune must be False, 'auto' or a TunedConfig; "
                             f"got {self.tune!r}")
        if not shardlib.is_cv_mesh(self.mesh) \
                and self.mesh not in (None, "auto"):
            raise ValueError(f"mesh must be None, 'auto' or a CV Mesh; got "
                             f"{self.mesh!r}")
        if isinstance(self.strategy, str):
            self.strategy = make_strategy(self.strategy)
        if self.sketch is not None:
            plan = sketchlib.as_plan(self.sketch)
            strat = self.strategy
            if isinstance(strat, PiCholeskySketched):
                if strat.sketch is None:
                    self.strategy = dataclasses.replace(strat, sketch=plan)
                elif strat.sketch != plan:
                    raise ValueError(
                        f"conflicting sketch plans: engine sketch= is "
                        f"{plan.descriptor()} but the strategy carries "
                        f"{strat.sketch.descriptor()}")
            elif type(strat) is PiCholeskyStrategy:
                self.strategy = PiCholeskySketched(
                    g=strat.g, degree=strat.degree, block=strat.block,
                    basis=strat.basis, chol_fn=strat.chol_fn, sketch=plan)
            else:
                raise ValueError(
                    "sketch= needs the picholesky strategy, got "
                    f"{getattr(strat, 'name', strat)!r}")
            self.sketch = plan
        if isinstance(self.strategy, PiCholeskySketched) \
                and self.strategy.sketch is None:
            raise ValueError(
                "picholesky_sketched needs a SketchPlan: pass "
                "CVEngine(sketch=...) or a strategy instance with sketch=")
        if self.reuse is True:
            self.reuse = "exact"
        if self.reuse not in (False, "exact", "covering"):
            raise ValueError(f"reuse must be 'exact', 'covering' or False; "
                             f"got {self.reuse!r}")
        self._device = resolve_device(self.device)
        self._bk: LinalgBackend = resolve_backend(
            self.backend, block=self.block, precision=self.precision,
            device=self._device)
        self._prec = self._bk.precision
        if self.donate is None:
            self.donate = self._device.type == "cuda"
        self._interp_engines: dict = {}   # (degree, basis) -> engine
        self._tuned_engines: dict = {}    # TunedConfig.key() -> engine

    # -- mesh --------------------------------------------------------------

    def _device_pool(self) -> list:
        """The devices a mesh of this engine may span: an explicit mesh's,
        else every CUDA device on the card, else the engine's device."""
        if shardlib.is_cv_mesh(self.mesh):
            return self.mesh.flat
        if self._device.type == "cuda":
            return [torch.device("cuda", i)
                    for i in range(torch.cuda.device_count())]
        return [self._device]

    def _resolve_mesh(self, k: int) -> Optional[shardlib.Mesh]:
        if self.mesh is None:
            return None
        if shardlib.is_cv_mesh(self.mesh):
            return self.mesh
        pool = self._device_pool()
        if len(pool) == 1:        # 'auto' on one device: unsharded
            return None
        return shardlib.make_cv_mesh(k, pool)

    @staticmethod
    def _check_fold_axis(mesh: Optional[shardlib.Mesh], k: int) -> None:
        """The engine's error, when the fold count does not tile the
        mesh's fold axis (folds cannot be padded)."""
        if mesh is None:
            return
        n_fold = mesh.shape[shardlib.CV_FOLD_AXIS]
        if k % n_fold:
            raise ValueError(
                f"{k} folds not divisible by mesh axis "
                f"{shardlib.CV_FOLD_AXIS}={n_fold}")

    def _shards(self, mesh, state, aux, h_tr, g_tr, folds: FoldData) -> list:
        """Per mesh device (rows of the fold axis, columns of the λ axis)
        what its λ stage reads, on that device: its fold group's state,
        training statistics and hold-out blocks, and ``aux``."""
        k = folds.fold_hess.shape[0]
        k_loc = k // mesh.shape[shardlib.CV_FOLD_AXIS]
        rows = []
        for i, row in enumerate(mesh.rows):
            lo, hi = i * k_loc, (i + 1) * k_loc
            st = state[i] if isinstance(state, _GroupStates) \
                else _fold_slice(state, lo, hi, k)
            rows.append([dict(
                dev=d, state=_to(st, d), aux=_to(aux, d),
                h=None if h_tr is None else h_tr[lo:hi].to(d),
                g=None if g_tr is None else g_tr[lo:hi].to(d),
                x=folds.x_folds[lo:hi].to(d), y=folds.y_folds[lo:hi].to(d))
                for d in row])
        return rows

    def _mesh_errors(self, rows: list, lams: torch.Tensor, h: int, dtype,
                     stream: bool) -> torch.Tensor:
        """The λ stage over ``lams`` on a mesh: the grid edge-padded to
        the λ axis and split over it, every device's share launched (in
        ``lam_chunk`` chunks when ``stream``), then the errors gathered
        onto the engine's device with the padding dropped → (k, q)."""
        strat, bk = self.strategy, self._bk
        lams_p, q = shardlib.pad_to_multiple(lams, len(rows[0]))
        q_loc = lams_p.shape[0] // len(rows[0])
        parts = []
        for row in rows:
            out = []
            for j, sh in enumerate(row):
                def errors_at(lams_c, sh=sh):
                    return strat.fold_errors(sh["state"], sh["h"], sh["g"],
                                             sh["x"], sh["y"], lams_c,
                                             sh["aux"], bk)

                lam_j = lams_p[j * q_loc:(j + 1) * q_loc].to(sh["dev"])
                with _on(sh["dev"]):
                    out.append(self._stream_errors(errors_at, lam_j, h, dtype)
                               if stream else errors_at(lam_j))
            parts.append(out)
        return torch.cat([torch.cat([e.to(self._device) for e in out], 1)
                          for out in parts], 0)[:, :q]

    def _donated(self, h_tr, g_tr):
        """``(h_tr, g_tr)`` with what the λ stage does not read dropped
        under ``donate`` (the sweep's own buffers: the allocator may reuse
        them)."""
        if not self.donate:
            return h_tr, g_tr
        reads = self.strategy.errors_read(self._bk)
        return (h_tr if "h_tr" in reads else None,
                g_tr if "g_tr" in reads else None)

    # -- autotuning --------------------------------------------------------

    def _apply_tuned(self, cfg, devices=None) -> "CVEngine":
        """The derived engine that runs a tuned configuration (memoized):
        the strategy's packing block and the kernel tiles at
        ``cfg.block``, the λ chunk pinned, the mesh of ``cfg.mesh_shape``
        (this engine's explicit mesh when its shape matches, else one over
        ``devices`` or :meth:`_device_pool`).  Shares the cache and the
        policy; its ``tune=False`` is the recursion guard."""
        key = cfg.key()
        if key in self._tuned_engines:
            return self._tuned_engines[key]
        from .backends import retile_backend
        strat = self.strategy
        if dataclasses.is_dataclass(strat) and any(
                f.name == "block" for f in dataclasses.fields(strat)) \
                and strat.block != cfg.block:
            strat = dataclasses.replace(strat, block=cfg.block)
        bk = retile_backend(self._bk, chol_block=cfg.block,
                            trsm_block=cfg.block)
        mesh = None
        if cfg.mesh_shape is not None:
            shape = tuple(cfg.mesh_shape)
            if shardlib.is_cv_mesh(self.mesh) and (
                    self.mesh.shape[shardlib.CV_FOLD_AXIS],
                    self.mesh.shape[shardlib.CV_LAM_AXIS]) == shape:
                mesh = self.mesh
            else:
                pool = self._device_pool() if devices is None \
                    else list(devices)
                mesh = shardlib.cv_mesh(pool, *shape)
        derived = CVEngine(
            strategy=strat, backend=bk, mesh=mesh, donate=self.donate,
            block=cfg.block, lam_chunk=int(cfg.lam_chunk),
            device=self._device, cache=self.cache, reuse=self.reuse,
            cache_anchors=self.cache_anchors, tune=False,
            tune_cache=self.tune_cache)
        self._tuned_engines[key] = derived
        return derived

    def _tuned_engine(self, folds: FoldData, lams):
        """(derived engine, chosen config) for this geometry — the tune
        dispatch of every public entry point."""
        from ..distributed import autotune
        lattice = dict(self.tune_lattice or {})
        if isinstance(self.tune, autotune.TunedConfig):
            cfg = self.tune
        else:
            if self.tune_cache is None:
                self.tune_cache = autotune.TuningCache()
            cfg = autotune.tune(self, folds,
                                self._check_lams(lams, self._device),
                                cache=self.tune_cache, **lattice)
        return self._apply_tuned(cfg, devices=lattice.get("devices")), cfg

    # -- stages ------------------------------------------------------------

    def _stage_scope(self, label: str):
        """The counting scope of a stage-counting backend
        (:class:`~repro_torch.core.backends.CountingBackend`), else none."""
        stage = getattr(self._bk, "stage", None)
        return stage(label) if callable(stage) else contextlib.nullcontext()

    def _sync(self, pipelined: bool) -> None:
        """The serial reference blocks after every stage; the pipelined
        order never does."""
        if not pipelined and self._device.type == "cuda":
            torch.cuda.synchronize(self._device)

    @staticmethod
    def _check_lams(lams, device, min_q: int = 1,
                    what: str = "sweep") -> torch.Tensor:
        """A 1-D grid of at least ``min_q`` λs on ``device``, or
        ``ValueError`` naming the problem."""
        if not isinstance(lams, torch.Tensor):
            lams = np.array(lams)          # a copy: numpy views may be
        lams = torch.as_tensor(lams, device=device)   # read-only
        if lams.ndim != 1:
            raise ValueError(
                f"λ grid must be 1-D, got shape {tuple(lams.shape)}")
        q = lams.shape[0]
        if q == 0:
            raise ValueError(f"empty λ grid (q=0): the {what} needs at least "
                             f"{min_q} candidate λ value(s)")
        if q < min_q:
            raise ValueError(
                f"λ grid has {q} value(s) but the {what} needs at least "
                f"{min_q} (a single λ defines no range to refine — "
                "use run() for a point evaluation)")
        return lams

    def _resolve_chunk(self, h: int, dtype) -> Optional[int]:
        """The λ chunk (``None``: no streaming).  ``'auto'`` budgets the
        chunk's packed factors at the policy's storage dtype."""
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
        """``errors_at`` over the grid, one λ chunk at a time → (k, q).
        Each chunk's errors go straight into one (k, q_pad) output, so
        what the stream keeps beyond a chunk's work is O(q) numbers."""
        q = lams.shape[0]
        chunk = self._resolve_chunk(h, dtype)
        if chunk is None or chunk >= q:
            return errors_at(lams)
        chunks, _ = chunk_lams(lams, chunk)
        first = errors_at(chunks[0])
        out = first.new_empty((first.shape[0], chunks.numel()))
        out[:, :chunk] = first
        del first
        for c in range(1, chunks.shape[0]):
            out[:, c * chunk:(c + 1) * chunk] = errors_at(chunks[c])
        return out[:, :q]

    @staticmethod
    def _split(folds: FoldData):
        """Each fold's training Hessian and gradient (k, h, h), (k, h)."""
        return (folds.hess[None] - folds.fold_hess,
                folds.grad[None] - folds.fold_grad)

    def _meta(self, cache=None, mesh=None, **extra) -> dict:
        """``extras['engine']``: the mesh used (its axis sizes) and whether
        the sweep donated its buffers; the ``cache`` record only when a
        cache is attached."""
        meta = dict(strategy=self.strategy.name, backend=self._bk.name,
                    precision=self._prec.name, lam_chunk=self.lam_chunk,
                    device=str(self._device),
                    mesh=None if mesh is None else dict(mesh.shape),
                    donated=bool(self.donate), **extra)
        if self.cache is not None:
            meta["cache"] = cache
        return meta

    def _cold_state(self, h_tr, g_tr, folds: FoldData, lams,
                    with_anchors: bool, pipelined: bool = True, mesh=None):
        """``prepare`` then ``fold_state`` (or ``fold_state_and_anchors``)
        over every fold in one call: ``(state, packed anchors | None,
        aux)``.  On a mesh a ``batchable_state`` strategy fits each fold
        group on its row's first device instead (:class:`_GroupStates`)."""
        strat, bk = self.strategy, self._bk
        with self._stage_scope("prepare"):
            aux = strat.prepare(folds.x_folds, folds.y_folds, h_tr, g_tr,
                                lams, bk)
        self._sync(pipelined)
        if mesh is not None and strat.batchable_state and not with_anchors:
            k_loc = h_tr.shape[0] // mesh.shape[shardlib.CV_FOLD_AXIS]
            groups = _GroupStates()
            with self._stage_scope("fold_state"):
                for i, row in enumerate(mesh.rows):
                    dev, lo = row[0], i * k_loc
                    with _on(dev):
                        groups.append(strat.fold_state(
                            h_tr[lo:lo + k_loc].to(dev),
                            g_tr[lo:lo + k_loc].to(dev), _to(aux, dev), bk))
            self._sync(pipelined)
            return groups, None, aux
        with self._stage_scope("fold_state"):
            if with_anchors:
                state, vec = strat.fold_state_and_anchors(h_tr, g_tr, aux, bk)
            else:
                state, vec = strat.fold_state(h_tr, g_tr, aux, bk), None
        self._sync(pipelined)
        pf = (packing.PackedFactor(vec=vec, h=h_tr.shape[-1],
                                   block=strat.block)
              if vec is not None else None)
        return state, pf, aux

    def _errors(self, state, h_tr, g_tr, folds: FoldData, lams, aux,
                mesh=None) -> torch.Tensor:
        """The λ stage over a whole grid, chunked → (k, q); on a mesh
        every device streams its share of the grid."""
        strat, bk = self.strategy, self._bk
        h, dtype = folds.fold_hess.shape[-1], folds.fold_hess.dtype
        if mesh is not None:
            rows = self._shards(mesh, state, aux, h_tr, g_tr, folds)
            with self._stage_scope("fold_errors"):
                return self._mesh_errors(rows, lams, h, dtype, stream=True)

        def errors_at(lams_c):
            return strat.fold_errors(state, h_tr, g_tr, folds.x_folds,
                                     folds.y_folds, lams_c, aux, bk)

        with self._stage_scope("fold_errors"):
            return self._stream_errors(errors_at, lams, h, dtype)

    # -- warm-replay cache -------------------------------------------------

    def _cache_meta(self, lams) -> Optional[dict]:
        if self.cache is None:
            return None
        return self.strategy.cache_meta(lams)

    def _make_key(self, h_tr, meta: dict) -> cachelib.CacheKey:
        return cachelib.make_key(
            h_tr, meta["anchors"], block=meta["params"]["block"],
            backend=self._bk.name, params=meta["params"],
            precision=self._prec.descriptor(),
            sketch=meta.get("sketch", "exact"))

    def _refit_from_anchors(self, pf: packing.PackedFactor, meta: dict):
        """Θ from cached packed anchor factors: one least-squares product
        per fold, no factorization (``src/repro/core/engine.py:1101``)."""
        strat = self.strategy
        with self._stage_scope("fold_state"):
            return picholesky.fit(None, meta["anchors"], strat.degree,
                                  block=strat.block, basis=strat.basis,
                                  factors=pf, backend=self._bk)

    def _acquire_cached_state(self, meta: dict, key, cold_state_fn):
        """Fingerprint → hit | anchor refit | cold populate
        (``src/repro/core/engine.py:1874``).  ``cold_state_fn(with_anchors)``
        gives ``(state, packed anchors | None)``; returns ``(entry,
        status)``."""
        strat, cache = self.strategy, self.cache
        if self.reuse:
            entry = cache.lookup(key, self.reuse)
        else:
            entry = None
            cache.misses += 1     # write-only runs are misses by definition
        status = "hit"
        if entry is None:
            with_anchors = (self.cache_anchors
                            and hasattr(strat, "fold_state_and_anchors"))
            cached_pf = (cache.get_anchors(key)
                         if self.reuse and with_anchors else None)
            if cached_pf is not None:
                state = self._refit_from_anchors(cached_pf, meta)
                entry = cache.put(key, state, cached_pf)
                status = "refit"
            else:
                state, pf = cold_state_fn(with_anchors)
                entry = cache.put(key, state, pf)
                status = "miss"
        return entry, status

    def _cache_info(self, entry, status: str, **extra) -> dict:
        # the digest of the entry served (≠ the requested key's under a
        # covering hit), so results are attributable to their Θ
        return dict(status=status, digest=entry.key.digest()[:12],
                    policy=self.reuse, **extra, **self.cache.stats)

    def _staged_state_for(self, h_tr, g_tr, folds: FoldData, lams,
                          pipelined: bool, mesh=None):
        """The state stage with its cache dispatch, shared by :meth:`run`,
        :meth:`sweep_async` and :meth:`search`: ``(state, aux, warm,
        cache_info)``.  A cacheable strategy's λ stage runs with
        ``aux=()``, warm or cold; a cached state is whole (every fold) and
        is split over a mesh by the λ stage."""
        meta = self._cache_meta(lams)
        if meta is None:
            state, _, aux = self._cold_state(h_tr, g_tr, folds, lams, False,
                                             pipelined, mesh)
            info = None if self.cache is None else dict(status="bypass")
            return state, aux, False, info
        key = self._make_key(h_tr, meta)

        def cold_state(with_anchors):
            state, pf, _ = self._cold_state(h_tr, g_tr, folds, lams,
                                            with_anchors, pipelined)
            return state, pf

        entry, status = self._acquire_cached_state(meta, key, cold_state)
        return entry.state, (), status != "miss", \
            self._cache_info(entry, status)

    # -- the sweep ---------------------------------------------------------

    def run(self, folds: FoldData, lams) -> CVResult:
        if self.tune:
            derived, cfg = self._tuned_engine(folds, lams)
            res = derived.run(folds, lams)
            res.extras["engine"]["tune"] = cfg.to_json()
            return res
        lams_t = self._check_lams(lams, self._device)
        errs, warm, info, mesh = self._sweep(folds, lams_t)
        k, q = errs.shape[0], lams_t.shape[0]
        errs = errs.cpu().numpy()[:, :q]
        return CVResult.from_errors(
            lams_t.cpu().numpy(), errs.mean(0),
            0 if warm else self.strategy.n_exact_chol(k, q),
            engine=self._meta(cache=info, mesh=mesh))

    def _sweep(self, folds: FoldData, lams_t: torch.Tensor):
        """:meth:`run`'s sweep on the device: ``(errors (k, q), warm,
        cache_info, mesh)``.  ``h_tr`` and ``g_tr`` are the sweep's own;
        under ``donate`` the λ stage gets only what it reads."""
        folds = folds.to(self._device)
        k = folds.fold_hess.shape[0]
        mesh = self._resolve_mesh(k)
        self._check_fold_axis(mesh, k)
        h_tr, g_tr = self._split(folds)
        state, aux, warm, info = self._staged_state_for(
            h_tr, g_tr, folds, lams_t, True, mesh)
        h_tr, g_tr = self._donated(h_tr, g_tr)
        errs = self._errors(state, h_tr, g_tr, folds, lams_t, aux, mesh)
        return errs, warm, info, mesh

    # -- the sweep's peak memory on the card --------------------------------

    def _card_only(self, what: str) -> None:
        if self._device.type != "cuda":
            raise NotImplementedError(
                f"{what} measures the sweep's peak on the card "
                "(torch.cuda.max_memory_allocated over one sweep); a CPU "
                "engine has no allocator to read, and no estimate is given")

    def _measured_peak(self, sweep) -> int:
        """Peak bytes the caching allocator handed out during ``sweep()``
        beyond what was allocated before it, less its result's block."""
        dev = self._device
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        out = sweep()
        torch.cuda.synchronize(dev)
        peak = torch.cuda.max_memory_allocated(dev)
        # the allocator hands out 512-byte multiples
        held = -(-out.untyped_storage().nbytes() // 512) * 512
        return int(peak - base - held)

    def sweep_temp_bytes(self, folds: FoldData, lams) -> int:
        """The unsharded sweep's peak memory on the card, beyond its inputs
        and its result (``src/repro/core/engine.py:1842``): the allocator's
        peak over one sweep (the training statistics, the state stage and
        the chunked λ stream) less what was allocated before it and the
        result's bytes.  The measurable O(chunk · P) memory contract.
        Raises ``NotImplementedError`` on a CPU engine."""
        self._card_only("sweep_temp_bytes")
        lams_t = self._check_lams(lams, self._device)
        folds = folds.to(self._device)

        def sweep():
            h_tr, g_tr = self._split(folds)
            state, _, aux = self._cold_state(h_tr, g_tr, folds, lams_t,
                                             False)
            h_tr, g_tr = self._donated(h_tr, g_tr)
            return self._errors(state, h_tr, g_tr, folds, lams_t, aux)

        return self._measured_peak(sweep)

    def replay_temp_bytes(self, folds: FoldData, lams) -> int:
        """The λ stream's peak memory alone, from a state fitted before the
        measurement (``src/repro/core/engine.py:1859``): the working set
        the policy's storage dtype governs.  Raises
        ``NotImplementedError`` on a CPU engine."""
        self._card_only("replay_temp_bytes")
        lams_t = self._check_lams(lams, self._device)
        folds = folds.to(self._device)
        h_tr, g_tr = self._split(folds)
        state, _, aux = self._cold_state(h_tr, g_tr, folds, lams_t, False)
        return self._measured_peak(
            lambda: self._errors(state, h_tr, g_tr, folds, lams_t, aux))

    # -- staged sweep ------------------------------------------------------

    def sweep_async(self, folds: FoldData, lams, *,
                    stop_tol: Optional[float] = None, stop_patience: int = 2,
                    pipelined: bool = True) -> Iterator[SweepChunk]:
        """Staged sweep: yields a :class:`SweepChunk` per λ chunk
        (``src/repro/core/engine.py:1309``).

        stop_tol:  ``None`` disables early stopping.  A float ≥ 0: a chunk
                   improves when its minimum mean error drops below
                   ``best · (1 − stop_tol)``; after ``stop_patience``
                   non-improving chunks in a row the stream stops.  A chunk
                   with a non-finite mean raises ``FloatingPointError``.
        pipelined: ``True`` launches every stage without a host sync, and a
                   full sweep launches chunk c+1 before it reads chunk c
                   (the read waits for chunk c's copy only).  ``False``
                   synchronizes the device after every stage — the serial
                   order.  Both run the same operations on the same inputs,
                   so their curves are the same bits.

        The state stage, cache dispatch included, is :meth:`run`'s (every
        fold in one call); a miss populates the cache before the λ stream
        starts, so an early-stopped sweep still leaves a whole entry.
        """
        if stop_tol is not None and stop_tol < 0:
            raise ValueError(f"stop_tol must be >= 0 or None, got {stop_tol}")
        if stop_patience < 1:
            raise ValueError(
                f"stop_patience must be >= 1, got {stop_patience}")
        if self.tune:
            derived, _ = self._tuned_engine(folds, lams)
            yield from derived.sweep_async(
                folds, lams, stop_tol=stop_tol, stop_patience=stop_patience,
                pipelined=pipelined)
            return
        lams_t = self._check_lams(lams, self._device)
        lams_np = lams_t.cpu().numpy()
        folds = folds.to(self._device)
        k, q = folds.fold_hess.shape[0], lams_t.shape[0]
        h, dtype = folds.fold_hess.shape[-1], folds.fold_hess.dtype
        mesh = self._resolve_mesh(k)
        self._check_fold_axis(mesh, k)
        h_tr, g_tr = self._split(folds)
        strat, bk = self.strategy, self._bk
        chunk = self._resolve_chunk(h, dtype)
        if chunk is None or chunk > q:
            chunk = q
        if mesh is not None:     # one chunk splits evenly over the λ axis
            chunk += (-chunk) % mesh.shape[shardlib.CV_LAM_AXIS]
        chunks, _ = chunk_lams(lams_t, chunk)
        n_c = chunks.shape[0]

        state, aux, warm, cache_info = self._staged_state_for(
            h_tr, g_tr, folds, lams_t, pipelined, mesh)
        h_tr, g_tr = self._donated(h_tr, g_tr)
        rows = None if mesh is None else \
            self._shards(mesh, state, aux, h_tr, g_tr, folds)

        def dispatch(c):
            with self._stage_scope("fold_errors"):
                if rows is None:
                    e = strat.fold_errors(state, h_tr, g_tr, folds.x_folds,
                                          folds.y_folds, chunks[c], aux, bk)
                else:
                    e = self._mesh_errors(rows, chunks[c], h, dtype,
                                          stream=False)
            self._sync(pipelined)
            return _read_async(e)

        # a full pipelined sweep keeps one chunk of look-ahead; early
        # stopping decides chunk by chunk (the decision is the sync point)
        lookahead = pipelined and stop_tol is None
        best, best_lam, streak, n_eval = np.inf, float("nan"), 0, 0
        nxt = dispatch(0) if lookahead else None
        for c in range(n_c):
            read = nxt if nxt is not None else dispatch(c)
            nxt = dispatch(c + 1) if lookahead and c + 1 < n_c else None
            width = min(chunk, q - c * chunk)
            fold_errs = read()[:, :width]
            mean = fold_errs.mean(0)
            finite = np.isfinite(mean)
            if not finite.all() and stop_tol is not None:
                bad = lams_np[c * chunk + np.flatnonzero(~finite)]
                raise FloatingPointError(
                    f"non-finite hold-out mean at λ={bad[:4].tolist()} "
                    f"(chunk {c}): the early-stop search cannot rank "
                    "non-finite errors; fix the fold/precision (singular "
                    "fold? bf16 overflow → 'bf16_refined') or sweep the "
                    "full grid with stop_tol=None")
            n_eval += width
            if finite.any():
                i = int(np.flatnonzero(finite)[np.argmin(mean[finite])])
                improved = (bool(mean[i] < best * (1.0 - stop_tol))
                            if stop_tol is not None and np.isfinite(best)
                            else bool(mean[i] < best))
                if mean[i] < best:   # strict: ties keep the earlier λ
                    best = float(mean[i])
                    best_lam = float(lams_np[c * chunk + i])
            else:
                improved = False
            streak = 0 if improved else streak + 1
            stopped = (stop_tol is not None and streak >= stop_patience
                       and c + 1 < n_c)
            yield SweepChunk(
                index=c, start=c * chunk, n_chunks=n_c,
                lams=lams_np[c * chunk: c * chunk + width],
                fold_errors=fold_errs, errors=mean, best_lam=best_lam,
                best_error=float(best), stopped=stopped,
                n_exact_chol=0 if warm else strat.n_exact_chol(k, n_eval),
                cache=cache_info)
            if stopped:
                return
        if not np.isfinite(best):
            raise FloatingPointError(
                "sweep finished with no finite hold-out mean at any λ "
                "(singular fold? overflow → try precision='bf16_refined' "
                "or fp64); refusing to report a nan λ* selection")

    def run_async(self, folds: FoldData, lams, *,
                  stop_tol: Optional[float] = None, stop_patience: int = 2,
                  pipelined: bool = True) -> CVResult:
        """:meth:`sweep_async` consumed into a :class:`CVResult` over the
        evaluated prefix of the grid; ``extras['engine']['async']`` records
        how far the stream ran."""
        if self.tune:
            derived, cfg = self._tuned_engine(folds, lams)
            res = derived.run_async(folds, lams, stop_tol=stop_tol,
                                    stop_patience=stop_patience,
                                    pipelined=pipelined)
            res.extras["engine"]["tune"] = cfg.to_json()
            return res
        parts = list(self.sweep_async(folds, lams, stop_tol=stop_tol,
                                      stop_patience=stop_patience,
                                      pipelined=pipelined))
        last = parts[-1]
        errors = np.concatenate([p.errors for p in parts])
        meta = self._meta(cache=last.cache,
                          mesh=self._resolve_mesh(folds.fold_hess.shape[0]))
        meta["async"] = dict(
            pipelined=pipelined, stop_tol=stop_tol,
            stop_patience=stop_patience, stopped=last.stopped,
            chunks_evaluated=len(parts), chunks_total=last.n_chunks,
            lams_evaluated=int(errors.shape[0]))
        return CVResult.from_errors(np.concatenate([p.lams for p in parts]),
                                    errors, last.n_exact_chol, engine=meta)

    # -- adaptive λ search -------------------------------------------------

    def search(self, folds: FoldData, lams, *, wave: Optional[int] = None,
               tol_decades: float = 0.05, plateau_tol: Optional[float] = None,
               plateau_patience: int = 2, max_waves: int = 32,
               select_interp: bool = False,
               pipelined: bool = True) -> CVResult:
        """Adaptive λ refinement over the grid's range
        (``src/repro/core/engine.py:1510``): one coarse log-spaced wave of
        ``wave`` points over [λ_min, λ_max], then waves of ``wave`` points
        strictly inside the bracket of the running minimum's evaluated
        neighbours, until the bracket is narrower than ``tol_decades``
        (or the error plateaus, or ``max_waves``).  ``wave`` defaults to
        the resolved λ chunk capped to 8 and floored at 3.  The state stage
        (cache dispatch included) runs once, as in :meth:`sweep_async`.
        ``select_interp`` runs :meth:`select_interpolant` first and
        searches with its choice.  Returns a :class:`CVResult` over every
        evaluated λ, sorted; the trace is ``extras['engine']['search']``.
        """
        if tol_decades <= 0:
            raise ValueError(f"tol_decades must be > 0, got {tol_decades}")
        if plateau_tol is not None and plateau_tol < 0:
            raise ValueError(
                f"plateau_tol must be >= 0 or None, got {plateau_tol}")
        if plateau_patience < 1:
            raise ValueError(
                f"plateau_patience must be >= 1, got {plateau_patience}")
        if max_waves < 1:
            raise ValueError(f"max_waves must be >= 1, got {max_waves}")
        if self.tune:
            derived, cfg = self._tuned_engine(folds, lams)
            res = derived.search(
                folds, lams, wave=wave, tol_decades=tol_decades,
                plateau_tol=plateau_tol, plateau_patience=plateau_patience,
                max_waves=max_waves, select_interp=select_interp,
                pipelined=pipelined)
            res.extras["engine"]["tune"] = cfg.to_json()
            return res
        if select_interp:
            sel = self.select_interpolant(folds, lams)
            res = self.with_interpolant(sel["degree"], sel["basis"]).search(
                folds, lams, wave=wave, tol_decades=tol_decades,
                plateau_tol=plateau_tol, plateau_patience=plateau_patience,
                max_waves=max_waves, pipelined=pipelined)
            res.extras["engine"]["interp_selection"] = sel
            return res
        lams_t = self._check_lams(lams, self._device, min_q=2,
                                  what="adaptive λ-search")
        lams_np = lams_t.cpu().numpy()
        if np.any(lams_np <= 0):
            raise ValueError("adaptive λ-search refines over log-λ: "
                             "every grid value must be positive")
        folds = folds.to(self._device)
        k, q = folds.fold_hess.shape[0], lams_t.shape[0]
        h, dtype = folds.fold_hess.shape[-1], folds.fold_hess.dtype
        mesh = self._resolve_mesh(k)
        self._check_fold_axis(mesh, k)
        h_tr, g_tr = self._split(folds)
        strat, bk = self.strategy, self._bk
        chunk = self._resolve_chunk(h, dtype)
        if wave is None:
            w = max(3, min(8, chunk if chunk else 8))
        else:
            w = int(wave)
            if w < 3:
                raise ValueError(
                    f"wave must be >= 3 (a refinement wave needs interior "
                    f"points on both sides of the minimum), got {w}")
        if mesh is not None:     # one wave splits evenly over the λ axis
            w += (-w) % mesh.shape[shardlib.CV_LAM_AXIS]

        state, aux, warm, cache_info = self._staged_state_for(
            h_tr, g_tr, folds, lams_t, pipelined, mesh)
        h_tr, g_tr = self._donated(h_tr, g_tr)
        rows = None if mesh is None else \
            self._shards(mesh, state, aux, h_tr, g_tr, folds)

        def eval_wave(xs):
            """Mean hold-out error at 10**xs — one λ-stage call."""
            lam_w = np.asarray(10.0 ** xs, dtype=lams_np.dtype)
            lam_t = torch.as_tensor(lam_w, device=self._device)
            with self._stage_scope("fold_errors"):
                if rows is None:
                    e = strat.fold_errors(
                        state, h_tr, g_tr, folds.x_folds, folds.y_folds,
                        lam_t, aux, bk)
                else:
                    e = self._mesh_errors(rows, lam_t, h, dtype,
                                          stream=False)
            return lam_w, e.cpu().numpy().mean(0)

        lo = float(np.log10(lams_np.min()))
        hi = float(np.log10(lams_np.max()))
        xs_all = np.empty(0)
        lams_all = np.empty(0, dtype=lams_np.dtype)
        errs_all = np.empty(0)
        best, best_x, waves, streak = np.inf, lo, 0, 0
        width = hi - lo
        stopped_on = "max_waves"
        next_xs = np.linspace(lo, hi, w)
        while True:
            lam_w, mean = eval_wave(next_xs)
            waves += 1
            finite = np.isfinite(mean)
            if not finite.any():
                raise FloatingPointError(
                    f"adaptive λ-search wave {waves} produced no finite "
                    f"hold-out mean (λ∈[{lam_w.min():.3g}, "
                    f"{lam_w.max():.3g}]): cannot rank the bracket "
                    "(singular fold? overflow → 'bf16_refined'/fp64)")
            xs_all = np.concatenate([xs_all, next_xs])
            lams_all = np.concatenate([lams_all, lam_w])
            errs_all = np.concatenate([errs_all, mean])
            prev_best = best
            j = int(np.flatnonzero(finite)[np.argmin(mean[finite])])
            if mean[j] < best:
                best, best_x = float(mean[j]), float(next_xs[j])
            improved = (bool(best < prev_best * (1.0 - plateau_tol))
                        if plateau_tol is not None and np.isfinite(prev_best)
                        else bool(best < prev_best))
            streak = 0 if improved else streak + 1
            # bracket: the evaluated neighbours of the running minimum
            xs_sorted = np.sort(xs_all)
            pos = int(np.searchsorted(xs_sorted, best_x))
            left = xs_sorted[pos - 1] if pos > 0 else xs_sorted[0]
            right = (xs_sorted[pos + 1] if pos + 1 < xs_sorted.shape[0]
                     else xs_sorted[-1])
            width = float(right - left)
            if width <= tol_decades:
                stopped_on = "interval"
                break
            if plateau_tol is not None and streak >= plateau_patience:
                stopped_on = "plateau"
                break
            if waves >= max_waves:
                break
            next_xs = np.linspace(left, right, w + 2)[1:-1]

        order = np.argsort(xs_all)
        n_eval = int(xs_all.shape[0])
        meta = self._meta(cache=cache_info, mesh=mesh)
        meta["search"] = dict(
            wave=w, waves=waves, lams_evaluated=n_eval, dense_q=q,
            evals_vs_grid=n_eval / q, tol_decades=tol_decades,
            plateau_tol=plateau_tol, plateau_patience=plateau_patience,
            interval_decades=width, stopped_on=stopped_on)
        return CVResult.from_errors(
            lams_all[order], errs_all[order],
            0 if warm else strat.n_exact_chol(k, n_eval), engine=meta)

    # -- interpolant selection and anchor advice ----------------------------

    def with_interpolant(self, degree: int, basis: str) -> "CVEngine":
        """This engine at another (degree, basis) of its piCholesky
        strategy, sharing backend, cache and device (memoized).  Same
        anchors, so on a cache with ``cache_anchors`` its first sweep
        refits Θ from the cached anchors with no factorization."""
        strat = self.strategy
        if not isinstance(strat, PiCholeskyStrategy):
            raise ValueError(
                "with_interpolant needs the picholesky strategy, got "
                f"{getattr(strat, 'name', strat)!r}")
        key = (int(degree), str(basis))
        if key == (strat.degree, strat.basis):
            return self
        if key not in self._interp_engines:
            self._interp_engines[key] = CVEngine(
                strategy=dataclasses.replace(strat, degree=key[0],
                                             basis=key[1]),
                backend=self._bk, mesh=self.mesh, donate=self.donate,
                block=self.block, lam_chunk=self.lam_chunk,
                device=self._device, cache=self.cache, reuse=self.reuse,
                cache_anchors=self.cache_anchors,
                tune_cache=self.tune_cache)
        return self._interp_engines[key]

    def select_interpolant(self, folds: FoldData, lams, *, degrees=None,
                           bases=("monomial", "centered")) -> dict:
        """Choose the interpolant (degree, basis) by leave-one-anchor-out
        CV against the packed anchor targets
        (:func:`~repro_torch.core.picholesky.select_interpolant`).  The
        targets come from the cache when its anchor fingerprint matches
        (no factorization); otherwise the anchors are factored here and,
        with ``cache_anchors``, parked as an anchors-only entry.  Returns
        the selection plus ``anchor_status`` ('anchors', 'cold' or
        'cold+cached'), ``g`` and the anchor grid."""
        strat, bk = self.strategy, self._bk
        if not isinstance(strat, PiCholeskyStrategy):
            raise ValueError(
                "interpolant selection needs the picholesky strategy, got "
                f"{getattr(strat, 'name', strat)!r}")
        lams_t = self._check_lams(lams, self._device, min_q=2,
                                  what="interpolant selection")
        folds = folds.to(self._device)
        anchors = _sample_grid(lams_t, strat.g)
        h_tr, _ = self._split(folds)
        meta = self._cache_meta(lams_t)
        key = None if meta is None else self._make_key(h_tr, meta)
        pf = (self.cache.get_anchors(key)
              if key is not None and self.reuse else None)
        status = "anchors"
        if pf is None:
            with self._stage_scope("fold_state"):
                hess = strat.anchor_hessian(h_tr, folds.x_folds, bk)
                eye = torch.eye(hess.shape[-1], dtype=hess.dtype,
                                device=hess.device)
                vec = bk.pack_tril(
                    bk.cholesky(hess[:, None] + anchors[:, None, None] * eye),
                    strat.block)
            vec = vec.to(self._prec.store_dtype(vec.dtype))
            pf = packing.PackedFactor(vec=vec, h=int(h_tr.shape[-1]),
                                      block=strat.block)
            status = "cold"
            if key is not None and self.cache_anchors:
                self.cache.put(key, None, pf)   # anchors-only entry
                status = "cold+cached"
        sel = picholesky.select_interpolant(pf.vec, anchors, degrees,
                                            bases=bases, backend=bk)
        sel["anchor_status"] = status
        sel["g"] = strat.g
        sel["anchors"] = anchors.cpu().numpy().tolist()
        return sel

    def advise_anchor(self, folds: FoldData, lams, *, probe_dim: int = 32,
                      n_grid: int = 5) -> dict:
        """Bound-guided anchor placement (``src/repro/core/engine.py:1808``):
        the Thm 4.4 score of each anchor interval
        (:func:`~repro_torch.core.bound.anchor_advisor`) on the leading
        ``probe_dim`` principal submatrix of the fold-mean training
        Hessian, and the log-midpoint of the weakest interval as the next
        anchor.  A heuristic for placement; it enters no sweep."""
        g = getattr(self.strategy, "g", None)
        if g is None:
            raise ValueError(
                "anchor advice needs an anchored interpolant strategy "
                f"(with g sample shifts); "
                f"{getattr(self.strategy, 'name', self.strategy)!r} has none")
        from . import bound
        lams_t = self._check_lams(lams, self._device, min_q=2,
                                  what="anchor advisor")
        folds = folds.to(self._device)
        anchors = _sample_grid(lams_t, g)
        h_tr, _ = self._split(folds)
        d = min(int(probe_dim), int(h_tr.shape[-1]))
        out = bound.anchor_advisor(h_tr.mean(0)[:d, :d],
                                   anchors.cpu().numpy(), n_grid=n_grid)
        out["probe_dim"] = d
        out["anchors"] = anchors.cpu().numpy().tolist()
        return out

    # -- batched admission (multi-tenant serving) ---------------------------

    def _cache_scope(self, tenant: Optional[str]):
        """Tenant attribution on the attached cache (none without one)."""
        if self.cache is None or tenant is None:
            return contextlib.nullcontext()
        return self.cache.tenant_scope(tenant)

    def run_batch(self, problems, *, tenants=None) -> list:
        """N CV problems ``(FoldData, lams)``, one stacked ``fold_state``
        call for the cold ones, a λ stream each
        (``src/repro/core/engine.py:1986``).  Each result is bit for bit
        what a solo :meth:`run` against the same cache state gives: the
        per-fold arithmetic does not depend on the batch (the Θ product
        runs per fold).

        Per problem: fingerprint → hit | anchor refit | cold; the cold
        problems' folds are concatenated and factored in one call, then
        sliced back and cached under their own keys; a duplicate of an
        earlier problem in the batch is looked up again after that and
        served as a hit.  The fused path needs a cache, ``reuse`` on, a
        ``batchable_state`` cacheable strategy, one fold geometry and one
        anchor set; otherwise the batch runs problem by problem.
        """
        problems = [(f.to(self._device), self._check_lams(l, self._device))
                    for f, l in problems]
        if tenants is None:
            tenants = [None] * len(problems)
        if len(tenants) != len(problems):
            raise ValueError(f"{len(tenants)} tenant labels for "
                             f"{len(problems)} problems")
        if not problems:
            return []
        if self.tune:
            # an admission group shares one geometry (the server's
            # admission key): one tune on the batch's head covers it
            derived, cfg = self._tuned_engine(*problems[0])
            results = derived.run_batch(problems, tenants=tenants)
            for r in results:
                r.extras["engine"]["tune"] = cfg.to_json()
            return results
        strat = self.strategy
        metas = [self._cache_meta(l) for _, l in problems]
        fusable = (self.cache is not None and self.reuse is not False
                   and self.mesh is None and strat.batchable_state
                   and all(m is not None for m in metas))
        if fusable:
            a0, f0 = metas[0]["anchors"], problems[0][0]
            fusable = all(
                torch.equal(m["anchors"], a0)
                and f.fold_hess.shape[1:] == f0.fold_hess.shape[1:]
                and f.x_folds.shape[1:] == f0.x_folds.shape[1:]
                and f.fold_hess.dtype == f0.fold_hess.dtype
                for (f, _), m in zip(problems, metas))
        if not fusable:
            out = []
            for (f, l), t in zip(problems, tenants):
                with self._cache_scope(t):
                    out.append(self.run(f, l))
            return out

        cache = self.cache
        splits = [self._split(f) for f, _ in problems]
        keys = [self._make_key(h_tr, m) for (h_tr, _), m in zip(splits, metas)]
        with_anchors = (self.cache_anchors
                        and hasattr(strat, "fold_state_and_anchors"))

        # pass 1: fingerprint lookup; duplicates wait for the cold stage
        n = len(problems)
        entries: list = [None] * n
        statuses: list = [None] * n
        first_of: dict = {}
        cold_idx: list = []
        for i, key in enumerate(keys):
            digest = key.digest()
            if digest in first_of:
                continue
            first_of[digest] = i
            with self._cache_scope(tenants[i]):
                entry = cache.lookup(key, self.reuse)
                if entry is not None:
                    entries[i], statuses[i] = entry, "hit"
                    continue
                pf = cache.get_anchors(key) if with_anchors else None
            if pf is not None:
                state = self._refit_from_anchors(pf, metas[i])
                with self._cache_scope(tenants[i]):
                    entries[i] = cache.put(key, state, pf)
                statuses[i] = "refit"
            else:
                cold_idx.append(i)

        # pass 2: one stacked fold_state call for every cold problem
        if cold_idx:
            stacked = FoldData(
                hess=problems[cold_idx[0]][0].hess,
                grad=problems[cold_idx[0]][0].grad,
                fold_hess=torch.cat([problems[i][0].fold_hess
                                     for i in cold_idx]),
                fold_grad=torch.cat([problems[i][0].fold_grad
                                     for i in cold_idx]),
                x_folds=torch.cat([problems[i][0].x_folds for i in cold_idx]),
                y_folds=torch.cat([problems[i][0].y_folds for i in cold_idx]))
            h_stack = torch.cat([splits[i][0] for i in cold_idx])
            g_stack = torch.cat([splits[i][1] for i in cold_idx])
            state, pf, _ = self._cold_state(h_stack, g_stack, stacked,
                                            problems[cold_idx[0]][1],
                                            with_anchors)
            k_total, off = h_stack.shape[0], 0
            for i in cold_idx:
                k_i = splits[i][0].shape[0]
                st_i = _fold_slice(state, off, off + k_i, k_total)
                pf_i = (packing.PackedFactor(vec=pf.vec[off:off + k_i],
                                             h=pf.h, block=pf.block)
                        if pf is not None else None)
                off += k_i
                with self._cache_scope(tenants[i]):
                    entries[i] = cache.put(keys[i], st_i, pf_i)
                statuses[i] = "miss"

        # pass 3: in-batch duplicates are hits now (or, if the budget has
        # already evicted the first occurrence, served from its object)
        for i, key in enumerate(keys):
            if entries[i] is not None:
                continue
            with self._cache_scope(tenants[i]):
                entry = cache.lookup(key, self.reuse)
            entries[i] = entry if entry is not None \
                else entries[first_of[key.digest()]]
            statuses[i] = "hit"

        results = []
        for i, ((folds_i, lams_i), (h_tr, g_tr)) in enumerate(
                zip(problems, splits)):
            k_i, q_i = h_tr.shape[0], int(lams_i.shape[0])
            errs = self._errors(entries[i].state, h_tr, g_tr, folds_i,
                                lams_i, ()).cpu().numpy()[:, :q_i]
            info = self._cache_info(entries[i], statuses[i],
                                    tenant=tenants[i])
            results.append(CVResult.from_errors(
                lams_i.cpu().numpy(), errs.mean(0),
                strat.n_exact_chol(k_i, q_i) if statuses[i] == "miss" else 0,
                engine=self._meta(cache=info, batch=dict(
                    size=n, index=i, cold=len(cold_idx)))))
        return results
