"""Request-queue CV sweep server with admission batching
(``src/repro/serving/server.py``).

Tenants submit ridge-CV problems (folds, a λ grid, a precision preset); an
admission layer groups compatible geometries — mode, fold shapes, dtypes,
anchor set, precision and sketch — into one
:meth:`~repro_torch.core.engine.CVEngine.run_batch` call, and every pooled
engine shares ONE content-addressed
:class:`~repro_torch.core.factor_cache.FactorCache`, so a tenant's anchor
factorizations serve every later tenant with the same training Hessians.

Service is FIFO across admission groups (the group whose head request is
oldest goes next) and within a group, at most ``max_batch`` requests a
dispatch.  :meth:`CVSweepServer.take_responses` hands a tenant only its own
responses.  Driven synchronously from the host (``submit`` then
``step`` / ``drain``).  Under ``ServerConfig(tune='auto')`` the pooled
engines share one :class:`~repro_torch.distributed.autotune.TuningCache`,
so each admission group's geometry is tuned once per server.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any, Deque, Dict, List, Optional

import numpy as np
import torch

from .._device import resolve_device
from ..core import factor_cache as cachelib
from ..core.engine import CVEngine, PiCholeskyStrategy
from ..core.folds import CVResult, FoldData
from ..core.precision import resolve_precision
from ..distributed import autotune

__all__ = ["SweepRequest", "SweepResponse", "ServerConfig", "CVSweepServer"]


@dataclasses.dataclass
class SweepRequest:
    """One tenant's CV problem.  ``mode`` is ``'grid'`` (the dense grid
    through the stacked ``run_batch``) or ``'search'`` (adaptive λ
    refinement over the grid's range, per request, through the same
    cache); the two modes never share a group."""

    tenant: str
    folds: FoldData
    lams: Any
    precision: Optional[str] = None
    mode: str = "grid"
    request_id: int = -1          # assigned at submit()
    submitted_at: float = 0.0     # perf_counter at submit()


@dataclasses.dataclass
class SweepResponse:
    """A served result: ``latency_s`` from submit() to the end of the
    dispatch that served it; ``status`` the cache disposition ('hit',
    'refit', 'miss' or 'bypass')."""

    tenant: str
    request_id: int
    result: CVResult
    latency_s: float
    batch_size: int
    status: str


@dataclasses.dataclass(frozen=True)
class ServerConfig:
    """Admission and batching knobs.

    max_batch:     requests fused into one ``run_batch`` dispatch.
    reuse:         cache policy of every pooled engine.
    cache_bytes:   byte budget of the shared cache (``None``: unbounded).
    cache_anchors: also cache packed anchors (the no-factorization refit
                   across tenants).
    lam_chunk:     forwarded to the engines.
    search_tol:    ``tol_decades`` of ``mode='search'`` requests.
    search_wave:   λ points a wave for ``mode='search'`` (``None``: the
                   engine's default).
    tune:          ``tune=`` of every pooled engine (``'auto'``: tuned
                   from launch plans).  The engines share one tuning cache,
                   keyed by geometry, so each geometry is tuned once per
                   server, however many tenants send it.
    tune_lattice:  lattice overrides forwarded to the engines.
    """

    max_batch: int = 8
    reuse: str = "covering"
    cache_bytes: Optional[int] = None
    cache_anchors: bool = True
    lam_chunk: object = "auto"
    tune: object = False
    tune_lattice: Optional[dict] = None
    search_tol: float = 0.05
    search_wave: Optional[int] = None


class CVSweepServer:
    """Multi-tenant sweep server: one strategy and backend, a pool of
    engines keyed by precision preset, one shared factor cache, on
    ``device`` (``None``: the CUDA device)."""

    def __init__(self, strategy=None, backend: object = "auto", *,
                 config: Optional[ServerConfig] = None,
                 precision: Optional[str] = None, device=None):
        self.config = config or ServerConfig()
        self.strategy = strategy or PiCholeskyStrategy()
        self.device = resolve_device(device)
        self._backend = backend
        self._default_precision = resolve_precision(precision).name
        self.cache = cachelib.FactorCache(max_bytes=self.config.cache_bytes)
        # one tuning cache per server: every pooled engine and tenant
        # reuses a geometry's verdict
        self.tune_cache = autotune.TuningCache()
        self._engines: Dict[str, CVEngine] = {}
        self._queues: Dict[tuple, Deque[SweepRequest]] = \
            collections.OrderedDict()
        self._responses: Dict[str, List[SweepResponse]] = {}
        self._next_id = 0
        self.served = 0
        self.dispatches = 0

    def engine(self, precision: Optional[str] = None) -> CVEngine:
        """The pooled engine of a precision preset."""
        name = (resolve_precision(precision).name if precision is not None
                else self._default_precision)
        if name not in self._engines:
            self._engines[name] = CVEngine(
                strategy=self.strategy, backend=self._backend,
                precision=name, device=self.device, cache=self.cache,
                reuse=self.config.reuse,
                cache_anchors=self.config.cache_anchors,
                lam_chunk=self.config.lam_chunk, tune=self.config.tune,
                tune_cache=self.tune_cache,
                tune_lattice=self.config.tune_lattice)
        return self._engines[name]

    def _admission_key(self, req: SweepRequest) -> tuple:
        """What two requests must share to ride one stacked dispatch: mode,
        fold shapes, dtypes, anchor set, precision and sketch.  An
        unkeyable strategy gets a group of its own.  Validates the preset
        and mode without touching the pool."""
        prec = (resolve_precision(req.precision).name
                if req.precision is not None else self._default_precision)
        if req.mode not in ("grid", "search"):
            raise ValueError(f"mode must be 'grid' or 'search', "
                             f"got {req.mode!r}")
        lams = (req.lams if isinstance(req.lams, torch.Tensor)
                else torch.as_tensor(np.array(req.lams)))
        meta = self.strategy.cache_meta(lams)
        if meta is None:
            return ("solo", req.request_id)
        f = req.folds
        return (req.mode, tuple(f.fold_hess.shape), tuple(f.x_folds.shape),
                cachelib.dtype_name(f.fold_hess.dtype),
                cachelib.dtype_name(lams.dtype),
                tuple(meta["anchors"].cpu().tolist()), prec,
                meta.get("sketch", "exact"))

    def submit(self, req: SweepRequest) -> int:
        """Enqueue a request and return its id; raises (enqueuing nothing)
        on an invalid preset or mode."""
        key = self._admission_key(req)
        req.request_id = self._next_id
        self._next_id += 1
        req.submitted_at = time.perf_counter()
        if key[0] == "solo":
            key = ("solo", req.request_id)
        self._queues.setdefault(key, collections.deque()).append(req)
        return req.request_id

    @property
    def pending(self) -> int:
        return sum(len(q) for q in self._queues.values())

    def step(self) -> List[SweepResponse]:
        """Serve one batch of the group whose head request is oldest (at
        most ``max_batch`` requests); returns the responses served."""
        if not self._queues:
            return []
        key = min(self._queues, key=lambda k: self._queues[k][0].request_id)
        queue = self._queues[key]
        batch = [queue.popleft()
                 for _ in range(min(self.config.max_batch, len(queue)))]
        if not queue:
            del self._queues[key]

        eng = self.engine(batch[0].precision)
        if batch[0].mode == "search":
            results = []
            for r in batch:
                with eng._cache_scope(r.tenant):
                    results.append(eng.search(
                        r.folds, r.lams, wave=self.config.search_wave,
                        tol_decades=self.config.search_tol))
        else:
            results = eng.run_batch([(r.folds, r.lams) for r in batch],
                                    tenants=[r.tenant for r in batch])
        done = time.perf_counter()
        out = []
        for req, res in zip(batch, results):
            info = res.extras.get("engine", {}).get("cache") or {}
            resp = SweepResponse(
                tenant=req.tenant, request_id=req.request_id, result=res,
                latency_s=done - req.submitted_at, batch_size=len(batch),
                status=info.get("status", "bypass"))
            self._responses.setdefault(req.tenant, []).append(resp)
            out.append(resp)
        self.served += len(batch)
        self.dispatches += 1
        return out

    def drain(self) -> List[SweepResponse]:
        """Serve until the queues are empty."""
        out: List[SweepResponse] = []
        while self._queues:
            out.extend(self.step())
        return out

    def take_responses(self, tenant: str) -> List[SweepResponse]:
        """Pop the responses of ``tenant``, and only those."""
        return self._responses.pop(tenant, [])

    @property
    def stats(self) -> dict:
        """Serving counters and the shared cache's stats, with its
        per-tenant partitions."""
        return dict(served=self.served, dispatches=self.dispatches,
                    pending=self.pending,
                    batch_mean=(self.served / self.dispatches
                                if self.dispatches else 0.0),
                    engines=sorted(self._engines),
                    cache=self.cache.stats,
                    tuning=self.tune_cache.stats,
                    tenants={t: dict(rec)
                             for t, rec in self.cache.tenant_stats.items()})
