"""Deterministic synthetic multi-tenant traffic
(``src/repro/serving/traffic.py``).

A seeded Zipf mix over a small population of distinct ridge problems:
request r draws problem p with probability ∝ 1/rank(p)^a, then a λ grid
from a palette of sizes over the same decades (the same anchors, so
tenants share) plus an optional shifted range (other anchors, another
admission group).  Tenants round-robin over the stream.

The schedule (problem, grid and tenant of every request) comes from the
same numpy generator calls as the reference's, so both packages schedule
the same stream for one config.  The problems' data come from the port's
:func:`~repro_torch.data.make_regression_dataset` (torch draws, not
``jax.random``'s), so their numbers differ from the reference's.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from .._device import resolve_device
from ..core.folds import make_folds
from ..core.precision import as_dtype
from ..data import make_regression_dataset
from .server import SweepRequest

__all__ = ["TrafficConfig", "zipf_weights", "make_traffic",
           "regression_folds", "log_grid", "DEFAULT_GRID_RANGE"]

#: (log10 lo, log10 hi) of the canonical test λ grid
#: (``repro.testing.strategies.DEFAULT_GRID_RANGE``)
DEFAULT_GRID_RANGE = (-3.0, 2.0)


@dataclasses.dataclass(frozen=True)
class TrafficConfig:
    """Knobs of the synthetic workload (the reference's defaults)."""

    n_requests: int = 48
    n_tenants: int = 6
    n_problems: int = 8
    h: int = 32
    n: int = 256
    k: int = 4
    zipf_a: float = 1.2
    seed: int = 0
    dtype: str = "float64"
    grid_sizes: Tuple[int, ...] = (17, 25, 33)
    shifted_grid_every: int = 0      # 0 disables the shifted-range grids
    precision: Optional[str] = None


def zipf_weights(n: int, a: float) -> np.ndarray:
    """Normalized rank-popularity weights w_r ∝ 1/r^a, r = 1..n."""
    w = 1.0 / np.arange(1, n + 1, dtype=np.float64) ** a
    return w / w.sum()


def regression_folds(h: int = 32, n: int = 256, k: int = 4, seed: int = 1,
                     dtype=torch.float64, noise: float = 1.0, device=None):
    """k-fold ``FoldData`` of a synthetic ridge problem made from ``seed``
    (the port's copy of ``repro.testing.strategies.regression_folds``)."""
    x, y = make_regression_dataset(n, h, seed=seed, noise=noise,
                                   dtype=torch.float64, device=device)
    dt = as_dtype(dtype)
    return make_folds(x.to(dt), y.to(dt), k, device=device)


def log_grid(q: int, lo: float = DEFAULT_GRID_RANGE[0],
             hi: float = DEFAULT_GRID_RANGE[1], device=None) -> torch.Tensor:
    """q-point log-spaced λ grid over [10^lo, 10^hi], float64."""
    return torch.as_tensor(np.logspace(lo, hi, q),
                           device=resolve_device(device))


def make_traffic(cfg: TrafficConfig, device=None) -> List[SweepRequest]:
    """The request stream of ``cfg`` on ``device`` (``None``: the CUDA
    device), deterministic in ``cfg.seed``."""
    dev = resolve_device(device)
    rng = np.random.default_rng(cfg.seed)
    problems = [regression_folds(h=cfg.h, n=cfg.n, k=cfg.k,
                                 seed=1000 * (cfg.seed + 1) + p,
                                 dtype=cfg.dtype, device=dev)
                for p in range(cfg.n_problems)]
    grids = [log_grid(q, device=dev) for q in cfg.grid_sizes]
    lo, hi = DEFAULT_GRID_RANGE
    shifted = log_grid(cfg.grid_sizes[0], lo + 1.0, hi + 1.0, device=dev)

    picks = rng.choice(cfg.n_problems, size=cfg.n_requests,
                       p=zipf_weights(cfg.n_problems, cfg.zipf_a))
    grid_picks = rng.integers(0, len(grids), size=cfg.n_requests)
    reqs = []
    for r in range(cfg.n_requests):
        lams = (shifted if cfg.shifted_grid_every
                and (r + 1) % cfg.shifted_grid_every == 0
                else grids[int(grid_picks[r])])
        reqs.append(SweepRequest(
            tenant=f"tenant-{r % cfg.n_tenants}",
            folds=problems[int(picks[r])], lams=lams,
            precision=cfg.precision))
    return reqs
