"""Cost of a CV sweep from its launch plan — the port's counterpart of
``src/repro/distributed/hlo_cost.py``.

The reference prices a candidate configuration by compiling it ahead of
time and walking the optimized HLO, expanding each ``lax.map`` λ-chunk
loop by its trip count.  The port has no HLO.  It prices the plan the
engine would run instead, without running anything.  Each strategy states
its own plan (``launch_plan``, given a :class:`PlanBuilder` that holds the
geometry and prices each kernel call); a strategy with none raises.  The
strategies' plans:

* the state stage — the blocked Cholesky of the anchors (one call of
  ``3·nt − 2`` launches: a diagonal, a panel and a trailing step per tile
  column, the last column without the latter two) and ``pack_tril``;
* the λ stage — ``interp_solve`` once per λ chunk, ⌈q_loc / chunk⌉ trips
  (a refining policy adds one ``interp_solve`` a refinement sweep), or,
  for ``exact``, the Cholesky of the chunk's shifted Hessians and the
  trsm pair per trip.

Each launch gets its FLOPs and bytes from the formulas of ``PERF.md`` §6's
bound column (``chip_smoke.py``'s ``bound_ms``: each input read once, each
output written once), multiplied by its trips.  The work PyTorch does
around the kernels (shifting the Hessians, the Θ fit's small GEMM, the
hold-out scores) is not priced: it is the same for every candidate of a
geometry.  The result keeps :class:`HloCost`'s fields
(``flops``, ``hbm_bytes``, ``wire``, ``unknown_trip_loops``) and adds
``launches`` (what the roofline's launch term multiplies), the kernel
``calls`` per engine stage (what a
:class:`~repro_torch.core.backends.CountingBackend` counts) and
``temp_bytes``, the plan's largest live working set.

On a mesh every number is per device, for the busiest device: fold group
0's ``k / n_fold`` folds on its share of the λ grid, ⌈q / n_lam⌉ λs.
``wire`` holds the bytes the mesh moves: the fold group's inputs to its
device (``scatter``), its fitted state along the λ axis (``broadcast``)
and the errors back to the engine's device (``gather``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from .dtype_bytes import itemsize

__all__ = ["HloCost", "PlanCost", "Launch", "PlanBuilder", "chol_launches",
           "plan_sweep", "price_sweep", "engine_cost"]


def chol_launches(h: int, block: int) -> int:
    """CUDA launches of one blocked Cholesky call: ``3·nt − 2``."""
    return 3 * (-(-h // block)) - 2


@dataclasses.dataclass(frozen=True)
class Launch:
    """``calls`` calls of one kernel wrapper in one engine stage, with the
    work of one call."""

    kernel: str          # the backend method: cholesky, pack_tril, ...
    stage: str           # prepare | fold_state | fold_errors
    calls: int
    launches: int        # CUDA launches of one call
    flops: float         # of one call
    bytes: float         # of one call
    state_bytes: float = 0.0   # of the fitted state one call reads


@dataclasses.dataclass
class HloCost:
    """The reference walker's result fields (per device)."""

    flops: float = 0.0
    hbm_bytes: float = 0.0
    wire: Dict[str, float] = dataclasses.field(default_factory=dict)
    unknown_trip_loops: int = 0

    @property
    def wire_bytes(self) -> float:
        return sum(self.wire.values())


@dataclasses.dataclass
class PlanCost(HloCost):
    launches: int = 0
    trips: int = 0
    calls: Dict[str, Dict[str, int]] = dataclasses.field(
        default_factory=dict)
    temp_bytes: float = 0.0
    plan: tuple = ()

    def stage_calls(self, stage: str, kernel: str) -> int:
        return self.calls.get(stage, {}).get(kernel, 0)


def _tri(h: int) -> int:
    return h * (h + 1) // 2


def _packed(h: int, block: int) -> int:
    nt = -(-h // block)
    return nt * (nt + 1) // 2 * block * block


@dataclasses.dataclass(frozen=True)
class PlanBuilder:
    """The geometry of one sweep on the busiest device, and the priced
    :class:`Launch` of each kernel call a strategy's ``launch_plan`` names.

    ``k_loc`` folds and ``q_loc`` λs on the device, ``c`` λs a chunk in
    ``trips`` chunks; ``block`` is the backend's Cholesky tile, ``isz``
    the accumulation dtype's bytes and ``store`` the storage dtype's."""

    h: int
    k: int
    k_loc: int
    q_loc: int
    c: int
    trips: int
    block: int
    isz: int
    store: int
    precision: object

    def cholesky(self, stage, nb, calls=1):
        h = self.h
        return Launch("cholesky", stage, calls, chol_launches(h, self.block),
                      nb * h ** 3 / 3, nb * (_tri(h) + h * h) * self.isz)

    def pack(self, stage, nb, block):
        h = self.h
        return Launch("pack_tril", stage, 1, 1, 0.0,
                      nb * (_tri(h) + _packed(h, block)) * self.isz)

    def trsm_pair(self, stage, nb, calls):
        # the pair's bound (both sweeps) split over its two launches
        h = self.h
        return Launch("solve_lower", stage, 2 * calls, 1, nb * h * h,
                      nb * (_tri(h) + 2 * h) * self.isz / 2)

    def interp(self, stage, block, degree, calls, rhs_per_lam=False):
        """``calls`` trips of ``interp_solve`` over the device's folds at
        the chunk; the Θ it reads is the fitted state the λ axis
        broadcasts."""
        k, c, h = self.k_loc, self.c, self.h
        p = _packed(h, block)
        theta = k * (degree + 1) * p * self.store
        rhs = k * c * h if rhs_per_lam else k * h
        return Launch("interp_solve", stage, calls, 1,
                      k * c * 2.0 * p * (2 * degree + 2),
                      theta + (rhs + k * c * h) * self.isz,
                      state_bytes=theta)


def plan_sweep(strategy, *, h: int, k: int, q: int, dtype, precision,
               block: int, chunk, n_fold: int = 1, n_lam: int = 1):
    """The launches of one sweep of ``strategy`` on the busiest device of
    an ``(n_fold, n_lam)`` mesh, as :class:`Launch` records from the
    strategy's ``launch_plan``, with the device's geometry (a
    :class:`PlanBuilder`).  A strategy without a launch plan (one that
    runs none of the port's kernels: ``svd``, ``low_rank``) raises
    ``ValueError``: it has nothing to tune."""
    plan_of = getattr(strategy, "launch_plan", None)
    if plan_of is None:
        raise ValueError(
            f"strategy {getattr(strategy, 'name', strategy)!r} has no launch "
            "plan, so tune= cannot price it; run it with tune=False")
    q_loc = -(-q // n_lam)
    if chunk is None or chunk >= q_loc:
        c, trips = q_loc, 1
    else:
        c, trips = int(chunk), -(-q_loc // int(chunk))
    geo = PlanBuilder(h=h, k=k, k_loc=k // n_fold, q_loc=q_loc, c=c,
                      trips=trips, block=block,
                      isz=itemsize(precision.accum_dtype(dtype)),
                      store=itemsize(precision.store_dtype(dtype)),
                      precision=precision)
    return list(plan_of(geo)), geo


def price_sweep(strategy, *, h: int, k: int, q: int, dtype, precision,
                block: int, chunk, n_fold: int = 1, n_lam: int = 1
                ) -> PlanCost:
    """The :class:`PlanCost` of one sweep (see the module docstring);
    executes nothing."""
    plan, geo = plan_sweep(strategy, h=h, k=k, q=q, dtype=dtype,
                           precision=precision, block=block, chunk=chunk,
                           n_fold=n_fold, n_lam=n_lam)
    cost = PlanCost(trips=geo.trips, plan=tuple(plan))
    for ln in plan:
        cost.flops += ln.flops * ln.calls
        cost.hbm_bytes += ln.bytes * ln.calls
        cost.launches += ln.launches * ln.calls
        rec = cost.calls.setdefault(ln.stage, {})
        rec[ln.kernel] = rec.get(ln.kernel, 0) + ln.calls
    isz, k_loc, q_loc = geo.isz, geo.k_loc, geo.q_loc
    if n_fold * n_lam > 1:
        if n_fold > 1:
            cost.wire["scatter"] = k_loc * (h * h + h) * isz
        if n_lam > 1:
            cost.wire["broadcast"] = max(
                [ln.state_bytes for ln in plan] or [0.0])
        # the engine's device receives every other device's errors
        cost.wire["gather"] = (n_fold * n_lam - 1) * k_loc * q_loc * isz
    # live working set: the largest of the state stage's (shifted anchors
    # and their factors, the packed targets) and a trip's
    state_set = max([ln.bytes for ln in plan if ln.stage != "fold_errors"]
                    or [0.0])
    trip_set = max([ln.bytes for ln in plan if ln.stage == "fold_errors"]
                   or [0.0])
    cost.temp_bytes = float(max(state_set, trip_set)
                            + k_loc * q_loc * isz)
    return cost


def _dtype(d) -> torch.dtype:
    return d if isinstance(d, torch.dtype) else getattr(torch, str(d))


def engine_cost(engine, k: int, h: int, q: int, dtype):
    """``(PlanCost, chips)`` of ``engine``'s sweep at a geometry: its
    strategy, kernel block, resolved λ chunk and mesh."""
    from . import sharding as shardlib
    mesh = engine._resolve_mesh(k)
    engine._check_fold_axis(mesh, k)
    n_fold = 1 if mesh is None else mesh.shape[shardlib.CV_FOLD_AXIS]
    n_lam = 1 if mesh is None else mesh.shape[shardlib.CV_LAM_AXIS]
    bk = getattr(engine._bk, "inner", engine._bk)      # a counting view
    block = getattr(bk, "chol_block", None) or \
        getattr(engine.strategy, "block", None) or engine.block or 128
    cost = price_sweep(engine.strategy, h=h, k=k, q=q, dtype=_dtype(dtype),
                       precision=engine._prec, block=block,
                       chunk=engine._resolve_chunk(h, _dtype(dtype)),
                       n_fold=n_fold, n_lam=n_lam)
    return cost, n_fold * n_lam

