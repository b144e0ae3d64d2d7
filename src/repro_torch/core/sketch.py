"""Row-sketch plans for sketched anchor factorization
(``src/repro/core/sketch.py``).

A :class:`SketchPlan` describes how to compress an ``(n, h)`` design block
``X`` into ``m ≪ n`` sketched rows ``S X`` whose Gram matrix
``(SX)ᵀ(SX)`` approximates the fold Hessian ``XᵀX``.  Anchor Cholesky
factors built from the sketched Gram feed the piCholesky pipeline
unchanged; the Iterative Hessian Sketch loop (Pilanci & Wainwright,
arXiv:1411.0347) then contracts the solve error geometrically with exact
residuals against the dense Hessian.

Drawing is split from applying.  :func:`draw_sketch` draws a plan's random
parts for fold ``f`` from a ``torch.Generator`` seeded from
``(plan.seed, f)`` on the data's device; :func:`sketch_rows` applies the
sketch to given draws.  torch cannot reproduce ``jax.random``'s streams,
so the same plan draws other numbers here than in the JAX package; the
parity tests hand the JAX package's draws in.  ``plan.descriptor()`` is
the reference's string letter for letter, so cache keys built from one
plan read the same in both packages.

The count sketch reduces in a fixed order (rows sorted by bucket, then one
pass per rank within a bucket, every bucket's rows summed in row order), so
two runs on the card give the same bits; a scatter-add would sum with
atomics in another order on each run.
"""
from __future__ import annotations

import dataclasses
import hashlib
import math
from typing import Any, Optional, Union

import torch

__all__ = ["SKETCH_METHODS", "SketchPlan", "as_plan", "fwht", "next_pow2",
           "draw_sketch", "sketch_rows", "sketched_gram", "fold_seed"]

SKETCH_METHODS = ("gaussian", "srht", "countsketch")


@dataclasses.dataclass(frozen=True)
class SketchPlan:
    """One reproducible row sketch of a design block.

    method:    ``'gaussian'`` (dense sub-Gaussian projection), ``'srht'``
               (subsampled randomized Hadamard transform) or
               ``'countsketch'`` (bucketed signed sums).
    m:         sketched rows; useful only when ``m ≥ h``.
    seed:      base seed; fold f draws from :func:`fold_seed`\\(seed, f).
    ihs_iters: IHS refinement iterations against the exact Hessian after
               the interpolated solve.
    """

    method: str = "countsketch"
    m: int = 256
    seed: int = 0
    ihs_iters: int = 2

    def __post_init__(self):
        if self.method not in SKETCH_METHODS:
            raise ValueError(
                f"unknown sketch method {self.method!r}; expected one of "
                f"{SKETCH_METHODS}")
        if int(self.m) <= 0:
            raise ValueError(f"sketch size m must be positive, got {self.m}")
        if int(self.ihs_iters) < 0:
            raise ValueError(f"ihs_iters must be >= 0, got {self.ihs_iters}")
        object.__setattr__(self, "m", int(self.m))
        object.__setattr__(self, "seed", int(self.seed))
        object.__setattr__(self, "ihs_iters", int(self.ihs_iters))

    def descriptor(self) -> str:
        """Cache-key string; any field change must change this."""
        return f"{self.method}/m{self.m}/seed{self.seed}/ihs{self.ihs_iters}"

    def generator(self, f_idx: int, device) -> torch.Generator:
        """The generator fold ``f_idx`` draws from, on ``device``."""
        return torch.Generator(device=device).manual_seed(
            fold_seed(self.seed, f_idx))

    def to_json(self) -> dict:
        return dict(method=self.method, m=self.m, seed=self.seed,
                    ihs_iters=self.ihs_iters)

    @classmethod
    def from_json(cls, rec: dict) -> "SketchPlan":
        return cls(method=str(rec["method"]), m=int(rec["m"]),
                   seed=int(rec.get("seed", 0)),
                   ihs_iters=int(rec.get("ihs_iters", 0)))


def fold_seed(seed: int, f_idx: int) -> int:
    """A 63-bit generator seed for (plan seed, fold index)."""
    digest = hashlib.sha256(f"sketch/{int(seed)}/{int(f_idx)}".encode())
    return int.from_bytes(digest.digest()[:8], "little") & (2 ** 63 - 1)


def as_plan(obj: Union["SketchPlan", dict, None]) -> Optional[SketchPlan]:
    """Coerce user input (``SketchPlan`` | dict | None) to a plan."""
    if obj is None or isinstance(obj, SketchPlan):
        return obj
    if isinstance(obj, dict):
        return SketchPlan(**obj)
    raise TypeError(f"cannot interpret {type(obj).__name__} as a SketchPlan")


def next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def fwht(x: torch.Tensor) -> torch.Tensor:
    """Orthonormal fast Walsh–Hadamard transform along axis 0 (a
    power-of-two length); its own inverse up to rounding."""
    n = x.shape[0]
    if n & (n - 1):
        raise ValueError(f"fwht requires a power-of-two length, got {n}")
    tail = x.shape[1:]
    h = 1
    while h < n:
        x = x.reshape(n // (2 * h), 2, h, *tail)
        a, b = x[:, 0], x[:, 1]
        x = torch.stack([a + b, a - b], dim=1)
        h *= 2
    return x.reshape(n, *tail) / math.sqrt(n)


def _rademacher(n: int, gen, dtype, device) -> torch.Tensor:
    return (torch.randint(0, 2, (n,), generator=gen, device=device)
            .to(dtype) * 2 - 1)


def draw_sketch(plan: SketchPlan, n: int, f_idx: int, *, dtype,
                device) -> dict:
    """Fold ``f_idx``'s random parts of ``plan`` for an ``n``-row block:

    * gaussian:    ``g`` (m, n) standard normal;
    * srht:        ``signs`` (n,) ±1, ``rows`` (min(m, n2),) distinct row
                   indices of the padded length n2 = next_pow2(n);
    * countsketch: ``buckets`` (n,) in [0, m), ``signs`` (n,) ±1.
    """
    gen = plan.generator(f_idx, device)
    if plan.method == "gaussian":
        return dict(g=torch.randn(plan.m, n, generator=gen, dtype=dtype,
                                  device=device))
    if plan.method == "srht":
        n2 = next_pow2(n)
        signs = _rademacher(n, gen, dtype, device)
        rows = torch.randperm(n2, generator=gen, device=device)[
            :min(plan.m, n2)]
        return dict(signs=signs, rows=rows)
    buckets = torch.randint(0, plan.m, (n,), generator=gen, device=device)
    return dict(buckets=buckets, signs=_rademacher(n, gen, dtype, device))


def _gaussian_sketch(x, m, g):
    return (g.to(x.dtype) @ x) / math.sqrt(m)


def _srht_sketch(x, signs, rows):
    n = x.shape[0]
    n2 = next_pow2(n)
    xp = x.new_zeros((n2, *x.shape[1:]))
    xp[:n] = signs.to(x.dtype)[:, None] * x
    # orthonormal H: E[(SX)ᵀSX] = XᵀX needs the n2/m subsampling scale
    return fwht(xp)[rows] * math.sqrt(n2 / rows.shape[0])


def _countsketch(x, m, buckets, signs):
    """Σ over each bucket's rows of ±x, in a fixed order: the rows sorted
    by bucket (stable), then pass j adds every bucket's j-th row — no two
    rows of a pass share a bucket, so no sum depends on a race."""
    signed = signs.to(x.dtype)[:, None] * x
    order = torch.argsort(buckets, stable=True)
    b_sorted = buckets[order]
    counts = torch.bincount(buckets, minlength=m)
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(x.shape[0], device=x.device) - starts[b_sorted]
    out = x.new_zeros((m, *x.shape[1:]))
    for j in range(int(counts.max()) if x.shape[0] else 0):
        sel = rank == j
        idx = b_sorted[sel]
        out[idx] = out[idx] + signed[order[sel]]
    return out


def sketch_rows(plan: SketchPlan, x: torch.Tensor, draws: dict
                ) -> torch.Tensor:
    """``S x`` for the plan's operator on given draws → (m', h)."""
    if plan.method == "gaussian":
        return _gaussian_sketch(x, plan.m, draws["g"])
    if plan.method == "srht":
        return _srht_sketch(x, draws["signs"], draws["rows"])
    return _countsketch(x, plan.m, draws["buckets"], draws["signs"])


def sketched_gram(plan: SketchPlan, x: torch.Tensor, f_idx: int, *,
                  accum_dtype: Any = None,
                  draws: Optional[dict] = None) -> torch.Tensor:
    """Sketched fold Hessian ``(S X)ᵀ(S X)``, symmetrized, at the
    accumulation dtype.  ``draws`` defaults to :func:`draw_sketch` of fold
    ``f_idx``."""
    if draws is None:
        draws = draw_sketch(plan, x.shape[0], f_idx, dtype=x.dtype,
                            device=x.device)
    sx = sketch_rows(plan, x, draws)
    if accum_dtype is not None:
        sx = sx.to(accum_dtype)
    h = sx.T @ sx
    return 0.5 * (h + h.T)
