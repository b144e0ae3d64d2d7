"""Linear-algebra backend selection — the single ``backend=`` switch.

Each hot spot of the factor pipeline (factorize, triangular solve, pack and
unpack, packed solve, fused interpolant solve, dense interpolated factors)
has two implementations behind one object:

* :class:`ReferenceBackend` (``"reference"``) — plain ``torch.linalg``,
  correct on every device;
* :class:`CudaBackend` (``"cuda"``) — the hand-written CUDA kernels of
  :mod:`repro_torch.kernels`.  Given CUDA tensors its methods launch those
  kernels and nothing else (no cuSOLVER/cuBLAS factorization or triangular
  solve); given CPU tensors the kernel wrappers run their plain versions,
  which is how the CPU tests drive this backend.

:func:`resolve_backend` maps ``"auto"`` to ``cuda`` on a CUDA device and to
``reference`` on the CPU.  Every backend carries the pipeline's
:class:`~repro_torch.core.precision.PrecisionPolicy`.  Leading dimensions
of every argument are batch dimensions (folds, λs).

:class:`CountingBackend` wraps either and counts its factorizations and
λ-stage solves per engine stage; :func:`retile_backend` changes the kernel
tile sizes of a backend.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Union

import torch

from .precision import PRESETS, PrecisionLike, PrecisionPolicy, \
    resolve_precision

__all__ = ["LinalgBackend", "ReferenceBackend", "CudaBackend",
           "CountingBackend", "resolve_backend", "retile_backend",
           "BackendLike", "shared_rhs"]


def shared_rhs(pf, g: torch.Tensor) -> torch.Tensor:
    """The right-hand side of a packed solve, ``g`` (h,) or (h, m), shared
    by every factor of the batch ``pf.vec`` (…, P): expanded (a view) to
    (…, h[, m]), as the reference batches ``solve_packed`` with
    ``vmap(in_axes=(0, None))``."""
    if g.ndim not in (1, 2) or g.shape[0] != pf.h:
        raise ValueError(
            f"solve_packed: g must be (h,) or (h, m) with h={pf.h}, shared "
            f"by every factor of the batch; got {tuple(g.shape)}")
    return g.expand(*pf.vec.shape[:-1], *g.shape)


class LinalgBackend:
    """Interface shared by both backends."""

    name: str = "abstract"
    precision: PrecisionPolicy = PRESETS["native"]

    def with_precision(self, policy: PrecisionPolicy) -> "LinalgBackend":
        return dataclasses.replace(self, precision=policy)

    def cholesky(self, a: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def solve_lower(self, l: torch.Tensor, b: torch.Tensor, *,
                    transpose: bool = False) -> torch.Tensor:
        raise NotImplementedError

    def solve_from_factor(self, l, g: torch.Tensor) -> torch.Tensor:
        """L Lᵀ θ = g by forward + back substitution; ``l`` may be dense or
        a :class:`~repro_torch.core.packing.PackedFactor`."""
        from .packing import PackedFactor
        if isinstance(l, PackedFactor):
            return self.solve_packed(l, g)
        w = self.solve_lower(l, g)
        return self.solve_lower(l, w, transpose=True)

    def pack_tril(self, mat: torch.Tensor, block: int) -> torch.Tensor:
        raise NotImplementedError

    def unpack_tril(self, vec: torch.Tensor, h: int,
                    block: int) -> torch.Tensor:
        """Packed (…, P) → dense lower-triangular (…, h, h)."""
        raise NotImplementedError

    def solve_packed(self, pf, g: torch.Tensor) -> torch.Tensor:
        """L Lᵀ θ = g on tile-packed factor(s) ``pf.vec`` (…, P) with one
        ``g`` (h,) or (h, m) shared by the batch → (…, h[, m]) at the
        accumulation dtype."""
        raise NotImplementedError

    def interp_solve(self, theta: torch.Tensor, lams: torch.Tensor,
                     g: torch.Tensor, *, h: int, block: int, center=0.0,
                     rhs_per_lam: bool = False) -> torch.Tensor:
        """Fused interpolant evaluation + substitution at a λ chunk:
        theta (…, r+1, P), g (…, h[, m]) → (…, q, h[, m])."""
        raise NotImplementedError

    def interp_factors(self, theta: torch.Tensor, lams: torch.Tensor, *,
                       h: int, block: int, center=0.0) -> torch.Tensor:
        """Dense interpolated factors L(λ): theta (…, r+1, P), lams (q,) →
        (…, q, h, h) — the dense-factor route (evaluate, then substitute)."""
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class ReferenceBackend(LinalgBackend):
    """``torch.linalg`` path, on any device."""

    name: str = "reference"
    precision: PrecisionPolicy = PRESETS["native"]

    def cholesky(self, a):
        return torch.linalg.cholesky(
            a.to(self.precision.accum_dtype(a.dtype)))

    def solve_lower(self, l, b, *, transpose=False):
        l = l.to(self.precision.accum_dtype(l.dtype))
        squeeze = b.ndim == l.ndim - 1
        b2 = (b[..., None] if squeeze else b).to(l.dtype)
        if transpose:
            out = torch.linalg.solve_triangular(l.mT, b2, upper=True)
        else:
            out = torch.linalg.solve_triangular(l, b2, upper=False)
        return out[..., 0] if squeeze else out

    def pack_tril(self, mat, block):
        from . import packing
        return packing.pack_tril(mat, block)

    def unpack_tril(self, vec, h, block):
        from . import packing
        return packing.unpack_tril(vec, h, block)

    def solve_packed(self, pf, g):
        from . import packing
        ad = self.precision.accum_dtype(pf.vec.dtype)
        return packing.solve_packed_ref(pf.vec, shared_rhs(pf, g).to(ad),
                                        pf.h, pf.block, accum_dtype=ad)

    def interp_solve(self, theta, lams, g, *, h, block, center=0.0,
                     rhs_per_lam=False):
        from . import packing, picholesky
        ad = self.precision.accum_dtype(theta.dtype)
        model = picholesky.PiCholesky(
            theta=theta, center=torch.as_tensor(center, dtype=ad,
                                                device=theta.device),
            h=h, block=block)
        vecs = model.eval_packed(lams.reshape(-1))      # (…, q, P)
        lead = theta.shape[:-2]
        q = vecs.shape[-2]
        if not rhs_per_lam:
            extra = g.shape[len(lead):]
            g = g.unsqueeze(len(lead)).expand(*lead, q, *extra)
        return packing.solve_packed_ref(vecs, g.to(ad), h, block,
                                        accum_dtype=ad)

    def interp_factors(self, theta, lams, *, h, block, center=0.0):
        from . import picholesky
        model = picholesky.PiCholesky(
            theta=theta, center=torch.as_tensor(center, dtype=theta.dtype,
                                                device=theta.device),
            h=h, block=block)
        lams = picholesky.lam_tensor(lams, theta.device).reshape(-1)
        return self.unpack_tril(model.eval_packed(lams), h, block)


@dataclasses.dataclass(frozen=True)
class CudaBackend(LinalgBackend):
    """The hand-written CUDA kernels: blocked Cholesky, blocked trsm, tile
    pack and unpack, packed trsm, the fused Horner + packed substitution
    and Horner into dense factors.

    ``chol_block`` / ``trsm_block`` are the kernel tile sizes; the packed
    layout block is carried by the data.  Every policy runs: a policy
    whose compute dtype differs from its accumulation dtype (``bf16_store``,
    ``bf16_refined``) takes the mixed-precision variants of the Cholesky,
    the dense trsm, ``interp_solve`` and the packed trsm, as
    ``PallasBackend._dtypes`` routes them
    (``src/repro/core/backends.py:203-210``); under the native policy the
    kernels take their dtypes from the data, so a bf16 packed factor also
    runs the mixed packed trsm.  ``interp_factors`` runs at Θ's dtype
    whatever the policy, bf16 included (``:264-267``).
    """

    name: str = "cuda"
    chol_block: int = 128
    trsm_block: int = 128
    precision: PrecisionPolicy = PRESETS["native"]

    def _dtypes(self, input_dtype):
        """(compute, accum) kernel dtypes, None when the policy is native
        (every dtype inherited from the input)."""
        p = self.precision
        if p.is_native:
            return None, None
        return p.compute_dtype(input_dtype), p.accum_dtype(input_dtype)

    def cholesky(self, a):
        from repro_torch.kernels.chol_blocked import cholesky_blocked
        cd, ad = self._dtypes(a.dtype)
        return cholesky_blocked(a.contiguous(), self.chol_block,
                                compute_dtype=cd, accum_dtype=ad)

    def solve_lower(self, l, b, *, transpose=False):
        from repro_torch.kernels.trsm import solve_lower_blocked
        cd, ad = self._dtypes(l.dtype)
        return solve_lower_blocked(l.contiguous(), b.contiguous(),
                                   self.trsm_block, transpose=transpose,
                                   compute_dtype=cd, accum_dtype=ad)

    def pack_tril(self, mat, block):
        from repro_torch.kernels.tri_pack import pack_tril
        return pack_tril(mat.contiguous(), block)

    def unpack_tril(self, vec, h, block):
        from repro_torch.kernels.tri_pack import unpack_tril
        return unpack_tril(vec.contiguous(), h, block)

    def solve_packed(self, pf, g):
        from repro_torch.kernels.packed_trsm import solve_packed
        cd, ad = self._dtypes(pf.vec.dtype)
        # the factor goes at its own dtype: a bf16 factor is read in bf16
        return solve_packed(pf.vec.contiguous(), shared_rhs(pf, g), pf.h,
                            pf.block, compute_dtype=cd, accum_dtype=ad)

    def interp_solve(self, theta, lams, g, *, h, block, center=0.0,
                     rhs_per_lam=False):
        from repro_torch.kernels.poly_interp import interp_solve
        cd, ad = self._dtypes(theta.dtype)
        # Θ goes at its store dtype: a bf16 Θ is read in bf16, half the
        # bytes of the sweep
        return interp_solve(theta.contiguous(), lams, g, h, block,
                            center=center, rhs_per_lam=rhs_per_lam,
                            compute_dtype=cd, accum_dtype=ad)

    def interp_factors(self, theta, lams, *, h, block, center=0.0):
        from repro_torch.kernels.poly_interp import interp_factors
        from . import picholesky
        lams = picholesky.lam_tensor(lams, theta.device)
        return interp_factors(theta.contiguous(), lams, h, block,
                              center=center)


class CountingBackend(LinalgBackend):
    """Delegating wrapper that counts calls to ``cholesky`` and to the
    λ-stage workhorses ``interp_solve`` and ``solve_packed``
    (``src/repro/core/backends.py:270``).

    Counts are **per call site and per stage**: :attr:`by_stage` maps a
    stage label to ``{op: calls}``; :class:`~repro_torch.core.engine.
    CVEngine` scopes its ``prepare``, ``fold_state`` and ``fold_errors``
    stages with :meth:`stage`, and calls outside any scope land in
    ``'unstaged'``.  The port runs eagerly, so a call counts once each
    time it executes, where the reference counts once per trace; a batched
    call (every fold, or every anchor, in one tensor) counts once either
    way, so :attr:`n_cholesky` counts factorization calls, not matrices.
    A cold path moves the count; a path with no factorization leaves it
    at 0.

    Transparent to ``name`` and ``precision``; :meth:`with_precision` and
    :func:`retile_backend` return views over the same counters.
    """

    def __init__(self, inner: LinalgBackend, _shared_counts: dict = None):
        self.inner = inner
        # stage label -> {op: calls}; shared by every view of this backend
        self.by_stage: dict = {} if _shared_counts is None else _shared_counts
        self._stage: str | None = None

    @property
    def n_cholesky(self) -> int:
        return sum(rec.get("cholesky", 0) for rec in self.by_stage.values())

    @property
    def name(self) -> str:
        return self.inner.name

    @property
    def precision(self) -> PrecisionPolicy:
        return self.inner.precision

    def with_precision(self, policy: PrecisionPolicy) -> "CountingBackend":
        """A view over the same counters with ``policy`` attached (this
        instance is left as it is)."""
        return CountingBackend(self.inner.with_precision(policy),
                               _shared_counts=self.by_stage)

    def reset(self) -> None:
        self.by_stage.clear()       # in place: the views share this dict

    @contextlib.contextmanager
    def stage(self, label: str):
        """Attribute the calls made inside this scope to ``label``
        (nested scopes restore the outer label on exit)."""
        prev, self._stage = self._stage, label
        try:
            yield self
        finally:
            self._stage = prev

    def stage_count(self, label: str, op: str = "cholesky") -> int:
        return self.by_stage.get(label, {}).get(op, 0)

    def _count(self, op: str) -> None:
        rec = self.by_stage.setdefault(self._stage or "unstaged", {})
        rec[op] = rec.get(op, 0) + 1

    def cholesky(self, a):
        self._count("cholesky")
        return self.inner.cholesky(a)

    def solve_lower(self, l, b, *, transpose=False):
        return self.inner.solve_lower(l, b, transpose=transpose)

    def solve_from_factor(self, l, g):
        return self.inner.solve_from_factor(l, g)

    def pack_tril(self, mat, block):
        return self.inner.pack_tril(mat, block)

    def unpack_tril(self, vec, h, block):
        return self.inner.unpack_tril(vec, h, block)

    def solve_packed(self, pf, g):
        self._count("solve_packed")
        return self.inner.solve_packed(pf, g)

    def interp_solve(self, theta, lams, g, *, h, block, center=0.0,
                     rhs_per_lam=False):
        self._count("interp_solve")
        return self.inner.interp_solve(theta, lams, g, h=h, block=block,
                                       center=center,
                                       rhs_per_lam=rhs_per_lam)

    def interp_factors(self, theta, lams, *, h, block, center=0.0):
        return self.inner.interp_factors(theta, lams, h=h, block=block,
                                         center=center)


BackendLike = Union[None, str, LinalgBackend]


def retile_backend(bk: LinalgBackend, *, chol_block: int | None = None,
                   trsm_block: int | None = None) -> LinalgBackend:
    """``bk`` with the given kernel tile sizes.  A :class:`CudaBackend`
    takes only the blocks its kernels are compiled for
    (:data:`repro_torch.kernels._build.BLOCKS`; ``ValueError`` otherwise);
    a backend without kernel tiles (reference) comes back unchanged; a
    :class:`CountingBackend` is re-wrapped around its retiled inner
    backend, sharing its counters."""
    if chol_block is None and trsm_block is None:
        return bk
    if isinstance(bk, CountingBackend):
        inner = retile_backend(bk.inner, chol_block=chol_block,
                               trsm_block=trsm_block)
        if inner is bk.inner:
            return bk
        return CountingBackend(inner, _shared_counts=bk.by_stage)
    if isinstance(bk, CudaBackend):
        from repro_torch.kernels import _build
        for what, b in (("chol_block", chol_block), ("trsm_block",
                                                     trsm_block)):
            if b is not None:
                _build.check_block(b, f"retile_backend {what}")
        return dataclasses.replace(
            bk, chol_block=chol_block or bk.chol_block,
            trsm_block=trsm_block or bk.trsm_block)
    return bk


def resolve_backend(backend: BackendLike = None, *, block: int | None = None,
                    precision: PrecisionLike = None,
                    device=None) -> LinalgBackend:
    """Map a ``backend=`` argument to a :class:`LinalgBackend`.

    ``None`` / ``"auto"`` is ``"cuda"`` on a CUDA device (``device=None``
    means the CUDA device) and ``"reference"`` on the CPU.  ``block`` sizes
    both kernel tiles.  A backend instance keeps its own policy unless
    ``precision`` is given.
    """
    if isinstance(backend, LinalgBackend):
        if precision is not None:
            pol = resolve_precision(precision)
            if pol != backend.precision:
                backend = backend.with_precision(pol)
        return backend
    pol = resolve_precision(precision)
    if backend is None or backend == "auto":
        dev = torch.device("cuda" if device is None else device)
        backend = "cuda" if dev.type == "cuda" else "reference"
    if backend in ("reference", "ref"):
        return ReferenceBackend(precision=pol)
    if backend == "cuda":
        return CudaBackend(chol_block=block or 128, trsm_block=block or 128,
                           precision=pol)
    raise ValueError(f"unknown backend {backend!r}; expected 'auto', "
                     "'cuda', 'reference', or a LinalgBackend")
