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
"""
from __future__ import annotations

import dataclasses
from typing import Union

import torch

from .precision import PRESETS, PrecisionLike, PrecisionPolicy, \
    resolve_precision

__all__ = ["LinalgBackend", "ReferenceBackend", "CudaBackend",
           "resolve_backend", "BackendLike", "shared_rhs"]


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


BackendLike = Union[None, str, LinalgBackend]


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
