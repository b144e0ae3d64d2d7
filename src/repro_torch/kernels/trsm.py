"""Blocked triangular solves on dense factors, batched, as a CUDA kernel.

Replaces ``src/repro/kernels/trsm.py`` ``solve_lower_blocked`` (the Pallas
call at ``:102``, body ``_make_solve_kernel`` ``:24``): one launch per
sweep, forward for ``L w = g`` and in reverse for ``Lᵀ w = g``, a cluster
of up to 8 blocks per (factor, RHS column), right-looking, with the
diagonal tiles read and inverted in the kernel unless the caller gives
their inverses (``csrc/tri_solve.cuh``).  The block B is a compile-time
parameter, one of :data:`_build.BLOCKS`.  Bound by bytes; see
``csrc/trsm.cu``.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.core import packing

from . import _build, ref

__all__ = ["solve_lower_blocked"]

_ARGS = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
         + [ctypes.POINTER(ctypes.c_int), ctypes.c_void_p])


def solve_lower_blocked(l: torch.Tensor, g: torch.Tensor, block: int = 128,
                        *, transpose: bool = False,
                        inv_diag: torch.Tensor | None = None) -> torch.Tensor:
    """Solve ``L w = g`` (or ``Lᵀ w = g``) for lower-triangular ``l``
    (…, h, h); ``g`` is (…, h) or (…, h, q) with the same leading dims.

    ``inv_diag`` (…, nt, B, B), from
    :func:`~repro_torch.kernels.ref.dense_diag_inverses`, gives the
    inverses of the identity-padded diagonal tiles; without it the plain
    version inverts them, and the kernel inverts them in its prologue.
    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    (one cluster launch), and ``block`` must then be one of
    :data:`_build.BLOCKS`.
    """
    squeeze = g.ndim == l.ndim - 1
    g2 = g[..., None] if squeeze else g
    if l.device.type == "cpu":
        w = ref.solve_lower_blocked(l, g2.to(l.dtype), block,
                                    transpose=transpose, inv_diag=inv_diag)
        return w[..., 0] if squeeze else w
    _build.check_block(block, "solve_lower_blocked")
    given = () if inv_diag is None else ((inv_diag, "inverses"),)
    for t, what in ((l, "factor"), (g2, "rhs"), *given):
        _build.check_tensor(t, f"solve_lower_blocked {what}", l.dtype)
    h = l.shape[-1]
    nt = packing.num_tiles(h, block)
    lead = l.shape[:-2]
    if (l.shape[-2] != h or g2.shape[:-1] != (*lead, h)
            or (inv_diag is not None
                and inv_diag.shape != (*lead, nt, block, block))):
        shapes = [tuple(t.shape) for t in (l, g) + (
            () if inv_diag is None else (inv_diag,))]
        raise ValueError(f"solve_lower_blocked: shapes {shapes} do not "
                         f"match")
    batch, nrhs = math.prod(lead), g2.shape[-1]
    out = torch.empty_like(g2)
    if batch and nrhs and h:
        fn = _build.c_function("trsm", f"rt_trsm_{_build.suffix(l.dtype)}",
                               _ARGS)
        _build.launch_solve(
            "solve_lower_blocked", fn,
            (_build.ptr(l), _build.ptr(g2),
             None if inv_diag is None else _build.ptr(inv_diag)),
            (_build.ptr(out), batch, h, block, nrhs, int(transpose)),
            (batch * nrhs, nt, block, l.dtype), l.device)
    return out[..., 0] if squeeze else out
