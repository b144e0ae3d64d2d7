"""Blocked triangular solves on dense factors, batched, as a CUDA kernel.

Replaces ``src/repro/kernels/trsm.py`` ``solve_lower_blocked`` (the Pallas
call at ``:102``, body ``_make_solve_kernel`` ``:24``): one launch per
sweep, forward for ``L w = g`` and in reverse for ``Lᵀ w = g``, a cluster
of up to 8 blocks per (factor, RHS column), right-looking, with the
diagonal tiles read and inverted in the kernel (``csrc/tri_solve.cuh``).  The block B is a compile-time
parameter, one of :data:`_build.BLOCKS`.  Bound by bytes; see
``csrc/trsm.cu``.

With ``compute_dtype=bfloat16`` (the mixed variant; L and the solution
float32) every product runs on the bf16 tensor cores (``mma.sync``
m16n8k16) with float32 sums: the update rounds L_ji and the solved
segment, the solve the inverse (formed at float32) and g_i − acc_i, as
the Pallas kernel casts them (``trsm.py:42-51``); the kernel rounds each
operand once where it stores it (``tri_solve_mixed_kernel``; its plain
dataflow is :func:`~repro_torch.kernels.ref.solve_lower_blocked_stored`).
It counts under ``solve_lower_blocked_bf16``.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.core import packing

from . import _build, ref

__all__ = ["solve_lower_blocked"]

_ARGS = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
         + [ctypes.POINTER(ctypes.c_int), ctypes.c_void_p])


def solve_lower_blocked(l: torch.Tensor, g: torch.Tensor, block: int = 128,
                        *, transpose: bool = False, compute_dtype=None,
                        accum_dtype=None) -> torch.Tensor:
    """Solve ``L w = g`` (or ``Lᵀ w = g``) for lower-triangular ``l``
    (…, h, h); ``g`` is (…, h) or (…, h, q) with the same leading dims.
    ``compute_dtype`` / ``accum_dtype`` resolve as in
    :func:`~repro_torch.kernels.chol_blocked.cholesky_blocked`: ``l`` and
    ``g`` are cast to the accumulation dtype, which the solution comes
    back in.  A CPU tensor takes the plain version; a CUDA tensor launches
    the kernel (one cluster launch), and ``block`` must then be one of
    :data:`_build.BLOCKS`.
    """
    cd, ad = _build.resolve_dtypes(l.dtype, compute_dtype, accum_dtype)
    mixed = cd != ad
    l = l.to(ad)
    squeeze = g.ndim == l.ndim - 1
    g2 = (g[..., None] if squeeze else g).to(ad)
    if l.device.type == "cpu":
        w = ref.solve_lower_blocked(l, g2, block, transpose=transpose,
                                    compute_dtype=cd if mixed else None)
        return w[..., 0] if squeeze else w
    _build.check_mixed(cd, ad, "solve_lower_blocked")
    _build.check_block(block, "solve_lower_blocked")
    for t, what in ((l, "factor"), (g2, "rhs")):
        _build.check_tensor(t, f"solve_lower_blocked {what}", l.dtype)
    h = l.shape[-1]
    nt = packing.num_tiles(h, block)
    lead = l.shape[:-2]
    if l.shape[-2] != h or g2.shape[:-1] != (*lead, h):
        raise ValueError(f"solve_lower_blocked: shapes {tuple(l.shape)}, "
                         f"{tuple(g.shape)} do not match")
    batch, nrhs = math.prod(lead), g2.shape[-1]
    out = torch.empty_like(g2)
    if batch and nrhs and h:
        fn = _build.c_function("trsm", _build.entry("trsm", ad, cd), _ARGS)
        _build.launch_solve(
            _build.MIXED_NAMES["solve_lower_blocked"] if mixed
            else "solve_lower_blocked", fn,
            (_build.ptr(l), _build.ptr(g2)),
            (_build.ptr(out), batch, h, block, nrhs, int(transpose)),
            (batch * nrhs, nt, block, l.dtype), l.device)
    return out[..., 0] if squeeze else out
