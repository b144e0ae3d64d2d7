"""Blocked right-looking Cholesky, batched, as CUDA kernels.

Replaces ``src/repro/kernels/chol_blocked.py`` ``cholesky_blocked``: the
Pallas calls ``_factor_panel`` (``:115``) and ``_syrk_update`` (``:130``).
Per tile column the C entry point launches (a) the blocked factor and
inverse of the diagonal tile (16-column sub-blocks, one warp each), (b)
the panel product with that inverse and (c) the lower-tile trailing
update, the float64 products on the FP64 tensor cores; (a) of the next
column runs on a look-ahead stream beside (c); see
``csrc/chol_blocked.cu``.  One call counts its 3·(hp/B) − 2 launches.
Bound by operations (h³/3 per matrix).  The block B is a compile-time
parameter of the kernels: one of :data:`_build.BLOCKS`.

When h % B = 0 the kernels read the input and write the factor into a new
tensor (no copy of the input is made); otherwise they factor an
identity-padded (…, hp, hp) copy in place.  The kernels zero the strictly
upper part, so the result is that tensor or its leading (h, h) block.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.core import packing

from . import _build, ref

__all__ = ["cholesky_blocked"]

_ARGS = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
         + [ctypes.POINTER(ctypes.c_int), ctypes.c_void_p])


def cholesky_blocked(a: torch.Tensor, block: int = 128) -> torch.Tensor:
    """Cholesky factors of SPD ``a`` (…, h, h) → lower-triangular (…, h, h).

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernels.  ``block`` must be one of :data:`_build.BLOCKS`.  The input
    is never modified.
    """
    if a.device.type == "cpu":
        return ref.cholesky_blocked(a, block)
    if block not in _build.BLOCKS:
        raise ValueError(f"cholesky_blocked: block must be one of "
                         f"{_build.BLOCKS}, got {block}")
    _build.check_tensor(a, "cholesky_blocked")
    if a.ndim < 2 or a.shape[-1] != a.shape[-2]:
        raise ValueError(f"cholesky_blocked: expected (…, h, h), got "
                         f"{tuple(a.shape)}")
    h = a.shape[-1]
    lead = a.shape[:-2]
    batch = math.prod(lead)
    hp = packing.num_tiles(h, block) * block
    if hp == h:             # the kernels read a and write a new tensor
        src = a.reshape(batch, h, h)
        work = torch.empty_like(src)
    else:                   # identity-padded copy, factored in place
        work = a.new_zeros((batch, hp, hp))
        work[:, :h, :h] = a.reshape(batch, h, h)
        idx = torch.arange(h, hp, device=a.device)
        work[:, idx, idx] = 1
        src = work
    if batch and h:
        inv = a.new_empty((batch, block, block))
        panel = a.new_empty((batch, hp, block))
        fn = _build.c_function("chol_blocked",
                               f"rt_chol_blocked_{_build.suffix(a.dtype)}",
                               _ARGS)
        launched = ctypes.c_int(0)
        rc = fn(_build.ptr(src), _build.ptr(work), _build.ptr(inv),
                _build.ptr(panel), batch, hp, block, ctypes.byref(launched),
                _build.stream_ptr(a.device))
        _build.check(rc, "cholesky_blocked")
        _build.count_launch("cholesky_blocked", launched.value)
    if hp != h:
        work = work[:, :h, :h].contiguous()
    return work.reshape(*lead, h, h)
