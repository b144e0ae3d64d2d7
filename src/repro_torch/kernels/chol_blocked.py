"""Blocked right-looking Cholesky, batched, as CUDA kernels.

Replaces ``src/repro/kernels/chol_blocked.py`` ``cholesky_blocked``: the
Pallas calls ``_factor_panel`` (``:115``) and ``_syrk_update`` (``:130``).
Per tile column the C entry point launches (a) potf2 plus the inverse of
the diagonal tile, (b) the panel product with that inverse and (c) the
lower-tile trailing update; see ``csrc/chol_blocked.cu``.  One call
counts its 3·(hp/B) − 2 launches.  Bound by operations (h³/3 per
matrix).

The factorization runs in place in an identity-padded (…, hp, hp) copy of
the input that the wrapper makes; the result is the lower triangle of its
leading (h, h) block.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.core import packing

from . import _build, ref

__all__ = ["cholesky_blocked"]

_ARGS = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
         + [ctypes.POINTER(ctypes.c_int), ctypes.c_void_p])

#: shared memory one block may use on Hopper (bytes)
SMEM_LIMIT = 232448


def _max_block(dtype) -> int:
    """Largest tile whose packed-lower factor and inverse fit one block's
    shared memory (B(B+1) values)."""
    b = 16
    while (b + 16) * (b + 17) * dtype.itemsize <= SMEM_LIMIT:
        b += 16
    return b


def cholesky_blocked(a: torch.Tensor, block: int = 128) -> torch.Tensor:
    """Cholesky factors of SPD ``a`` (…, h, h) → lower-triangular (…, h, h).

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernels.  ``block`` must be a multiple of 16 (16, 32, 64 and 128 are
    used).
    """
    if a.device.type == "cpu":
        return ref.cholesky_blocked(a, block)
    _build.check_tensor(a, "cholesky_blocked")
    if a.ndim < 2 or a.shape[-1] != a.shape[-2]:
        raise ValueError(f"cholesky_blocked: expected (…, h, h), got "
                         f"{tuple(a.shape)}")
    if block % 16 or not 16 <= block <= _max_block(a.dtype):
        raise ValueError(f"cholesky_blocked: block must be a multiple of 16 "
                         f"in [16, {_max_block(a.dtype)}] for {a.dtype}, got "
                         f"{block}")
    h = a.shape[-1]
    lead = a.shape[:-2]
    batch = math.prod(lead)
    hp = packing.num_tiles(h, block) * block
    work = a.new_zeros((batch, hp, hp))
    work[:, :h, :h] = a.reshape(batch, h, h)
    if hp != h:
        idx = torch.arange(h, hp, device=a.device)
        work[:, idx, idx] = 1
    if batch:
        inv = a.new_empty((batch, block, block))
        panel = a.new_empty((batch, hp, block))
        fn = _build.c_function("chol_blocked",
                               f"rt_chol_blocked_{_build.suffix(a.dtype)}",
                               _ARGS)
        launched = ctypes.c_int(0)
        rc = fn(_build.ptr(work), _build.ptr(inv), _build.ptr(panel), batch,
                hp, block, ctypes.byref(launched),
                _build.stream_ptr(a.device))
        _build.check(rc, "cholesky_blocked")
        _build.count_launch("cholesky_blocked", launched.value)
    return torch.tril(work[:, :h, :h]).reshape(*lead, h, h)
