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

With ``compute_dtype=bfloat16`` (the mixed variant, float32 state) the
operands of the panel product (A_i1 and L11⁻¹) and of the trailing update
(the panel W, also where the diagonal step applies it to its own tile)
are rounded to bf16 as their fragments are formed and multiplied on the
bf16 tensor cores (``mma.sync`` m16n8k16) into float32 sums, as the
Pallas kernels cast them (``chol_blocked.py:80-82``, ``:98-100``); the
diagonal factor and its inverse stay float32.  It counts under
``cholesky_blocked_bf16``.

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


def cholesky_blocked(a: torch.Tensor, block: int = 128, *,
                     compute_dtype=None, accum_dtype=None) -> torch.Tensor:
    """Cholesky factors of SPD ``a`` (…, h, h) → lower-triangular (…, h, h)
    at the accumulation dtype.

    ``compute_dtype`` (default ``a``'s dtype) is what the products'
    operands are rounded to; ``accum_dtype`` (default float32 for a 16-bit
    compute dtype, else the compute dtype) is the dtype of the state, the
    diagonal step and the result, ``a`` being cast to it.  A CPU tensor
    takes the plain version; a CUDA tensor launches the kernels, which
    run float32 or float64 throughout, or bf16 products with float32 state.
    ``block`` must be one of :data:`_build.BLOCKS`.  The input is never
    modified.
    """
    cd, ad = _build.resolve_dtypes(a.dtype, compute_dtype, accum_dtype)
    mixed = cd != ad
    a = a.to(ad)
    if a.device.type == "cpu":
        return ref.cholesky_blocked(a, block, cd if mixed else None)
    _build.check_mixed(cd, ad, "cholesky_blocked")
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
                               _build.entry("chol_blocked", ad, cd), _ARGS)
        launched = ctypes.c_int(0)
        rc = fn(_build.ptr(src), _build.ptr(work), _build.ptr(inv),
                _build.ptr(panel), batch, hp, block, ctypes.byref(launched),
                _build.stream_ptr(a.device))
        _build.check(rc, "cholesky_blocked")
        _build.count_launch(_build.MIXED_NAMES["cholesky_blocked"] if mixed
                            else "cholesky_blocked", launched.value)
    if hp != h:
        work = work[:, :h, :h].contiguous()
    return work.reshape(*lead, h, h)
