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
are bf16 and their products float32 sums, as the Pallas kernels cast
them (``chol_blocked.py:80-82``, ``:98-100``); the diagonal factor and
its inverse stay float32.  Two designs, by block (:func:`mixed_variant`):
``wgmma`` at B = 64 and 128 rounds each operand once where it is stored
(the inverse and a copy of the panel in bf16 scratch, :func:`scratch`),
brings the strips in by the tensor memory accelerator and multiplies them
with ``wgmma``; ``mma_sync`` at B = 16 and 32 rounds the float32 operands
as the ``mma.sync`` fragments are formed.  The job map of either
design's panel and trailing-update launches is :func:`column_jobs`.  It
counts under ``cholesky_blocked_bf16``.

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

__all__ = ["cholesky_blocked", "scratch", "mixed_variant", "column_jobs",
           "WGMMA_BLOCKS"]

_ARGS = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
         + [ctypes.POINTER(ctypes.c_int), ctypes.c_void_p])


#: the blocks at which the mixed variant runs its ``wgmma`` design (the
#: tensor memory accelerator's 128-byte swizzle takes strips of 64 bf16
#: columns); the others run ``mma_sync``
WGMMA_BLOCKS = (64, 128)


def mixed_variant(block: int) -> str:
    """The design the mixed variant runs at ``block``, as the C side
    chooses it: ``"wgmma"`` or ``"mma_sync"``.  Raises for a block the
    kernels are not compiled for."""
    _build.check_block(block, "cholesky_blocked")
    return "wgmma" if block in WGMMA_BLOCKS else "mma_sync"


def scratch(a: torch.Tensor, batch: int, hp: int, block: int,
            compute_dtype=None) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernels' scratch for ``batch`` matrices of ``hp`` rows at
    ``block``: the diagonal inverse (batch, B, B) and the panel
    (batch, hp, B), at ``a``'s dtype, or in ``compute_dtype`` where the
    mixed variant runs its wgmma design (each stored rounded once)."""
    dtype = a.dtype
    if (compute_dtype is not None and compute_dtype != a.dtype
            and mixed_variant(block) == "wgmma"):
        dtype = compute_dtype
    return (a.new_empty((batch, block, block), dtype=dtype),
            a.new_empty((batch, hp, block), dtype=dtype))


def _pair(p: int) -> tuple[int, int]:
    """Lower tile pair p → (ti, tj), tj ≤ ti, row-major: the C side's
    arithmetic (a double square root, then integer corrections)."""
    ti = int((math.sqrt(8.0 * p + 1.0) - 1.0) * 0.5)
    while (ti + 1) * (ti + 2) // 2 <= p:
        ti += 1
    while ti * (ti + 1) // 2 > p:
        ti -= 1
    return ti, p - ti * (ti + 1) // 2


def column_jobs(nt: int, j: int, block: int) -> dict:
    """The mixed variant's jobs for tile column ``j`` of ``nt`` (j < nt −
    1) at ``block``, launch index → job, as ``csrc/chol_blocked.cu`` maps
    them in the design :func:`mixed_variant` names, in tile coordinates of
    the whole matrix.  ``panel``: block b is ``(ti, j, r0)``, rows [r0, r0
    + R) of the factor's tile (ti, j), R = 64 in the wgmma design (B / 64
    blocks a tile row) and B in mma_sync.  ``syrk``: block p is
    ``("pair", ti, tj)``, C −= W_ti W_tjᵀ on that lower tile, for p <
    n_pairs − 1 (pair 0, the tile (j + 1, j + 1), is the next diagonal
    step's), else ``("zero", j, tj)``, zeroing the mirrored upper tile —
    in mma_sync ``("copy_zero", j, tj)``, which also copies the panel's
    tile into the factor's tile (tj, j), since its panel writes only the
    scratch panel."""
    m = nt - 1 - j
    n_pairs = m * (m + 1) // 2
    wgmma = mixed_variant(block) == "wgmma"
    rows = 64 if wgmma else block
    parts = block // rows
    panel = [(j + 1 + b // parts, j, rows * (b % parts))
             for b in range(m * parts)]
    syrk = []
    for job in range(n_pairs - 1 + m):
        if job < n_pairs - 1:
            ti, tj = _pair(job + 1)
            syrk.append(("pair", j + 1 + ti, j + 1 + tj))
        else:
            syrk.append(("zero" if wgmma else "copy_zero", j,
                         j + 1 + job - (n_pairs - 1)))
    return dict(panel=panel, rows=rows, syrk=syrk, diag=(j + 1, j + 1))


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
        inv, panel = scratch(a, batch, hp, block, cd if mixed else None)
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
