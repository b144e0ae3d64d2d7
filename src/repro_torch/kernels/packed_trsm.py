"""Triangular solves read directly from tile-packed factors, batched, as a
CUDA kernel.

Replaces ``src/repro/kernels/packed_trsm.py`` ``solve_lower_packed`` (the
Pallas call at ``:166``, body ``_make_kernel`` ``:42``, tile map
``_step_tile_indices`` ``:83``) and ``solve_packed`` (``:176``, the forward
call followed by the transposed one).  A packed factor is a degree-0
interpolant, so the kernel is the cluster solve of ``csrc/tri_solve.cuh``
with the packed tile source: a cluster of up to 8 blocks per (factor, RHS
column), right-looking, tile (i, j) found in the factor at its packed
offset (no map), the diagonal tiles inverted in the kernel's prologue.
``solve_packed`` is one launch for both sweeps; ``solve_lower_packed`` one
launch of the forward (``L w = g``) or the reverse (``Lᵀ w = g``, column i
of packed L read as row i of Lᵀ) sweep.  The block B is a compile-time
parameter, one of :data:`_build.BLOCKS`.  Bound by bytes; see
``csrc/packed_trsm.cu``.

``compute_dtype`` / ``accum_dtype`` resolve as the Pallas kernel's
``_resolve_dtypes`` (``:99``): compute inherits the factor's dtype, accum
is float32 for a 16-bit compute dtype.  Under bf16 products (the mixed
variant: a bf16 factor by default, or a policy's bf16 compute dtype) every
product runs on the bf16 tensor cores with float32 sums: the tiles, the
solved segments, the inverses and g_i − acc_i rounded to bf16, the
inverses formed at float32 from the factor's own values, g and the
solution float32 (``:17-24``, ``:61-80``, ``:112-123``).  A bf16 factor is
read in bf16; a float32 factor is rounded as the fragments are formed; a
float64 factor is cast to float32 first (so its tiles round twice, f64 →
f32 → bf16, where the Pallas kernel rounds once).  It counts under
``solve_lower_packed_bf16``.  The plain versions are
:func:`repro_torch.kernels.ref.solve_lower_packed` /
:func:`~repro_torch.kernels.ref.solve_packed`.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.core import packing

from . import _build, ref

__all__ = ["solve_lower_packed", "solve_packed"]

_ARGS = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
         + [ctypes.POINTER(ctypes.c_int), ctypes.c_void_p])


def _solve(vec: torch.Tensor, g: torch.Tensor, h: int, block: int,
           sweeps: int, compute_dtype, accum_dtype) -> torch.Tensor:
    """``sweeps`` 1 (L w = g), 2 (Lᵀ w = g) or 3 (both in turn) from packed
    factor(s) ``vec`` (…, P); ``g`` (…, h) or (…, h, m) with the same
    leading dims → the solution at the accumulation dtype."""
    cd, ad = _build.resolve_dtypes(vec.dtype, compute_dtype, accum_dtype)
    mixed = cd != ad
    # the tiles as the kernel stores them: a bf16 factor in bf16 under bf16
    # products, any other factor at the accumulation dtype
    vec = vec.to(cd if cd == vec.dtype and mixed else ad)
    lead = vec.shape[:-1]
    squeeze = g.ndim == vec.ndim
    g2 = (g[..., None] if squeeze else g).to(ad)
    if vec.shape[-1] != packing.packed_size(h, block) \
            or g2.shape[:-1] != (*lead, h):
        raise ValueError(f"solve_lower_packed: shapes {tuple(vec.shape)}, "
                         f"{tuple(g.shape)} do not match h={h}, "
                         f"block={block}")
    if vec.device.type == "cpu":
        plain_cd = cd if mixed else None
        if sweeps == 3:
            w = ref.solve_packed(vec, g2, h, block, plain_cd)
        else:
            w = ref.solve_lower_packed(vec, g2, h, block,
                                       transpose=sweeps == 2,
                                       compute_dtype=plain_cd)
        return w[..., 0] if squeeze else w
    _build.check_mixed(cd, ad, "solve_lower_packed")
    _build.check_block(block, "solve_lower_packed")
    nt = packing.num_tiles(h, block)
    batch, nrhs = math.prod(lead), g2.shape[-1]
    vec = vec.reshape(batch, -1)
    g2 = torch.nn.functional.pad(g2, (0, 0, 0, nt * block - h))
    g2 = g2.reshape(batch, nt * block, nrhs).contiguous()
    _build.check_tensor(vec, "solve_lower_packed factor",
                        vec.dtype if mixed else None)
    _build.check_tensor(g2, "solve_lower_packed rhs", ad)
    out = torch.empty_like(g2)
    if batch and nrhs:
        fn = _build.c_function("packed_trsm",
                               _build.entry("packed_trsm", vec.dtype, cd),
                               _ARGS)
        _build.launch_solve(
            _build.MIXED_NAMES["solve_lower_packed"] if mixed
            else "solve_lower_packed", fn,
            (_build.ptr(vec), _build.ptr(g2)),
            (_build.ptr(out), batch, h, block, nrhs, sweeps),
            (batch * nrhs, nt, block, ad), vec.device)
    out = out[:, :h].reshape(*lead, h, nrhs)
    return out[..., 0] if squeeze else out


def solve_lower_packed(vec: torch.Tensor, g: torch.Tensor, h: int,
                       block: int = 128, *, transpose: bool = False,
                       compute_dtype=None, accum_dtype=None) -> torch.Tensor:
    """Solve ``L w = g`` (or ``Lᵀ w = g``) from packed factor(s) ``vec``
    (…, P); ``g`` is (…, h) or (…, h, m) with the same leading dims.  The
    solution comes back at the accumulation dtype.  A CPU tensor takes the
    plain version; a CUDA tensor launches the kernel (one launch)."""
    return _solve(vec, g, h, block, 2 if transpose else 1, compute_dtype,
                  accum_dtype)


def solve_packed(vec: torch.Tensor, g: torch.Tensor, h: int,
                 block: int = 128, *, compute_dtype=None,
                 accum_dtype=None) -> torch.Tensor:
    """L Lᵀ θ = g from packed factor(s) (…, P): both sweeps in one launch.
    Arguments as for :func:`solve_lower_packed`."""
    return _solve(vec, g, h, block, 3, compute_dtype, accum_dtype)
