"""Triangular solves read directly from tile-packed factors, batched, as a
CUDA kernel.

Replaces ``src/repro/kernels/packed_trsm.py`` ``solve_lower_packed`` (the
Pallas call at ``:166``, body ``_make_kernel`` ``:42``, tile map
``_step_tile_indices`` ``:83``) and ``solve_packed`` (``:176``, the forward
call followed by the transposed one): one block per (factor, RHS column)
walks the tile rows, forward for ``L w = g`` and in reverse for
``Lᵀ w = g`` (column i of packed L read as row i of Lᵀ), holding the solved
segment in shared memory.  The diagonal tiles are inverted outside the
kernel, once for both sweeps
(:func:`~repro_torch.kernels.ref.packed_diag_inverses`, as
``_inv_diag_tiles`` ``:112``).  Bound by bytes; see
``csrc/packed_trsm.cu``.  The plain versions are
:func:`repro_torch.core.packing.solve_lower_packed` /
:func:`~repro_torch.core.packing.solve_packed_ref`.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.core import packing

from . import _build, ref

__all__ = ["solve_lower_packed", "solve_packed"]

_ARGS = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_longlong]
         + [ctypes.c_int] * 2 + [ctypes.c_void_p])


def solve_lower_packed(vec: torch.Tensor, g: torch.Tensor, h: int,
                       block: int = 128, *, transpose: bool = False,
                       inv_diag: torch.Tensor | None = None) -> torch.Tensor:
    """Solve ``L w = g`` (or ``Lᵀ w = g``) from packed factor(s) ``vec``
    (…, P); ``g`` is (…, h) or (…, h, m) with the same leading dims.  The
    solution comes back at ``vec``'s dtype.

    ``inv_diag`` (from :func:`~repro_torch.kernels.ref.packed_diag_inverses`)
    skips the diagonal inversion; one inversion serves both sweeps.
    A CPU tensor takes the plain version; a CUDA tensor launches the kernel.
    """
    if vec.device.type == "cpu":
        return packing.solve_lower_packed(vec, g, h, block,
                                          transpose=transpose)
    _build.check_tensor(vec, "solve_lower_packed factor")
    lead = vec.shape[:-1]
    squeeze = g.ndim == vec.ndim
    g2 = g[..., None] if squeeze else g
    nt = packing.num_tiles(h, block)
    p_size = packing.packed_size(h, block)
    if inv_diag is None:
        inv_diag = ref.packed_diag_inverses(vec, h, block)
    if (vec.shape[-1] != p_size or g2.shape[:-1] != (*lead, h)
            or inv_diag.shape != (*lead, nt, block, block)):
        raise ValueError(f"solve_lower_packed: shapes {tuple(vec.shape)}, "
                         f"{tuple(g.shape)}, {tuple(inv_diag.shape)} do not "
                         f"match h={h}, block={block}")
    if block > 256:
        raise ValueError(f"solve_lower_packed: block {block} > 256")
    batch, nrhs = math.prod(lead), g2.shape[-1]
    hp = nt * block
    g2 = torch.nn.functional.pad(g2.to(vec.dtype), (0, 0, 0, hp - h))
    g2 = g2.reshape(batch, hp, nrhs)
    for t, what in ((g2, "rhs"), (inv_diag, "inverses")):
        _build.check_tensor(t, f"solve_lower_packed {what}", vec.dtype)
    pmap = torch.as_tensor(packing.tile_pos_map(h, block), device=vec.device)
    out = torch.empty_like(g2)
    if batch and nrhs:
        fn = _build.c_function("packed_trsm",
                               f"rt_packed_trsm_{_build.suffix(vec.dtype)}",
                               _ARGS)
        rc = fn(_build.ptr(vec), _build.ptr(g2), _build.ptr(inv_diag),
                _build.ptr(pmap), _build.ptr(out), batch, nt, block, p_size,
                nrhs, int(transpose), _build.stream_ptr(vec.device))
        _build.check(rc, "solve_lower_packed")
        _build.count_launch("solve_lower_packed")
    out = out[:, :h].reshape(*lead, h, nrhs)
    return out[..., 0] if squeeze else out


def solve_packed(vec: torch.Tensor, g: torch.Tensor, h: int,
                 block: int = 128) -> torch.Tensor:
    """L Lᵀ θ = g from packed factor(s) (…, P): the forward launch, then
    the transposed one, sharing one inversion of the diagonal tiles.
    ``g`` as for :func:`solve_lower_packed`."""
    if vec.device.type == "cpu":
        return packing.solve_packed_ref(vec, g, h, block)
    inv = ref.packed_diag_inverses(vec, h, block)
    w = solve_lower_packed(vec, g, h, block, inv_diag=inv)
    return solve_lower_packed(vec, w, h, block, transpose=True, inv_diag=inv)
