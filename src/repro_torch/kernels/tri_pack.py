"""Tile-major packing and unpacking of lower triangles, as CUDA kernels.

Replaces ``src/repro/kernels/tri_pack.py``:

* ``pack_tril`` (the Pallas call at ``:73``, body ``_pack_kernel`` ``:25``):
  one block per (packed tile, matrix) decodes its tile's (i, j) from its
  packed index and copies the B×B tile, 16 bytes a thread, masking the
  ragged edge and the upper half of diagonal tiles itself; no index map is
  copied to the card;
* ``unpack_tril`` (``:104``, body ``_unpack_kernel`` ``:38``): one block per
  (dense tile, matrix) writes its tile of the unpadded (h, h) output, lower
  tiles from the packed vector through the (nt, nt) → packed-index map,
  upper tiles and the upper half of diagonal tiles as zeros.

Both are bound by bytes; see ``csrc/tri_pack.cu``.  The plain versions are
:func:`repro_torch.core.packing.pack_tril` / ``unpack_tril``.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.core import packing

from . import _build

__all__ = ["pack_tril", "unpack_tril"]

_ARGS = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
_UNPACK_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]


def pack_tril(mat: torch.Tensor, block: int = 128) -> torch.Tensor:
    """Pack tril(mat) (…, h, h) into the tile-major packed vectors (…, P).

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel,
    for ``block`` in :data:`_build.BLOCKS`.
    """
    if mat.device.type == "cpu":
        return packing.pack_tril(mat, block)
    if block not in _build.BLOCKS:
        raise ValueError(f"pack_tril: block must be one of {_build.BLOCKS}, "
                         f"got {block}")
    _build.check_tensor(mat, "pack_tril")
    if mat.ndim < 2 or mat.shape[-1] != mat.shape[-2]:
        raise ValueError(f"pack_tril: expected (…, h, h), got {tuple(mat.shape)}")
    h = mat.shape[-1]
    lead = mat.shape[:-2]
    batch = math.prod(lead)
    out = torch.empty((*lead, packing.packed_size(h, block)), dtype=mat.dtype,
                      device=mat.device)
    if batch == 0 or h == 0:
        return out
    fn = _build.c_function("tri_pack",
                           f"rt_pack_tril_{_build.suffix(mat.dtype)}", _ARGS)
    rc = fn(_build.ptr(mat), _build.ptr(out), batch, h, block,
            _build.stream_ptr(mat.device))
    _build.check(rc, "pack_tril")
    _build.count_launch("pack_tril")
    return out


def unpack_tril(vec: torch.Tensor, h: int, block: int = 128) -> torch.Tensor:
    """Unpack tile-major packed vectors (…, P) into lower-triangular
    (…, h, h).

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel.
    """
    if vec.device.type == "cpu":
        return packing.unpack_tril(vec, h, block)
    _build.check_tensor(vec, "unpack_tril")
    p_size = packing.packed_size(h, block)
    if vec.ndim < 1 or vec.shape[-1] != p_size:
        raise ValueError(f"unpack_tril: expected (…, {p_size}) for h={h}, "
                         f"block={block}, got {tuple(vec.shape)}")
    lead = vec.shape[:-1]
    batch = math.prod(lead)
    pmap = torch.as_tensor(packing.tile_pos_map(h, block), device=vec.device)
    out = torch.empty((*lead, h, h), dtype=vec.dtype, device=vec.device)
    if batch and h:
        fn = _build.c_function("tri_pack",
                               f"rt_unpack_tril_{_build.suffix(vec.dtype)}",
                               _UNPACK_ARGS)
        rc = fn(_build.ptr(vec), _build.ptr(out), _build.ptr(pmap), batch, h,
                block, _build.stream_ptr(vec.device))
        _build.check(rc, "unpack_tril")
        _build.count_launch("unpack_tril")
    return out
