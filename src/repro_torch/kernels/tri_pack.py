"""Tile-major packing of lower triangles, as a CUDA kernel.

Replaces ``src/repro/kernels/tri_pack.py`` ``pack_tril`` (the Pallas call at
``:73``, body ``_pack_kernel`` ``:25``): one block per (packed tile, matrix)
copies its B×B tile, masking the ragged edge and the upper half of diagonal
tiles itself.  Bound by bytes; see ``csrc/tri_pack.cu``.  ``unpack_tril``
(``:104``) is not ported yet.
"""
from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from repro_torch.core import packing

from . import _build

__all__ = ["pack_tril"]

_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def pack_tril(mat: torch.Tensor, block: int = 128) -> torch.Tensor:
    """Pack tril(mat) (…, h, h) into the tile-major packed vectors (…, P).

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel.
    """
    if mat.device.type == "cpu":
        return packing.pack_tril(mat, block)
    _build.check_tensor(mat, "pack_tril")
    if mat.ndim < 2 or mat.shape[-1] != mat.shape[-2]:
        raise ValueError(f"pack_tril: expected (…, h, h), got {tuple(mat.shape)}")
    h = mat.shape[-1]
    lead = mat.shape[:-2]
    batch = math.prod(lead)
    ii, jj = packing.tile_index_pairs(h, block)
    pairs = torch.as_tensor(np.stack([ii, jj]), device=mat.device)
    out = torch.empty((*lead, packing.packed_size(h, block)), dtype=mat.dtype,
                      device=mat.device)
    if batch == 0:
        return out
    fn = _build.c_function("tri_pack",
                           f"rt_pack_tril_{_build.suffix(mat.dtype)}", _ARGS)
    rc = fn(_build.ptr(mat), _build.ptr(out), _build.ptr(pairs), len(ii),
            batch, h, block, _build.stream_ptr(mat.device))
    _build.check(rc, "pack_tril")
    _build.count_launch("pack_tril")
    return out
