"""Tile-major triangular packing (the packed factor layout).

The lower triangle of an ``h×h`` factor is stored as its ``B×B`` tiles in
*tile-column-major* order — tiles ``(j, j), (j+1, j), …, (nt−1, j)`` for
``j = 0 … nt−1`` — with the upper half of each diagonal tile zeroed and the
ragged edge (``h % B ≠ 0``) zero-padded.  The layout is element for element
the JAX package's, so Θ, anchor targets and packed factors of the two
packages compare without an unpack.

This module is the plain-torch definition of the layout;
:mod:`repro_torch.kernels.tri_pack` is the CUDA kernel writing the same
layout.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import numpy as np
import torch

from .precision import as_dtype, default_accum_dtype

__all__ = [
    "num_tiles", "tile_index_pairs", "tile_pos_map", "column_starts",
    "packed_size", "packed_nbytes", "pack_tril", "unpack_tril",
    "pack_tril_rowwise", "unpack_tril_rowwise", "pack_tril_full",
    "tril_mask_packed", "PackedFactor", "invert_diag_tiles",
    "solve_lower_packed", "solve_packed_ref",
]


def num_tiles(h: int, block: int) -> int:
    """Number of ``block``-sized tile rows covering an ``h×h`` matrix."""
    return -(-h // block)


@functools.lru_cache(maxsize=None)
def tile_index_pairs(h: int, block: int) -> Tuple[np.ndarray, np.ndarray]:
    """(i, j) tile coordinates of the lower tiles, tile-column-major."""
    nt = num_tiles(h, block)
    ii, jj = [], []
    for j in range(nt):
        for i in range(j, nt):
            ii.append(i)
            jj.append(j)
    return np.asarray(ii, dtype=np.int32), np.asarray(jj, dtype=np.int32)


@functools.lru_cache(maxsize=None)
def tile_pos_map(h: int, block: int) -> np.ndarray:
    """(nt, nt) dense-tile → packed-tile index; 0 for upper tiles (callers
    walk only ``i ≥ j``)."""
    nt = num_tiles(h, block)
    ii, jj = tile_index_pairs(h, block)
    pmap = np.zeros((nt, nt), np.int32)
    pmap[ii, jj] = np.arange(len(ii), dtype=np.int32)
    return pmap


@functools.lru_cache(maxsize=None)
def column_starts(h: int, block: int) -> np.ndarray:
    """Packed index of the diagonal tile of each tile column:
    ``j·nt − j(j−1)/2``."""
    nt = num_tiles(h, block)
    j = np.arange(nt, dtype=np.int64)
    return (j * nt - j * (j - 1) // 2).astype(np.int32)


def packed_size(h: int, block: int) -> int:
    nt = num_tiles(h, block)
    return (nt * (nt + 1) // 2) * block * block


def packed_nbytes(h: int, block: int, dtype=torch.float32) -> int:
    """Bytes one packed factor weighs at ``dtype``."""
    return packed_size(h, block) * as_dtype(dtype).itemsize


def _padded(mat: torch.Tensor, block: int) -> torch.Tensor:
    pad = num_tiles(mat.shape[-1], block) * block - mat.shape[-1]
    return torch.nn.functional.pad(mat, (0, pad, 0, pad)) if pad else mat


def _index(a: np.ndarray, device) -> torch.Tensor:
    return torch.as_tensor(a.astype(np.int64), device=device)


def pack_tril(mat: torch.Tensor, block: int = 128) -> torch.Tensor:
    """Pack the lower triangle of ``mat`` (…, h, h) into (…, P)."""
    h = mat.shape[-1]
    nt = num_tiles(h, block)
    m = _padded(torch.tril(mat), block)
    lead = m.shape[:-2]
    t = m.reshape(*lead, nt, block, nt, block).transpose(-3, -2)
    flat = t.reshape(*lead, nt * nt, block, block)
    ii, jj = tile_index_pairs(h, block)
    tiles = flat.index_select(-3, _index(ii * nt + jj, mat.device))
    return tiles.reshape(*lead, -1)


def unpack_tril(vec: torch.Tensor, h: int, block: int = 128) -> torch.Tensor:
    """Inverse of :func:`pack_tril`: (…, P) → (…, h, h) lower-triangular."""
    nt = num_tiles(h, block)
    lead = vec.shape[:-1]
    tiles = vec.reshape(*lead, -1, block, block)
    zero = tiles.new_zeros((*lead, 1, block, block))
    tiles = torch.cat([tiles, zero], dim=-3)
    pmap = np.full((nt, nt), tiles.shape[-3] - 1, np.int32)
    ii, jj = tile_index_pairs(h, block)
    pmap[ii, jj] = np.arange(len(ii), dtype=np.int32)
    flat = tiles.index_select(-3, _index(pmap.reshape(-1), vec.device))
    t = flat.reshape(*lead, nt, nt, block, block).transpose(-3, -2)
    m = t.reshape(*lead, nt * block, nt * block)
    return torch.tril(m[..., :h, :h])


@functools.lru_cache(maxsize=None)
def _tril_flat_indices(h: int) -> np.ndarray:
    r, c = np.tril_indices(h)
    return r * h + c


def pack_tril_rowwise(mat: torch.Tensor) -> torch.Tensor:
    """The paper's row-wise baseline (Table 1): the lower triangle's
    entries row by row, (…, h, h) → (…, h(h+1)/2); exact size, unaligned
    rows."""
    h = mat.shape[-1]
    flat = mat.reshape(*mat.shape[:-2], h * h)
    return flat.index_select(-1, _index(_tril_flat_indices(h), mat.device))


def unpack_tril_rowwise(vec: torch.Tensor, h: int) -> torch.Tensor:
    """Inverse of :func:`pack_tril_rowwise`: (…, h(h+1)/2) → (…, h, h)."""
    lead = vec.shape[:-1]
    flat = vec.new_zeros((*lead, h * h))
    flat.index_copy_(-1, _index(_tril_flat_indices(h), vec.device), vec)
    return flat.reshape(*lead, h, h)


def pack_tril_full(mat: torch.Tensor) -> torch.Tensor:
    """The paper's full-matrix baseline: the whole matrix with its upper
    half zeroed, flattened, (…, h, h) → (…, h²); aligned, twice the
    interpolation work."""
    return torch.tril(mat).reshape(*mat.shape[:-2], -1)


def tril_mask_packed(h: int, block: int = 128, dtype=torch.float32,
                     device=None) -> torch.Tensor:
    """(P,) mask of the real (non-padding) entries of the tile-packed
    layout: a packed all-ones matrix.  Packed by the ``pack_tril`` kernel
    on the card (the plain version on the CPU); ``device=None`` is the
    CUDA device."""
    from .._device import resolve_device
    from ..kernels import tri_pack
    ones = torch.ones((h, h), dtype=as_dtype(dtype),
                      device=resolve_device(device))
    return tri_pack.pack_tril(ones, block)


@dataclasses.dataclass(frozen=True)
class PackedFactor:
    """A Cholesky factor (or a batch of them) in the packed ``(…, P)``
    layout."""

    vec: torch.Tensor
    h: int
    block: int

    def __post_init__(self):
        if self.vec.shape[-1] != packed_size(self.h, self.block):
            raise ValueError(
                f"packed vec last dim {self.vec.shape[-1]} != packed_size("
                f"h={self.h}, block={self.block}) = "
                f"{packed_size(self.h, self.block)}")

    @property
    def nt(self) -> int:
        return num_tiles(self.h, self.block)

    @property
    def n_blocks(self) -> int:
        return self.nt * (self.nt + 1) // 2

    @property
    def dtype(self) -> torch.dtype:
        return self.vec.dtype

    @property
    def nbytes(self) -> int:
        return self.vec.numel() * self.vec.element_size()

    def astype(self, dtype) -> "PackedFactor":
        return PackedFactor(self.vec.to(as_dtype(dtype)), self.h, self.block)

    @classmethod
    def from_dense(cls, mat: torch.Tensor, block: int = 128) -> "PackedFactor":
        return cls(pack_tril(mat, block), mat.shape[-1], block)

    def tiles(self) -> torch.Tensor:
        """(…, n_blocks, B, B) view of the packed tiles."""
        return self.vec.reshape(*self.vec.shape[:-1], -1, self.block,
                                self.block)

    def dense(self) -> torch.Tensor:
        """Debug escape hatch: the dense factor (…, h, h)."""
        return unpack_tril(self.vec, self.h, self.block)


@functools.lru_cache(maxsize=None)
def _identity_tail(h: int, block: int) -> np.ndarray:
    """(B, B) identity on the padding rows of the last diagonal tile — what
    keeps padded block solves nonsingular when h % block ≠ 0 (all zero when
    there is no padding)."""
    pad = num_tiles(h, block) * block - h
    tail = np.zeros((block, block), np.float64)
    if pad:
        idx = np.arange(block - pad, block)
        tail[idx, idx] = 1.0
    return tail


def _diag_tiles(tiles: torch.Tensor, h: int, block: int) -> torch.Tensor:
    """(…, nt, B, B) diagonal tiles, identity-padded via
    :func:`_identity_tail`."""
    nt = num_tiles(h, block)
    diag = tiles.index_select(-3, _index(column_starts(h, block),
                                         tiles.device))
    tail = _identity_tail(h, block)
    if tail.any():
        diag[..., nt - 1, :, :] += torch.as_tensor(tail, dtype=diag.dtype,
                                                   device=diag.device)
    return diag


def invert_diag_tiles(diag: torch.Tensor) -> torch.Tensor:
    """Inverses of lower-triangular diagonal tiles (…, B, B).  One inversion
    serves both sweeps: ``inv(L_jj)ᵀ = inv(L_jjᵀ)``."""
    eye = torch.eye(diag.shape[-1], dtype=diag.dtype, device=diag.device)
    return torch.linalg.solve_triangular(diag, eye.expand_as(diag).clone(),
                                         upper=False)


def solve_lower_packed(vec: torch.Tensor, g: torch.Tensor, h: int,
                       block: int, *, transpose: bool = False,
                       accum_dtype=None) -> torch.Tensor:
    """Solve ``L w = g`` (or ``Lᵀ w = g``) from packed factor(s) (…, P)
    without unpacking.  ``g``: (…, h) or (…, h, q) with the same leading
    dims as ``vec``.  The transpose sweep walks the tile columns in
    reverse: column ``i`` of packed ``L`` is row ``i`` of ``Lᵀ``."""
    nt = num_tiles(h, block)
    hp = nt * block
    ad = (as_dtype(accum_dtype) if accum_dtype is not None
          else default_accum_dtype(vec.dtype))
    squeeze = g.ndim == vec.ndim
    g2 = (g[..., None] if squeeze else g).to(ad)
    if hp != h:
        g2 = torch.nn.functional.pad(g2, (0, 0, 0, hp - h))
    tiles = vec.reshape(*vec.shape[:-1], -1, block, block)
    pmap = tile_pos_map(h, block)
    diag = _diag_tiles(tiles, h, block).to(ad)

    w = [None] * nt
    order = range(nt - 1, -1, -1) if transpose else range(nt)
    for i in order:
        acc = g2[..., i * block:(i + 1) * block, :]
        if transpose:
            for t in range(i + 1, nt):
                tile = tiles[..., int(pmap[t, i]), :, :].to(ad)
                acc = acc - tile.mT @ w[t]
            w[i] = torch.linalg.solve_triangular(diag[..., i, :, :].mT, acc,
                                                 upper=True)
        else:
            for j in range(i):
                tile = tiles[..., int(pmap[i, j]), :, :].to(ad)
                acc = acc - tile @ w[j]
            w[i] = torch.linalg.solve_triangular(diag[..., i, :, :], acc,
                                                 upper=False)
    out = torch.cat(w, dim=-2)[..., :h, :]
    return out[..., 0] if squeeze else out


def solve_packed_ref(vec: torch.Tensor, g: torch.Tensor, h: int, block: int,
                     accum_dtype=None) -> torch.Tensor:
    """L Lᵀ θ = g entirely in the packed domain (forward + back sweep)."""
    w = solve_lower_packed(vec, g, h, block, accum_dtype=accum_dtype)
    return solve_lower_packed(vec, w, h, block, transpose=True,
                              accum_dtype=accum_dtype)
