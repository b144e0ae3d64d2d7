"""int8 error-feedback gradient compression
(``src/repro/distributed/compression.py``).

Classic EF-SGD: the residual between the true gradient and its quantized
transport is carried to the next step, so the compression error does not
bias the trajectory.  The local transforms, and the int8 all-reduce over
named mesh axes (:func:`compressed_psum_tree`), which the reference runs
inside ``shard_map`` with one gradient tree per device.  On a mesh of
devices the port takes the trees of every mesh position along those axes
and reduces them itself, in a fixed order; on a mesh over a world of ranks
each rank gives its own tree and the codes, scales and count are summed by
all-reduces.  Trees are mappings of tensors by name.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Mapping, Optional, Tuple

import torch

from . import collectives as coll

__all__ = ["quantize_int8", "dequantize_int8", "ef_compress_tree",
           "compressed_psum_tree"]


def quantize_int8(x: torch.Tensor, amax: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(q int8, scale): ``scale = max|x| / 127 + 1e-30`` (``amax`` in place
    of max|x| when given: a block's scale is its whole leaf's), q the
    rounded (half to even) quotient clipped to ±127."""
    scale = (x.abs().max() if amax is None else amax) / 127.0 + 1e-30
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def ef_compress_tree(grads: Mapping[str, torch.Tensor],
                     residual: Mapping[str, torch.Tensor],
                     amax_of: Optional[Callable] = None
                     ) -> Tuple[Dict[str, torch.Tensor],
                                Dict[str, torch.Tensor]]:
    """(dequantized gradients in their dtypes, new float32 residuals).
    ``amax_of(name, max |block|)`` gives the whole leaf's max |·| where a
    gradient is a rank's block of its leaf."""
    deq, res = {}, {}
    for name, g in grads.items():
        gf = g.float() + residual[name]
        amax = None if amax_of is None else amax_of(name, gf.abs().max())
        q, s = quantize_int8(gf, amax)
        d = dequantize_int8(q, s)
        deq[name], res[name] = d.to(g.dtype), gf - d
    return deq, res


def _psum_world(grads: Mapping[str, torch.Tensor],
                residual: Mapping[str, torch.Tensor], axes, world):
    """:func:`compressed_psum_tree` of this rank's tree over a world."""
    n = float(world.axis_size(axes))
    out: Dict[str, torch.Tensor] = {}
    res: Dict[str, torch.Tensor] = {}
    for name, g in grads.items():
        gf = g.float() + residual[name]
        q, s = quantize_int8(gf)
        res[name] = gf - dequantize_int8(q, s)
        qsum = coll.psum(q.to(torch.int32), axes, world)
        ssum = coll.psum(s, axes, world)
        out[name] = (qsum.float() * (ssum / n) / n).to(g.dtype)
    return out, res


def compressed_psum_tree(grads, residual, axis_names, mesh):
    """The int8 error-feedback psum over ``axis_names`` of ``mesh``
    (``compression.py:50-67``).  ``grads`` and ``residual`` hold one tree
    per mesh position along those axes (row-major over them; ``ValueError``
    for another count).  Per leaf, each position quantizes its gradient
    plus residual (:func:`quantize_int8`); then, in position order, the
    int8 codes are summed in int32, the scales in float32, and the count
    n is the positions'; every position gets ``qsum · (ssum / n) / n`` in
    its gradient's dtype, and keeps its own residual, its float32 input
    less its own dequantized codes.  Returns (the reduced trees, the new
    residuals), one of each per position.

    On a mesh over a world of ranks ``grads`` and ``residual`` are this
    rank's trees, and it gets (its reduced tree, its new residual): the
    int8 codes summed in int32 by an all-reduce over ``axis_names``, the
    scales summed, the count the positions' (``compression.py:
    50-67``)."""
    axes = (axis_names,) if isinstance(axis_names, str) else \
        tuple(axis_names)
    if getattr(mesh, "world", None) is not None:
        return _psum_world(grads, residual, axes, mesh.world)
    n = math.prod(mesh.shape[a] for a in axes)
    if len(grads) != n or len(residual) != n:
        raise ValueError(f"{len(grads)} gradient and {len(residual)} "
                         f"residual trees for the {n} positions of {axes}")
    out: List[Dict[str, torch.Tensor]] = [{} for _ in range(n)]
    res: List[Dict[str, torch.Tensor]] = [{} for _ in range(n)]
    for name in grads[0]:
        qsum = ssum = None
        for i in range(n):
            gf = grads[i][name].float() + residual[i][name]
            q, s = quantize_int8(gf)
            res[i][name] = gf - dequantize_int8(q, s)
            q32 = q.to(torch.int32)
            qsum = q32 if qsum is None else qsum + q32
            ssum = s if ssum is None else ssum + s
        deq = qsum.float() * (ssum / float(n)) / float(n)
        for i in range(n):
            out[i][name] = deq.to(grads[i][name].dtype)
    return out, res
