"""int8 error-feedback gradient compression
(``src/repro/distributed/compression.py``).

Classic EF-SGD: the residual between the true gradient and its quantized
transport is carried to the next step, so the compression error does not
bias the trajectory.  The local transforms, and the int8 all-reduce over
named mesh axes (:func:`compressed_psum_tree`), which the reference runs
inside ``shard_map`` with one gradient tree per device: the port takes the
trees of every mesh position along those axes and reduces them itself, in
a fixed order.  Trees are mappings of tensors by name.
"""
from __future__ import annotations

import math
from typing import Dict, List, Mapping, Sequence, Tuple

import torch

__all__ = ["quantize_int8", "dequantize_int8", "ef_compress_tree",
           "compressed_psum_tree"]


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(q int8, scale): ``scale = max|x| / 127 + 1e-30``, q the rounded
    (half to even) quotient clipped to ±127."""
    scale = x.abs().max() / 127.0 + 1e-30
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def ef_compress_tree(grads: Mapping[str, torch.Tensor],
                     residual: Mapping[str, torch.Tensor]
                     ) -> Tuple[Dict[str, torch.Tensor],
                                Dict[str, torch.Tensor]]:
    """(dequantized gradients in their dtypes, new float32 residuals)."""
    deq, res = {}, {}
    for name, g in grads.items():
        gf = g.float() + residual[name]
        q, s = quantize_int8(gf)
        d = dequantize_int8(q, s)
        deq[name], res[name] = d.to(g.dtype), gf - d
    return deq, res


def compressed_psum_tree(grads: Sequence[Mapping[str, torch.Tensor]],
                         residual: Sequence[Mapping[str, torch.Tensor]],
                         axis_names, mesh
                         ) -> Tuple[List[Dict[str, torch.Tensor]],
                                    List[Dict[str, torch.Tensor]]]:
    """The int8 error-feedback psum over ``axis_names`` of ``mesh``
    (``compression.py:50-67``).  ``grads`` and ``residual`` hold one tree
    per mesh position along those axes (row-major over them; ``ValueError``
    for another count).  Per leaf, each position quantizes its gradient
    plus residual (:func:`quantize_int8`); then, in position order, the
    int8 codes are summed in int32, the scales in float32, and the count
    n is the positions'; every position gets ``qsum · (ssum / n) / n`` in
    its gradient's dtype, and keeps its own residual, its float32 input
    less its own dequantized codes.  Returns (the reduced trees, the new
    residuals), one of each per position."""
    axes = (axis_names,) if isinstance(axis_names, str) else \
        tuple(axis_names)
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
