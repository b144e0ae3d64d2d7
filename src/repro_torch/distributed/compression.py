"""int8 error-feedback gradient compression
(``src/repro/distributed/compression.py``).

Classic EF-SGD: the residual between the true gradient and its quantized
transport is carried to the next step, so the compression error does not
bias the trajectory.  These are the local transforms; the reference's
``compressed_psum_tree`` (the int8 all-reduce inside ``shard_map``) waits
for the LM's sharded path (``ROADMAP.md`` queue 1 item 6).  Trees are
mappings of tensors by name.
"""
from __future__ import annotations

from typing import Dict, Mapping, Tuple

import torch

__all__ = ["quantize_int8", "dequantize_int8", "ef_compress_tree"]


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
