"""One dtype → itemsize table for the port's cost model.

The JAX package keys this table by HLO dtype names
(``src/repro/distributed/dtype_bytes.py``); the same table is kept here,
and :func:`itemsize` prices a torch dtype, which is what the port's plan
cost (:mod:`.plan_cost`) reads: the port prices launches, not HLO text.
Sub-byte types are priced at their storage granularity (1 byte);
``token`` moves no bytes.
"""
from __future__ import annotations

import torch

__all__ = ["DTYPE_BYTES", "itemsize"]

DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s4": 1, "u4": 1, "s16": 2, "u16": 2,
    "bf16": 2, "f16": 2, "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8,
    "f64": 8, "c64": 8, "c128": 16, "token": 0, "f8e4m3fn": 1, "f8e5m2": 1,
}

_TORCH_NAMES = {
    torch.bool: "pred", torch.int8: "s8", torch.uint8: "u8",
    torch.int16: "s16", torch.bfloat16: "bf16", torch.float16: "f16",
    torch.int32: "s32", torch.float32: "f32", torch.int64: "s64",
    torch.float64: "f64", torch.complex64: "c64", torch.complex128: "c128",
}


def itemsize(dtype: torch.dtype) -> int:
    """Bytes of one element of a torch dtype, from the table."""
    return DTYPE_BYTES[_TORCH_NAMES[dtype]]
