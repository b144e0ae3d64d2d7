"""Blocked triangular solves on dense factors, batched, as a CUDA kernel.

Replaces ``src/repro/kernels/trsm.py`` ``solve_lower_blocked`` (the Pallas
call at ``:102``, body ``_make_solve_kernel`` ``:24``): one block per
(factor, RHS column) walks the tile rows, forward for ``L w = g`` and in
reverse for ``Lᵀ w = g``, holding the solved segment in shared memory.  The
diagonal tiles are inverted outside the kernel, as at ``trsm.py:89-94``.
Bound by bytes; see ``csrc/trsm.cu``.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.core import packing

from . import _build, ref

__all__ = ["solve_lower_blocked"]

_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def solve_lower_blocked(l: torch.Tensor, g: torch.Tensor, block: int = 128,
                        *, transpose: bool = False,
                        inv_diag: torch.Tensor | None = None) -> torch.Tensor:
    """Solve ``L w = g`` (or ``Lᵀ w = g``) for lower-triangular ``l``
    (…, h, h); ``g`` is (…, h) or (…, h, q) with the same leading dims.

    ``inv_diag`` (from :func:`~repro_torch.kernels.ref.dense_diag_inverses`)
    skips the diagonal inversion; one inversion serves the forward and the
    transposed solve.
    A CPU tensor takes the plain version; a CUDA tensor launches the kernel.
    """
    squeeze = g.ndim == l.ndim - 1
    g2 = g[..., None] if squeeze else g
    if inv_diag is None:
        inv_diag = ref.dense_diag_inverses(l, block)
    if l.device.type == "cpu":
        w = ref.solve_lower_blocked(l, g2.to(l.dtype), block,
                                    transpose=transpose, inv_diag=inv_diag)
        return w[..., 0] if squeeze else w
    for t, what in ((l, "factor"), (g2, "rhs"), (inv_diag, "inverses")):
        _build.check_tensor(t, f"solve_lower_blocked {what}", l.dtype)
    h = l.shape[-1]
    nt = packing.num_tiles(h, block)
    lead = l.shape[:-2]
    if (l.shape[-2] != h or g2.shape[:-1] != (*lead, h)
            or inv_diag.shape != (*lead, nt, block, block)):
        raise ValueError(f"solve_lower_blocked: shapes {tuple(l.shape)}, "
                         f"{tuple(g.shape)}, {tuple(inv_diag.shape)} do not "
                         f"match")
    if block > 256:
        raise ValueError(f"solve_lower_blocked: block {block} > 256")
    batch, nrhs = math.prod(lead), g2.shape[-1]
    out = torch.empty_like(g2)
    if batch and nrhs:
        fn = _build.c_function("trsm", f"rt_trsm_{_build.suffix(l.dtype)}",
                               _ARGS)
        rc = fn(_build.ptr(l), _build.ptr(g2), _build.ptr(inv_diag),
                _build.ptr(out), batch, h, block, nrhs, int(transpose),
                _build.stream_ptr(l.device))
        _build.check(rc, "solve_lower_blocked")
        _build.count_launch("solve_lower_blocked")
    return out[..., 0] if squeeze else out
