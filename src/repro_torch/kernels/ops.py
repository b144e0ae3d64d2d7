"""The kernel layer's public entry points, under the JAX package's names
(``src/repro/kernels/ops.py:22-90``).

Each dispatches by the device of its tensors, through the kernel wrappers:
a CUDA tensor launches the hand-written kernel, a CPU tensor runs the
kernel's plain version.  ``REPRO_KERNELS=ref`` asks for the plain versions
(the reference's switch); they run on the CPU only, so with it set a call
on CUDA tensors raises instead of leaving the card's kernels unrun.
"""
from __future__ import annotations

import os

import torch

from . import chol_blocked, packed_trsm, poly_interp, ssm_scan as scan_mod, \
    tri_pack, trsm

__all__ = ["kernel_backend", "pack_tril", "unpack_tril", "cholesky",
           "interp_factors", "interp_solve", "solve_lower",
           "solve_lower_packed", "solve_packed", "solve_factor_sweep",
           "ssm_scan"]


def kernel_backend() -> str:
    """``REPRO_KERNELS``: ``'ref'`` for the plain versions, anything else
    (default ``'cuda'``) for the kernels."""
    return os.environ.get("REPRO_KERNELS", "cuda")


def _dispatch(what: str, *tensors: torch.Tensor) -> None:
    """Raise when ``REPRO_KERNELS=ref`` meets a CUDA tensor."""
    if kernel_backend() == "ref" and any(t.is_cuda for t in tensors):
        raise RuntimeError(
            f"ops.{what}: REPRO_KERNELS=ref selects the plain versions, "
            "which run on CPU tensors only; on the card the kernels run "
            "(unset REPRO_KERNELS) or the tensors go to the CPU")


def pack_tril(mat, block: int = 128):
    _dispatch("pack_tril", mat)
    return tri_pack.pack_tril(mat, block)


def unpack_tril(vec, h: int, block: int = 128):
    _dispatch("unpack_tril", vec)
    return tri_pack.unpack_tril(vec, h, block)


def cholesky(a, block: int = 128):
    _dispatch("cholesky", a)
    return chol_blocked.cholesky_blocked(a, block)


def interp_factors(theta, lams, h: int, block: int = 128, center=0.0):
    _dispatch("interp_factors", theta)
    lams = torch.as_tensor(lams, device=theta.device)
    return poly_interp.interp_factors(theta, lams, h, block, center=center)


def solve_lower(l, g, block: int = 128, *, transpose: bool = False):
    _dispatch("solve_lower", l, g)
    return trsm.solve_lower_blocked(l, g, block, transpose=transpose)


def solve_lower_packed(vec, g, h: int, block: int = 128, *,
                       transpose: bool = False):
    _dispatch("solve_lower_packed", vec, g)
    return packed_trsm.solve_lower_packed(vec, g, h, block,
                                          transpose=transpose)


def solve_packed(vec, g, h: int, block: int = 128):
    _dispatch("solve_packed", vec, g)
    return packed_trsm.solve_packed(vec, g, h, block)


def interp_solve(theta, lams, g, h: int, block: int = 128, center=0.0):
    _dispatch("interp_solve", theta, g)
    lams = torch.as_tensor(lams, device=theta.device)
    return poly_interp.interp_solve(theta, lams, g, h, block, center=center)


def solve_factor_sweep(ls, g, block: int = 128):
    """L_t L_tᵀ θ_t = g for a sweep of dense factors: ls (q, h, h), g (h,)
    shared → (q, h); two launches of the dense trsm."""
    _dispatch("solve_factor_sweep", ls, g)
    gs = g.expand(ls.shape[0], *g.shape).contiguous()
    w = trsm.solve_lower_blocked(ls, gs, block)
    return trsm.solve_lower_blocked(ls, w, block, transpose=True)


def ssm_scan(xc, dt, b_mat, c_mat, a, d_skip):
    """The selective scan → (y, h_last); the kernel's tiling is its own
    (the reference's ``chunk``/``di_block`` have no counterpart)."""
    _dispatch("ssm_scan", xc, dt, b_mat, c_mat, a, d_skip)
    return scan_mod.ssm_scan(xc, dt, b_mat, c_mat, a, d_skip)
