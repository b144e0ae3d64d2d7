"""Horner evaluation of the interpolant, as CUDA kernels: into dense
factors, and fused with the packed substitution.

``interp_factors`` replaces ``src/repro/kernels/poly_interp.py``
``interp_factors`` (the Pallas call at ``:97``, body ``_make_kernel``
``:48``): one block per (dense tile, fold, chunk of λs) Horner-evaluates
its tile of every L(λ) of the chunk from Θ and writes it straight into the
unpadded (…, q, h, h) output, upper tiles and the upper half of diagonal
tiles as zeros; the packed tile is found at its offset (no map).  It runs
at Θ's dtype, bf16 included: a bf16 Θ gives bf16 factors, each Horner step
computed in float32 and rounded to bf16 after the product and after the
sum, as torch rounds bf16 arithmetic (counted under
``interp_factors_bf16``).  Bound by bytes (the dense outputs).

``interp_solve`` replaces ``src/repro/kernels/poly_interp.py``
``interp_solve`` (the Pallas call ``_interp_sweep`` at ``:195``, body
``_make_solve_kernel`` ``:109``): for every λ of a chunk and every fold,
solve ``L(λ) L(λ)ᵀ θ = g`` with the off-diagonal tiles of L(λ)
Horner-evaluated from Θ inside the substitution walk, so no L(λ) is ever
written to device memory.  One launch runs both sweeps: a cluster of up to
8 blocks per (fold, λ, RHS column), right-looking, with the diagonal tiles
Horner-evaluated and inverted in the kernel (``csrc/tri_solve.cuh``); the
block B is a compile-time parameter, one of :data:`_build.BLOCKS`.  Bound
by bytes (Θ); see ``csrc/poly_interp.cu``.

λ is cast before ``center`` is subtracted: to Θ's dtype in
``interp_factors`` (``poly_interp.py:84``), to the accumulation dtype in
``interp_solve`` (``:238``), which is Θ's own unless the call is mixed.

``interp_solve`` with a bf16 Θ and ``compute_dtype=bfloat16`` (the mixed
variant, float32 sums, inverses and solutions) reads Θ in bf16, half the
bytes: each off-diagonal tile is Horner-evaluated in bf16 once as it
streams (x rounded to bf16, each step rounded) into a bf16 tile, and
every product runs on the bf16 tensor cores (``mma.sync`` m16n8k16) with
float32 sums, the solved segments, the inverses and g_i − acc_i rounded
to bf16 (``:128-150``).  The diagonal tiles are Horner-evaluated at
float32 from Θ, inverted there (``:245-255``) and kept in bf16
(``tri_solve_mixed_kernel``; its plain dataflow is
:func:`~repro_torch.kernels.ref.interp_solve_stored`).  It counts under
``interp_solve_bf16``.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.core import packing

from . import _build, ref

__all__ = ["interp_factors", "interp_solve"]

_ARGS = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_longlong]
         + [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int), ctypes.c_void_p])
_FACTOR_ARGS = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 5
                + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p])


def _shifted(lams: torch.Tensor, center, dtype, device) -> torch.Tensor:
    """(q,) λ − center: λ cast to ``dtype`` first, as the reference does.
    A number or CPU scalar ``center`` stays on the host (no copy to the
    device, which would wait for the stream)."""
    c = torch.as_tensor(center, dtype=dtype)
    return lams.reshape(-1).to(device=device, dtype=dtype) - c


def interp_factors(theta: torch.Tensor, lams: torch.Tensor, h: int,
                   block: int = 128, *, center=0.0) -> torch.Tensor:
    """Dense interpolated factors L(λ) at every λ.

    ``theta``: (…, r+1, P) packed coefficients (leading dims are folds)
    in float64, float32 or bf16; ``lams``: (q,).  Returns (…, q, h, h)
    lower-triangular at Θ's dtype.  A CPU tensor takes the plain version;
    a CUDA tensor launches the kernel.
    """
    lead = theta.shape[:-2]
    r1, p_size = theta.shape[-2:]
    if p_size != packing.packed_size(h, block):
        raise ValueError(f"interp_factors: theta last dim {p_size} != "
                         f"packed_size({h}, {block})")
    dt = theta.dtype
    x = _shifted(lams, center, dt, theta.device)
    if theta.device.type == "cpu":
        return ref.interp_factors(theta, x, h, block)
    n, q = math.prod(lead), x.shape[0]
    th = theta.reshape(n, r1, p_size)
    bf16 = dt == torch.bfloat16
    _build.check_tensor(th, "interp_factors theta", dt if bf16 else None)
    _build.check_tensor(x, "interp_factors lams", dt)
    nt = packing.num_tiles(h, block)
    out = torch.empty((n, q, h, h), dtype=dt, device=theta.device)
    if n and q and h:
        fn = _build.c_function("poly_interp",
                               f"rt_interp_factors_{_build.suffix(dt)}",
                               _FACTOR_ARGS)
        rc = fn(_build.ptr(th), _build.ptr(x), _build.ptr(out), n, q,
                r1 - 1, nt, block, p_size, h,
                _build.stream_ptr(theta.device))
        _build.check(rc, "interp_factors")
        _build.count_launch(_build.MIXED_NAMES["interp_factors"] if bf16
                            else "interp_factors")
    return out.reshape(*lead, q, h, h)


def interp_solve(theta: torch.Tensor, lams: torch.Tensor, g: torch.Tensor,
                 h: int, block: int = 128, *, center=0.0,
                 rhs_per_lam: bool = False, compute_dtype=None,
                 accum_dtype=None) -> torch.Tensor:
    """Solve L(λ) L(λ)ᵀ θ = g at every λ without materializing any L(λ).

    ``theta``: (…, r+1, P) packed coefficients (leading dims are folds);
    ``lams``: (q,); ``g``: (…, h) or (…, h, m) shared over λ — or, with
    ``rhs_per_lam``, (…, q, h) / (…, q, h, m).  ``compute_dtype``
    (default Θ's dtype; Θ is cast to it) is the dtype of Horner and of the
    products' operands; ``accum_dtype`` (default float32 for a 16-bit
    compute dtype, else the compute dtype) that of λ − center, g, the sums
    and the result (…, q, h) (or (…, q, h, m)).  A CPU tensor takes the
    plain version; a CUDA tensor launches the kernel (one cluster launch),
    which runs float32 or float64 throughout, or a bf16 Θ with float32
    sums, and ``block`` must then be one of :data:`_build.BLOCKS`.
    """
    cd, ad = _build.resolve_dtypes(theta.dtype, compute_dtype, accum_dtype)
    mixed = cd != ad
    theta = theta.to(cd)
    lead = theta.shape[:-2]
    r1, p_size = theta.shape[-2:]
    if p_size != packing.packed_size(h, block):
        raise ValueError(f"interp_solve: theta last dim {p_size} != "
                         f"packed_size({h}, {block})")
    nt = packing.num_tiles(h, block)
    hp = nt * block
    n = math.prod(lead)
    lams = lams.reshape(-1)
    q = lams.shape[0]
    squeeze = g.ndim == len(lead) + (2 if rhs_per_lam else 1)
    g2 = (g[..., None] if squeeze else g).to(ad)
    g2 = torch.nn.functional.pad(g2, (0, 0, 0, hp - h))
    g2 = g2.reshape(n, q, hp, -1) if rhs_per_lam else g2.reshape(n, hp, -1)
    th = theta.reshape(n, r1, p_size)
    x = _shifted(lams, center, ad, theta.device)

    if theta.device.type == "cpu":
        inv = ref.interp_diag_inverses(th, x, h, block, ad)
        out = ref.interp_solve(th, x, inv, g2, h, block,
                               cd if mixed else None)
    else:
        _build.check_mixed(cd, ad, "interp_solve")
        _build.check_block(block, "interp_solve")
        g2 = g2.contiguous()
        for t, what, dt in ((th, "theta", cd), (x, "lams", ad),
                            (g2, "rhs", ad)):
            _build.check_tensor(t, f"interp_solve {what}", dt)
        nrhs = g2.shape[-1]
        out = torch.empty((n, q, hp, nrhs), dtype=ad, device=theta.device)
        if n and q and nrhs:
            fn = _build.c_function("poly_interp",
                                   _build.entry("interp_solve", ad, cd),
                                   _ARGS)
            _build.launch_solve(
                _build.MIXED_NAMES["interp_solve"] if mixed
                else "interp_solve", fn,
                (_build.ptr(th), _build.ptr(x), _build.ptr(g2)),
                (_build.ptr(out), n, q, r1 - 1, nt, block, p_size, nrhs,
                 int(rhs_per_lam), h),
                (n * q * nrhs, nt, block, ad), theta.device)
    out = out[:, :, :h].reshape(*lead, q, h, -1)
    return out[..., 0] if squeeze else out
