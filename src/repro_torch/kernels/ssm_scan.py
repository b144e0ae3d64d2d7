"""Mamba-1 selective scan as a CUDA kernel.

Replaces ``src/repro/kernels/ssm_scan.py`` ``ssm_scan`` (the Pallas call at
``:83``, body ``_kernel`` ``:29``): one thread per (batch row, channel)
carries all N states of its channel in registers over every time step;
blocks of 64 channels stage x, dt, B and C for 32 steps in shared memory.
Bound by the exponentials, just above the bytes; see ``csrc/ssm_scan.cu``.

Unlike the TPU kernel it takes any S and any d_inner (no multiple of a
chunk or a channel block), and N up to :data:`MAX_STATE`.  It has no
backward: training waits for one (``ROADMAP.md`` queue 1 item 13).
"""
from __future__ import annotations

import ctypes
from typing import Callable

import torch

from . import _build, ref

__all__ = ["MAX_STATE", "SCANS", "ssm_scan", "resolve_scan"]

MAX_STATE = 32
#: ``scan=`` choices of the Mamba mixer (:func:`resolve_scan`)
SCANS = ("auto", "cuda", "reference")

_ARGS = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def _shapes(xc, dt, b_mat, c_mat, a, d_skip) -> tuple[int, int, int, int]:
    if xc.ndim != 3:
        raise ValueError(f"ssm_scan: xc must be (B, S, d_inner), got "
                         f"{tuple(xc.shape)}")
    bsz, s, di = xc.shape
    n = a.shape[-1] if a.ndim == 2 else -1
    want = {"dt": (dt, (bsz, s, di)), "b_mat": (b_mat, (bsz, s, n)),
            "c_mat": (c_mat, (bsz, s, n)), "a": (a, (di, n)),
            "d_skip": (d_skip, (di,))}
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"ssm_scan: {name} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
    if not 1 <= n <= MAX_STATE:
        raise ValueError(f"ssm_scan: state size N={n} outside 1..{MAX_STATE}")
    return bsz, s, di, n


def ssm_scan(xc: torch.Tensor, dt: torch.Tensor, b_mat: torch.Tensor,
             c_mat: torch.Tensor, a: torch.Tensor, d_skip: torch.Tensor
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused selective scan.

    xc, dt: (B, S, d_inner); b_mat, c_mat: (B, S, N); a: (d_inner, N),
    negative; d_skip: (d_inner,).  Every input is cast to float32, as the
    TPU kernel casts them.  Returns (y (B, S, d_inner), h_last
    (B, d_inner, N)), both float32.
    A CPU tensor takes the plain version; a CUDA tensor launches the kernel.
    """
    bsz, s, di, n = _shapes(xc, dt, b_mat, c_mat, a, d_skip)
    if xc.device.type == "cpu":
        return ref.ssm_scan(xc, dt, b_mat, c_mat, a, d_skip)
    ins = [t.to(torch.float32).contiguous()
           for t in (xc, dt, b_mat, c_mat, a, d_skip)]
    if torch.is_grad_enabled() and any(t.requires_grad for t in ins):
        raise NotImplementedError("ssm_scan: the CUDA kernel has no backward "
                                  "yet (ROADMAP.md queue 1 item 13)")
    for t, what in zip(ins, ("xc", "dt", "b_mat", "c_mat", "a", "d_skip")):
        _build.check_tensor(t, f"ssm_scan {what}", torch.float32)
        if t.device != xc.device:
            raise ValueError(f"ssm_scan: {what} is on {t.device}, xc on "
                             f"{xc.device}")
    y = torch.empty(bsz, s, di, dtype=torch.float32, device=xc.device)
    h_last = torch.empty(bsz, di, n, dtype=torch.float32, device=xc.device)
    if bsz and di:
        fn = _build.c_function("ssm_scan", "rt_ssm_scan_f32", _ARGS)
        rc = fn(*(_build.ptr(t) for t in (*ins, y, h_last)), bsz, s, di, n,
                _build.stream_ptr(xc.device))
        _build.check(rc, "ssm_scan")
        _build.count_launch("ssm_scan")
    return y, h_last


def resolve_scan(scan: str, device) -> Callable:
    """The scan a Mamba mixer runs on ``device``.

    ``"auto"``: :func:`ssm_scan` (the kernel for CUDA tensors, the plain
    version for CPU ones); ``"reference"``: the plain version on any
    device; ``"cuda"``: the kernel, and a ``ValueError`` off the card.
    """
    if scan not in SCANS:
        raise ValueError(f"unknown scan {scan!r}; expected one of {SCANS}")
    if scan == "reference":
        return ref.ssm_scan
    if scan == "cuda" and torch.device(device).type != "cuda":
        raise ValueError(f"scan='cuda' runs the CUDA kernel and needs CUDA "
                         f"tensors, not {torch.device(device)}")
    return ssm_scan
