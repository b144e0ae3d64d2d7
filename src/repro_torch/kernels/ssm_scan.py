"""Mamba-1 selective scan as a CUDA kernel, alone or with the mixer's
passes around it.

Replaces ``src/repro/kernels/ssm_scan.py`` ``ssm_scan`` (the Pallas call at
``:83``, body ``_kernel`` ``:29``).  One kernel template
(``csrc/ssm_scan.cu``) has two entry points:

- :func:`ssm_scan`, the Pallas signature (float32, dt through softplus
  already, zero initial state);
- :func:`mamba_scan`, what the JAX mixer computes from the scan to the
  gate: softplus of ``dt_lin + dt_bias``, the scan from an optional
  initial state (the decode step), y rounded to the activation dtype and
  gated by ``silu(z)``, with B and C read in place from the ``x_proj``
  output.

A lane carries 4 states of two neighbouring channels; steps go in 8-step
chunks with one barrier a chunk, loaded 16 bytes at a time into registers
and stored to a four-slot ring in shared memory while an earlier chunk is
scanned; what depends only on (t, d) is formed once per (t, d).  Bound by
the exponentials; see the source.

Unlike the TPU kernel it takes any S and any d_inner (no multiple of a
chunk or a channel block), and N up to :data:`MAX_STATE`.  It has no
backward: training waits for one (``ROADMAP.md`` queue 1 item 10).
Both entry points count their launches under ``ssm_scan``.
"""
from __future__ import annotations

import ctypes
from typing import Callable, Optional

import torch

from . import _build, ref
from .causal_conv1d import causal_conv1d_silu

__all__ = ["MAX_STATE", "SCANS", "ssm_scan", "mamba_scan", "resolve_scan",
           "resolve_mixer"]

MAX_STATE = 32
#: ``scan=`` choices of the Mamba mixer (:func:`resolve_mixer`)
SCANS = ("auto", "cuda", "reference")

_ARGS = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
_MIXER_ARGS = ([ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 2
               + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4
               + [ctypes.c_void_p])


def _shapes(xc, dt, b_mat, c_mat, a, d_skip, what="ssm_scan"
            ) -> tuple[int, int, int, int]:
    if xc.ndim != 3:
        raise ValueError(f"{what}: xc must be (B, S, d_inner), got "
                         f"{tuple(xc.shape)}")
    bsz, s, di = xc.shape
    n = a.shape[-1] if a.ndim == 2 else -1
    want = {"dt": (dt, (bsz, s, di)), "b_mat": (b_mat, (bsz, s, n)),
            "c_mat": (c_mat, (bsz, s, n)), "a": (a, (di, n)),
            "d_skip": (d_skip, (di,))}
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{what}: {name} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
    if not 1 <= n <= MAX_STATE:
        raise ValueError(f"{what}: state size N={n} outside 1..{MAX_STATE}")
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
                                  "yet (ROADMAP.md queue 1 item 10)")
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


def mamba_scan(xc: torch.Tensor, dt_lin: torch.Tensor, dt_bias: torch.Tensor,
               b_mat: torch.Tensor, c_mat: torch.Tensor, a: torch.Tensor,
               d_skip: torch.Tensor, z: torch.Tensor,
               h0: Optional[torch.Tensor] = None
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """The Mamba-1 mixer from the scan to the gate, fused
    (:func:`repro_torch.kernels.ref.mamba_scan` is its plain version).

    xc, z: (B, S, d_inner), float32 or bfloat16 (the activation dtype),
    contiguous on the card; dt_lin: (B, S, d_inner) float32, the
    ``dt_proj`` product before its bias; dt_bias, d_skip: (d_inner,);
    b_mat, c_mat: (B, S, N) in xc's dtype, read in place: any strides with
    a unit last one, the same for both (the slices of one ``x_proj``
    output); a: (d_inner, N), negative; h0: (B, d_inner, N) or ``None``.
    Returns (y (B, S, d_inner) in xc's dtype, gated; h_last (B, d_inner, N)
    float32).  A CPU tensor takes the plain version; a CUDA tensor
    launches the kernel.
    """
    what = "mamba_scan"
    bsz, s, di, n = _shapes(xc, dt_lin, b_mat, c_mat, a, d_skip, what)
    if tuple(z.shape) != (bsz, s, di) or tuple(dt_bias.shape) != (di,):
        raise ValueError(f"{what}: z must be {(bsz, s, di)} and dt_bias "
                         f"({di},), got {tuple(z.shape)}, "
                         f"{tuple(dt_bias.shape)}")
    if h0 is not None and tuple(h0.shape) != (bsz, di, n):
        raise ValueError(f"{what}: h0 has shape {tuple(h0.shape)}, expected "
                         f"{(bsz, di, n)}")
    if xc.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{what}: xc must be float32 or bfloat16, got "
                        f"{xc.dtype}")
    if {z.dtype, b_mat.dtype, c_mat.dtype} != {xc.dtype} or \
            dt_lin.dtype != torch.float32:
        raise TypeError(f"{what}: z, b_mat and c_mat must be in xc's dtype "
                        f"{xc.dtype} and dt_lin float32; got {z.dtype}, "
                        f"{b_mat.dtype}, {c_mat.dtype}, {dt_lin.dtype}")
    if b_mat.stride(-1) != 1 or b_mat.stride() != c_mat.stride():
        raise ValueError(f"{what}: b_mat and c_mat must share their strides, "
                         f"the last one 1; got {b_mat.stride()}, "
                         f"{c_mat.stride()}")
    if xc.device.type == "cpu":
        return ref.mamba_scan(xc, dt_lin, dt_bias, b_mat, c_mat, a, d_skip, z,
                              h0)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (xc, dt_lin, dt_bias, b_mat, c_mat, a, d_skip, z, h0)):
        raise NotImplementedError(f"{what}: the CUDA kernel has no backward "
                                  "yet (ROADMAP.md queue 1 item 10)")
    f32 = torch.float32
    dt_bias, a, d_skip = (t.to(f32).contiguous() for t in (dt_bias, a, d_skip))
    if h0 is not None:
        h0 = h0.to(f32).contiguous()
    for t, what_t, dtype in ((xc, "xc", xc.dtype), (z, "z", xc.dtype),
                             (dt_lin, "dt_lin", f32), (dt_bias, "dt_bias", f32),
                             (a, "a", f32), (d_skip, "d_skip", f32),
                             (h0, "h0", f32)):
        if t is None:
            continue
        _build.check_tensor(t, f"{what} {what_t}", dtype)
        if t.device != xc.device:
            raise ValueError(f"{what}: {what_t} is on {t.device}, xc on "
                             f"{xc.device}")
    for t, what_t in ((b_mat, "b_mat"), (c_mat, "c_mat")):
        if t.device != xc.device:
            raise ValueError(f"{what}: {what_t} is on {t.device}, xc on "
                             f"{xc.device}")
    y = torch.empty_like(xc)
    h_last = torch.empty(bsz, di, n, dtype=f32, device=xc.device)
    if bsz and di:
        fn = _build.c_function("ssm_scan", _build.entry("mamba_scan", xc.dtype),
                               _MIXER_ARGS)
        rc = fn(_build.ptr(xc), _build.ptr(dt_lin), _build.ptr(dt_bias),
                _build.ptr(b_mat), _build.ptr(c_mat), b_mat.stride(0),
                b_mat.stride(1), _build.ptr(a), _build.ptr(d_skip),
                _build.ptr(z), None if h0 is None else _build.ptr(h0),
                _build.ptr(y), _build.ptr(h_last), bsz, s, di, n,
                _build.stream_ptr(xc.device))
        _build.check(rc, what)
        _build.count_launch("ssm_scan")
    return y, h_last


def resolve_scan(scan: str, device) -> Callable:
    """The scan alone that ``scan`` picks on ``device``: :func:`ssm_scan`,
    or its plain version under ``"reference"``
    (:func:`resolve_mixer` makes the choice)."""
    _, fused = resolve_mixer(scan, device)
    return ref.ssm_scan if fused is ref.mamba_scan else ssm_scan


def resolve_mixer(scan: str, device) -> tuple[Callable, Callable]:
    """The Mamba mixer's two kernels on ``device``: (the causal convolution
    with bias and silu, :func:`mamba_scan`).

    ``"auto"``: the kernels (which take their plain versions on CPU
    tensors); ``"reference"``: the plain versions on any device;
    ``"cuda"``: the kernels, and a ``ValueError`` off the card.
    """
    if scan not in SCANS:
        raise ValueError(f"unknown scan {scan!r}; expected one of {SCANS}")
    if scan == "reference":
        return ref.causal_conv1d_silu, ref.mamba_scan
    if scan == "cuda" and torch.device(device).type != "cuda":
        raise ValueError(f"scan='cuda' runs the CUDA kernels and needs CUDA "
                         f"tensors, not {torch.device(device)}")
    return causal_conv1d_silu, mamba_scan
