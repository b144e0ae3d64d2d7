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
chunk or a channel block), and N up to :data:`MAX_STATE`.  Both entry
points count their launches under ``ssm_scan``.

:func:`mamba_scan` is differentiable: a CUDA tensor that needs a gradient
goes through its backward kernel (:func:`mamba_scan_bwd`,
``csrc/ssm_scan_bwd.cu``), a CPU tensor through the plain backward
:func:`repro_torch.kernels.ref.mamba_scan_bwd`.  The backward needs the
float32 state at the start of every :data:`BWD_SEGMENT`-step segment.
Within :func:`segment_states` (``Model.forward`` enters it in remat's
recompute, which runs right before the layer's backward) the forward kernel
writes them and the backward reads them (counted under
``mamba_scan_bwd_ckpt``); everywhere else the backward walks the sequence
for them itself (counted under ``mamba_scan_bwd``).
:func:`ssm_scan`, the Pallas signature, stays forward-only, as the Pallas
kernel does (JAX cannot differentiate its ``pallas_call`` either).
"""
from __future__ import annotations

import contextlib
import ctypes
import threading
from typing import Callable, Optional

import torch

from . import _build, ref
from .causal_conv1d import causal_conv1d_silu

__all__ = ["MAX_STATE", "SCANS", "BWD_SEGMENT", "ssm_scan", "mamba_scan",
           "mamba_scan_bwd", "segment_states", "resolve_scan",
           "resolve_mixer"]

MAX_STATE = 32
#: ``scan=`` choices of the Mamba mixer (:func:`resolve_mixer`)
SCANS = ("auto", "cuda", "reference")

_ARGS = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
# rt_mamba_scan_*: 5 inputs, the B/C strides, a, d_skip, z, h0, y, h_last,
# states, batch, S, di, N, stream
_MIXER_ARGS = ([ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 2
               + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4
               + [ctypes.c_void_p])
# rt_mamba_scan_bwd_*: 5 inputs, the B/C strides, 4 inputs (a, d_skip, z,
# h0), dy, dh_last, 5 outputs, 2 scratch, batch, S, di, N, stream
_BWD_ARGS = ([ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 2
             + [ctypes.c_void_p] * 13 + [ctypes.c_int] * 4
             + [ctypes.c_void_p])
# rt_mamba_scan_bwd_reduce: partials in, dB, dC, dA, dD, d dt_bias out
_REDUCE_ARGS = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
#: time steps between the segment states of the backward (``kSeg`` of
#: ``csrc/ssm_scan_bwd.cu``, ``kScanSteps`` of ``csrc/ssm_scan.cu``,
#: ``ref.STATE_EVERY``)
BWD_SEGMENT = ref.STATE_EVERY
#: channels a block of the backward kernel owns (``kBwdChannels``), four
#: lanes each
BWD_CHANNELS = 64


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
    ins = [t.to(torch.float32) for t in (xc, dt, b_mat, c_mat, a, d_skip)]
    if xc.device.type == "cpu":
        return ref.ssm_scan(*ins)
    ins = [t.contiguous() for t in ins]
    if torch.is_grad_enabled() and any(t.requires_grad for t in ins):
        raise NotImplementedError(
            "ssm_scan has no backward, as the Pallas ssm_scan has none; "
            "the mixer trains through mamba_scan, whose backward is a "
            "kernel of its own")
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


def _check_mixer(xc, dt_lin, dt_bias, b_mat, c_mat, a, d_skip, z, h0,
                 what: str = "mamba_scan") -> tuple[int, int, int, int]:
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
    return bsz, s, di, n


def _card_inputs(xc, dt_lin, dt_bias, b_mat, c_mat, a, d_skip, z, h0,
                 what: str):
    """The float32 parameters made contiguous, every tensor checked for the
    kernels: (dt_bias, a, d_skip, h0)."""
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
    return dt_bias, a, d_skip, h0


def _mamba_scan_forward(xc, dt_lin, dt_bias, b_mat, c_mat, a, d_skip, z, h0,
                        states: bool = False):
    """The fused forward: the plain version on a CPU tensor, the kernel on
    a CUDA one.  Builds no graph.  Returns (y, h_last, the segment states
    or ``None``)."""
    if xc.device.type == "cpu":
        with torch.no_grad():
            out = ref.mamba_scan(xc, dt_lin, dt_bias, b_mat, c_mat, a,
                                 d_skip, z, h0, states=states)
        return out if states else (*out, None)
    what = "mamba_scan"
    bsz, s, di, n = xc.shape[0], xc.shape[1], xc.shape[2], a.shape[-1]
    dt_bias, a, d_skip, h0 = _card_inputs(xc, dt_lin, dt_bias, b_mat, c_mat,
                                          a, d_skip, z, h0, what)
    y = torch.empty_like(xc)
    h_last = torch.empty(bsz, di, n, dtype=torch.float32, device=xc.device)
    st = (torch.empty(bsz, -(-s // BWD_SEGMENT), di, n, dtype=torch.float32,
                      device=xc.device) if states else None)
    if bsz and di:
        fn = _build.c_function("ssm_scan", _build.entry("mamba_scan", xc.dtype),
                               _MIXER_ARGS)
        rc = fn(_build.ptr(xc), _build.ptr(dt_lin), _build.ptr(dt_bias),
                _build.ptr(b_mat), _build.ptr(c_mat), b_mat.stride(0),
                b_mat.stride(1), _build.ptr(a), _build.ptr(d_skip),
                _build.ptr(z), None if h0 is None else _build.ptr(h0),
                _build.ptr(y), _build.ptr(h_last),
                None if st is None else _build.ptr(st), bsz, s, di, n,
                _build.stream_ptr(xc.device))
        _build.check(rc, what)
        _build.count_launch("ssm_scan")
    return y, h_last, st


def mamba_scan_bwd(xc: torch.Tensor, dt_lin: torch.Tensor,
                   dt_bias: torch.Tensor, b_mat: torch.Tensor,
                   c_mat: torch.Tensor, a: torch.Tensor, d_skip: torch.Tensor,
                   z: torch.Tensor, dy: torch.Tensor,
                   h0: Optional[torch.Tensor] = None,
                   dh_last: Optional[torch.Tensor] = None,
                   states: Optional[torch.Tensor] = None) -> tuple:
    """The backward of :func:`mamba_scan` (its plain version is
    :func:`repro_torch.kernels.ref.mamba_scan_bwd`, whose outputs it
    returns in the same dtypes): the gradients of (xc, dt_lin, dt_bias,
    b_mat, c_mat, a, d_skip, z, h0), the last ``None`` without ``h0``.
    ``dy``: (B, S, d_inner) in xc's dtype; ``dh_last``: (B, d_inner, N) or
    ``None``; ``states``: the forward's segment states
    (``mamba_scan(..., states=True)``), (B, ceil(S / BWD_SEGMENT),
    d_inner, N) in float32 (float64 for float64 inputs), or ``None``.  A
    CPU tensor takes the plain version; a CUDA tensor launches the kernel
    (``csrc/ssm_scan_bwd.cu``: the segments last first, from ``states`` or
    after a walk of its own that forms them, then a second launch that sums
    its per-block partials in a fixed order), counted under
    ``mamba_scan_bwd_ckpt`` with ``states`` and ``mamba_scan_bwd``
    without.  ``states`` of another shape, dtype or device raises."""
    what = "mamba_scan_bwd"
    bsz, s, di, n = _check_mixer(xc, dt_lin, dt_bias, b_mat, c_mat, a,
                                 d_skip, z, h0, what)
    if tuple(dy.shape) != (bsz, s, di) or dy.dtype != xc.dtype:
        raise ValueError(f"{what}: dy must be {(bsz, s, di)} in {xc.dtype}, "
                         f"got {tuple(dy.shape)} {dy.dtype}")
    if dh_last is not None and tuple(dh_last.shape) != (bsz, di, n):
        raise ValueError(f"{what}: dh_last has shape {tuple(dh_last.shape)}, "
                         f"expected {(bsz, di, n)}")
    nseg = -(-s // BWD_SEGMENT)
    if states is not None:
        want = (bsz, nseg, di, n)
        acc = torch.promote_types(xc.dtype, torch.float32)
        if tuple(states.shape) != want or states.dtype != acc:
            raise ValueError(f"{what}: states must be {want} in {acc}, got "
                             f"{tuple(states.shape)} {states.dtype}")
        if states.device != xc.device:
            raise ValueError(f"{what}: states is on {states.device}, xc on "
                             f"{xc.device}")
    if xc.device.type == "cpu":
        return ref.mamba_scan_bwd(xc, dt_lin, dt_bias, b_mat, c_mat, a,
                                  d_skip, z, dy, h0, dh_last, states=states)
    f32 = torch.float32
    dt_bias, a, d_skip, h0 = _card_inputs(xc, dt_lin, dt_bias, b_mat, c_mat,
                                          a, d_skip, z, h0, what)
    dy = dy.contiguous()
    if dh_last is not None:
        dh_last = dh_last.to(f32).contiguous()
        _build.check_tensor(dh_last, f"{what} dh_last", f32)
    if states is not None:
        _build.check_tensor(states, f"{what} states", f32)
    dev = xc.device
    dxc, dz = torch.empty_like(xc), torch.empty_like(xc)
    ddt_lin = torch.empty(bsz, s, di, dtype=f32, device=dev)
    dh0 = (torch.empty(bsz, di, n, dtype=f32, device=dev)
           if h0 is not None else None)
    groups = -(-di // BWD_CHANNELS)
    # the state at every segment's start (given, or the walk's scratch);
    # per block the partial sums of dB and dC over its channels, and of dA,
    # dD and d dt_bias over its time
    name = what if states is None else f"{what}_ckpt"
    ckpt = (torch.empty(bsz, max(nseg, 1), di, n, dtype=f32, device=dev)
            if states is None else states)
    part_bc = torch.empty(bsz, s, groups, 2 * n, dtype=f32, device=dev)
    part_d = torch.empty(bsz, n + 2, di, dtype=f32, device=dev)
    db = torch.zeros(bsz, s, n, dtype=f32, device=dev)
    dc = torch.zeros_like(db)
    da = torch.zeros(di, n, dtype=f32, device=dev)
    dd = torch.zeros(di, dtype=f32, device=dev)
    dbias = torch.zeros(di, dtype=f32, device=dev)
    if bsz and di:
        stream = _build.stream_ptr(dev)
        fn = _build.c_function("ssm_scan_bwd", _build.entry(name, xc.dtype),
                               _BWD_ARGS)
        rc = fn(_build.ptr(xc), _build.ptr(dt_lin), _build.ptr(dt_bias),
                _build.ptr(b_mat), _build.ptr(c_mat), b_mat.stride(0),
                b_mat.stride(1), _build.ptr(a), _build.ptr(d_skip),
                _build.ptr(z), None if h0 is None else _build.ptr(h0),
                _build.ptr(dy),
                None if dh_last is None else _build.ptr(dh_last),
                _build.ptr(dxc), _build.ptr(ddt_lin), _build.ptr(dz),
                None if dh0 is None else _build.ptr(dh0),
                _build.ptr(part_bc), _build.ptr(ckpt), _build.ptr(part_d),
                bsz, s, di, n, stream)
        _build.check(rc, what)
        _build.count_launch(name)
        fn = _build.c_function("ssm_scan_bwd", "rt_mamba_scan_bwd_reduce",
                               _REDUCE_ARGS)
        rc = fn(_build.ptr(part_bc), _build.ptr(part_d), _build.ptr(db),
                _build.ptr(dc), _build.ptr(da), _build.ptr(dd),
                _build.ptr(dbias), bsz, s, di, n, groups, stream)
        _build.check(rc, f"{what} (reduce)")
        _build.count_launch(name)
    return dxc, ddt_lin, dbias, db, dc, da, dd, dz, dh0


_KEEP = threading.local()


@contextlib.contextmanager
def segment_states():
    """Within it, each differentiable :func:`mamba_scan` forward of this
    thread also keeps its segment states for its backward, which then skips
    its own walk (``mamba_scan_bwd_ckpt``).  For a forward that the
    backward follows at once: ``Model.forward`` enters it in remat's
    recompute (``checkpoint(context_fn=...)``).  Elsewhere the states, 4 ·
    N / BWD_SEGMENT bytes a (t, d), would stay alive from the forward to
    the backward."""
    prev = getattr(_KEEP, "on", False)
    _KEEP.on = True
    try:
        yield
    finally:
        _KEEP.on = prev


def _no_states(xc, a) -> torch.Tensor:
    """What a forward outside :func:`segment_states` saves in the states'
    place: one zero expanded to their shape (stride 0), so that remat's
    recompute, which saves the real states in the same slot, passes
    ``torch.utils.checkpoint``'s check of shapes, dtypes and devices."""
    bsz, s, di = xc.shape
    acc = torch.promote_types(xc.dtype, torch.float32)
    return torch.zeros((), dtype=acc, device=xc.device).expand(
        bsz, -(-s // BWD_SEGMENT), di, a.shape[-1])


class _MambaScan(torch.autograd.Function):
    """:func:`mamba_scan` with its backward: the kernel's on the card, the
    plain version's on the CPU.  The states are the forward's when it ran
    within :func:`segment_states`.  Under remat the backward reads what the
    recompute saved, though its context is the first forward's: the saved
    tensor itself, not a flag on the context, says which it is."""

    @staticmethod
    def forward(ctx, xc, dt_lin, dt_bias, b_mat, c_mat, a, d_skip, z, h0):
        y, h_last, states = _mamba_scan_forward(
            xc, dt_lin, dt_bias, b_mat, c_mat, a, d_skip, z, h0,
            states=getattr(_KEEP, "on", False))
        ctx.save_for_backward(xc, dt_lin, dt_bias, b_mat, c_mat, a, d_skip,
                              z, h0,
                              _no_states(xc, a) if states is None else states)
        ctx.set_materialize_grads(False)
        return y, h_last

    @staticmethod
    def backward(ctx, dy, dh_last):
        *ins, states = ctx.saved_tensors
        xc = ins[0]
        if dy is None:
            dy = torch.zeros_like(xc)
        grads = mamba_scan_bwd(*ins[:8], dy.to(xc.dtype), ins[8], dh_last,
                               states=states if states.stride(-1) else None)
        return tuple(None if g is None or not need else g.to(t.dtype)
                     for g, t, need in zip(grads, ins, ctx.needs_input_grad))


def mamba_scan(xc: torch.Tensor, dt_lin: torch.Tensor, dt_bias: torch.Tensor,
               b_mat: torch.Tensor, c_mat: torch.Tensor, a: torch.Tensor,
               d_skip: torch.Tensor, z: torch.Tensor,
               h0: Optional[torch.Tensor] = None, *, states: bool = False
               ) -> tuple:
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
    launches the kernel.  When grad is enabled and an input needs one, the
    call records its backward (:func:`mamba_scan_bwd`).  With ``states``,
    it records none and also returns the float32 state at the start of
    every :data:`BWD_SEGMENT`-step segment, (B, ceil(S / BWD_SEGMENT),
    d_inner, N), which :func:`mamba_scan_bwd` takes as ``states``.
    """
    _check_mixer(xc, dt_lin, dt_bias, b_mat, c_mat, a, d_skip, z, h0)
    args = (xc, dt_lin, dt_bias, b_mat, c_mat, a, d_skip, z, h0)
    if states:
        return _mamba_scan_forward(*args, states=True)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in args):
        return _MambaScan.apply(*args)
    return _mamba_scan_forward(*args)[:2]


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
