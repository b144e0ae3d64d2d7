"""Collectives over named mesh axes between ranks (``jax.lax.psum``,
``pmean``, ``pmax``, ``all_gather(tiled=True)`` and ``psum_scatter(tiled=
True)`` under ``shard_map``), by ``torch.distributed`` over a
:class:`~repro_torch.distributed.runtime.World`'s groups.

Each is a ``torch.autograd.Function`` whose backward is JAX's transpose:
``psum``'s is ``psum`` (every rank's output is an output of its own, so
the gradient of an input sums the gradients of all of them), ``pmean``'s
``pmean``, the tiled gather's a reduce-scatter along the same dimension
and the reduce-scatter's a gather; ``pmax`` has no gradient, as in JAX.  A
program built of them is differentiated as the reference's SPMD program
is: the gradient of ``Σ_rank c · loss_rank``.  Over an axis of size 1
each returns its input (a gather or reduce-scatter: the input itself).

Every call adds, per kind (``all-reduce``, ``all-gather``,
``reduce-scatter``), the payload bytes (the tensor it reduces, or the
gathered result) to :data:`PAYLOAD` and the bytes a ring moves per rank
(``distributed/plan_cost.py``'s formulas: 2(g−1)/g of an all-reduce's
tensor, (g−1)/g of a gather's result or a reduce-scatter's input) to
:data:`WIRE`; :func:`reset_bytes` sets both to 0.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.distributed as dist

from .runtime import KINDS, World

__all__ = ["psum", "pmean", "pmax", "all_gather", "psum_scatter",
           "PAYLOAD", "WIRE", "reset_bytes"]

PAYLOAD: Dict[str, int] = {k: 0 for k in KINDS}
WIRE: Dict[str, float] = {k: 0.0 for k in KINDS}


def reset_bytes() -> None:
    for k in KINDS:
        PAYLOAD[k], WIRE[k] = 0, 0.0


def _count(kind: str, nbytes: int, g: int) -> None:
    PAYLOAD[kind] += nbytes
    WIRE[kind] += nbytes * (2.0 if kind == "all-reduce" else 1.0) \
        * (g - 1) / g


def _all_reduce(t: torch.Tensor, op, world: World, axes) -> torch.Tensor:
    """``t`` reduced in place over ``axes``."""
    dist.all_reduce(t, op=op, group=world.group(axes))
    return t


def _gather0(x: torch.Tensor, world: World, axes) -> torch.Tensor:
    """(m, ...) → (g·m, ...), the blocks in rank order along ``axes``."""
    x = x.contiguous()
    out = x.new_empty((world.axis_size(axes) * x.shape[0],)
                      + tuple(x.shape[1:]))
    dist.all_gather_into_tensor(out, x, group=world.group(axes))
    return out


def _scatter0(x: torch.Tensor, world: World, axes) -> torch.Tensor:
    """(g·m, ...) summed over ``axes`` → this rank's (m, ...) block."""
    x = x.contiguous()
    out = x.new_empty((x.shape[0] // world.axis_size(axes),)
                      + tuple(x.shape[1:]))
    dist.reduce_scatter_tensor(out, x, op=dist.ReduceOp.SUM,
                               group=world.group(axes))
    return out


def _trivial(world: World, axes) -> bool:
    return world is None or world.axis_size(axes) == 1


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, world, axes):
        ctx.world, ctx.axes = world, axes
        _count("all-reduce", x.numel() * x.element_size(),
               world.axis_size(axes))
        return _all_reduce(x.clone(memory_format=torch.contiguous_format),
                           dist.ReduceOp.SUM, world, axes)

    @staticmethod
    def backward(ctx, g):
        return _PSum.apply(g, ctx.world, ctx.axes), None, None


class _PMax(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, world, axes):
        _count("all-reduce", x.numel() * x.element_size(),
               world.axis_size(axes))
        return _all_reduce(x.clone(memory_format=torch.contiguous_format),
                           dist.ReduceOp.MAX, world, axes)

    @staticmethod
    def backward(ctx, g):
        raise NotImplementedError("pmax has no gradient (nor has "
                                  "jax.lax.pmax)")


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, world, axes, dim):
        ctx.world, ctx.axes, ctx.dim = world, axes, dim
        g = world.axis_size(axes)
        out = _gather0(x.movedim(dim, 0), world, axes)
        _count("all-gather", out.numel() * out.element_size(), g)
        return out.movedim(0, dim)

    @staticmethod
    def backward(ctx, g):
        return _Scatter.apply(g, ctx.world, ctx.axes, ctx.dim), None, None, \
            None


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, world, axes, dim):
        ctx.world, ctx.axes, ctx.dim = world, axes, dim
        g = world.axis_size(axes)
        if x.shape[dim] % g:
            raise ValueError(f"dimension {dim} of {tuple(x.shape)} is not "
                             f"divisible by {g} ({axes})")
        _count("reduce-scatter", x.numel() * x.element_size(), g)
        out = _scatter0(x.movedim(dim, 0), world, axes)
        return out.movedim(0, dim)

    @staticmethod
    def backward(ctx, g):
        return _Gather.apply(g, ctx.world, ctx.axes, ctx.dim), None, None, \
            None


def psum(x: torch.Tensor, axes, world: World) -> torch.Tensor:
    """The sum of ``x`` over the ranks along ``axes`` (a name or names)."""
    if _trivial(world, axes):
        return x
    return _PSum.apply(x, world, world.axes(axes))


def pmean(x: torch.Tensor, axes, world: World) -> torch.Tensor:
    if _trivial(world, axes):
        return x
    return psum(x, axes, world) / world.axis_size(axes)


def pmax(x: torch.Tensor, axes, world: World) -> torch.Tensor:
    if _trivial(world, axes):
        return x
    return _PMax.apply(x, world, world.axes(axes))


def all_gather(x: torch.Tensor, axes, world: World, *, axis: int = 0
               ) -> torch.Tensor:
    """The ranks' blocks along ``axes`` concatenated along dimension
    ``axis``, in rank order (``all_gather(tiled=True)``)."""
    if _trivial(world, axes):
        return x
    return _Gather.apply(x, world, world.axes(axes), axis % x.ndim)


def psum_scatter(x: torch.Tensor, axes, world: World, *, axis: int = 0
                 ) -> torch.Tensor:
    """The sum over the ranks along ``axes``, split along dimension
    ``axis`` into their blocks; this rank's block
    (``psum_scatter(tiled=True)``)."""
    if _trivial(world, axes):
        return x
    return _Scatter.apply(x, world, world.axes(axes), axis % x.ndim)
