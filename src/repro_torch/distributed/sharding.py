"""Placement over a mesh (``src/repro/distributed/sharding.py``): the LM
half (a spec tree's axes → per-leaf partition specs, the divisibility
check) and the CV half (the folds × λ mesh, the λ grid's padding and
chunking, the stage ring).

JAX expresses both as a ``Mesh``, ``NamedSharding`` and ``shard_map``.
The port has no SPMD partitioner: a mesh is a named grid of
``torch.device`` objects (:class:`Mesh`: the LM's ``("data", "model")``
or ``("pod", "data", "model")``, the CV sweep's ``(folds, lams)``), a
device may repeat, and a sharding is the pair ``(mesh, spec)``
(:class:`NamedSharding`), whose :meth:`~NamedSharding.shard_shape` and
:meth:`~NamedSharding.block` give a leaf's local shape and its block at a
mesh coordinate.  A mesh is of one of two kinds.  Over devices (which
may repeat) tensors stay whole on the mesh's first device; where the
reference's numbers depend on the partition (padded heads, the MoE's
per-shard capacity) the model computes them shard by shard
(:mod:`repro_torch.models.blocks`).  Over a world of ranks
(:meth:`Mesh.from_world`: one process per position,
:mod:`repro_torch.distributed.runtime`) each rank holds only its blocks
and exchanges with the others through :mod:`.collectives`.

The CV sweep is a dense (fold × λ) grid of independent solves, so its
natural mesh is 2-D: fold Hessians split over :data:`CV_FOLD_AXIS`, the λ
grid over :data:`CV_LAM_AXIS`; the engine places each fold group's state
and each λ shard's work on its device itself
(:class:`~repro_torch.core.engine.CVEngine` ``mesh=``).
"""
from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Any, Dict, NamedTuple, Optional, Sequence, Tuple

import torch

__all__ = ["Mesh", "NamedSharding", "spec_pspec", "param_pspecs",
           "param_shardings", "data_pspec",
           "CV_FOLD_AXIS", "CV_LAM_AXIS", "cv_mesh", "is_cv_mesh",
           "make_cv_mesh",
           "cv_axis_sizes", "mesh_shape_candidates", "pad_to_multiple",
           "chunk_lams", "auto_lam_chunk", "StageRing"]

def _axes(entry) -> Tuple[str, ...]:
    """The mesh axes of one entry of a spec (None, a name, or names)."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """A named grid of devices (``jax.sharding.Mesh``'s counterpart):
    ``devices`` row-major over ``dims``, one name per dimension in
    ``axis_names``.  :attr:`shape` maps each name to its size; a device
    may appear more than once (``[torch.device("cpu")] * 4``), and the
    ``meta`` device stands for devices that are not there (the dry run).
    A CUDA device named without an index is the current one.

    Over a world of ranks (:meth:`from_world`), ``world`` is this rank's
    :class:`~repro_torch.distributed.runtime.World` and every position
    lists this rank's device: a rank addresses only its own."""

    dims: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    devices: Tuple[torch.device, ...]
    world: Any = dataclasses.field(default=None, repr=False)

    @classmethod
    def from_world(cls, world) -> "Mesh":
        """The mesh of ``world``'s shape and axes over its ranks."""
        return cls(world.dims, world.axis_names,
                   (world.device,) * world.size, world)

    @property
    def coord(self) -> Optional[Dict[str, int]]:
        """This rank's coordinate over a world; ``None`` otherwise."""
        return None if self.world is None else self.world.coord

    def __post_init__(self):
        from .._device import canonical
        devices = tuple(canonical(d) for d in self.devices)
        dims = tuple(int(n) for n in self.dims)
        if len(dims) != len(self.axis_names) or not dims or \
                len(set(self.axis_names)) != len(dims):
            raise ValueError(f"mesh dims {dims} and axis names "
                             f"{self.axis_names} do not pair up")
        if len(devices) != math.prod(dims):
            raise ValueError(f"a {dims} mesh needs {math.prod(dims)} "
                             f"devices, got {len(devices)}")
        object.__setattr__(self, "dims", dims)
        object.__setattr__(self, "axis_names", tuple(self.axis_names))
        object.__setattr__(self, "devices", devices)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.dims))

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def flat(self) -> list:
        return list(self.devices)

    @property
    def rows(self) -> list:
        """The devices as rows along the first axis (``rows[i][j]``)."""
        n = len(self.devices) // self.dims[0]
        return [list(self.devices[i * n:(i + 1) * n])
                for i in range(self.dims[0])]

    def __repr__(self) -> str:
        if self.world is not None:
            return (f"Mesh({self.shape}, rank {self.world.rank} on "
                    f"{self.world.device})")
        kinds = sorted({str(d) for d in self.devices})
        return f"Mesh({self.shape}, devices {kinds})"


class NamedSharding(NamedTuple):
    """A placement: ``spec`` (one entry per leading dimension: ``None``,
    an axis name or a tuple of names) over ``mesh``; the pair
    ``(mesh, spec)``."""
    mesh: Any
    spec: tuple

    def _parts(self, shape) -> list:
        """Per dimension: its axes and the number of blocks they cut it
        into; ``ValueError`` when the spec does not fit ``shape``."""
        shape = tuple(shape)
        if len(self.spec) > len(shape):
            raise ValueError(f"spec {self.spec} has more entries than the "
                             f"shape {shape} has dimensions")
        sizes = self.mesh.shape
        parts = []
        for dim, entry in itertools.zip_longest(shape, self.spec):
            axes = _axes(entry)
            for ax in axes:
                if ax not in sizes:
                    raise ValueError(f"axis {ax!r} is not an axis of the "
                                     f"mesh {sizes}")
            n = math.prod(sizes[a] for a in axes)
            if dim % n:
                raise ValueError(f"dimension {dim} of {shape} is not "
                                 f"divisible by {n} ({axes} of {sizes})")
            parts.append((axes, n))
        return parts

    def shard_shape(self, shape) -> Tuple[int, ...]:
        """Each device's block shape of a leaf of ``shape``
        (``jax.sharding.NamedSharding.shard_shape``)."""
        return tuple(dim // n for dim, (_, n) in
                     zip(tuple(shape), self._parts(shape)))

    def block(self, t: torch.Tensor, coord: Dict[str, int]) -> torch.Tensor:
        """The block of ``t`` the device at ``coord`` ({axis name: index})
        holds: along a dimension split over several axes, the first is the
        major one, as in JAX."""
        sizes = self.mesh.shape
        out = t
        for d, (axes, n) in enumerate(self._parts(t.shape)):
            if n == 1:
                continue
            i = 0
            for ax in axes:
                i = i * sizes[ax] + coord[ax]
            m = t.shape[d] // n
            out = out.narrow(d, i * m, m)
        return out

    def local(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's :meth:`block` of ``t`` on a mesh over a world."""
        return self.block(t, self.mesh.coord)

    @property
    def device(self) -> torch.device:
        """Where the port keeps the leaf: the mesh's first device (over a
        world, this rank's)."""
        return self.mesh.flat[0]


def spec_pspec(spec, ctx) -> tuple:
    """The partition spec of one parameter :class:`~repro_torch.models.
    params.Spec` under ``ctx`` (``sharding.py:27-45``): ``"fsdp"`` becomes
    the innermost data axis when FSDP is on and is dropped otherwise;
    ``ValueError`` when a dimension does not divide its mesh axis."""
    out = []
    for dim, ax in zip(spec.shape, spec.axes):
        if ax is None:
            out.append(None)
            continue
        mesh_ax = ctx.fsdp_axis if ax == "fsdp" else ax
        if mesh_ax is None:
            out.append(None)
            continue
        size = ctx.axis_size(mesh_ax)
        if size > 1 and dim % size != 0:
            raise ValueError(
                f"dim {dim} of {spec.shape} not divisible by mesh axis "
                f"{mesh_ax}={size}")
        out.append(mesh_ax)
    return tuple(out)


def param_pspecs(tree: Any, ctx) -> Dict[str, tuple]:
    """Every parameter's partition spec by its dotted name."""
    from ..models.params import flatten   # local: models import this
    return {name: spec_pspec(s, ctx) for name, s in flatten(tree)}


def param_shardings(tree: Any, ctx) -> Dict[str, NamedSharding]:
    """Every parameter's :class:`NamedSharding` by its dotted name;
    ``ValueError`` without a mesh."""
    if ctx.mesh is None:
        raise ValueError("param_shardings requires a mesh")
    return {name: NamedSharding(ctx.mesh, ps)
            for name, ps in param_pspecs(tree, ctx).items()}


def data_pspec(ctx, ndim: int) -> tuple:
    """Batch-sharded partition spec for an input of rank ``ndim``."""
    return (ctx.dp_axes,) + (None,) * (ndim - 1)


CV_FOLD_AXIS = "folds"
CV_LAM_AXIS = "lams"


def cv_axis_sizes(k: int, n_devices: int) -> Tuple[int, int]:
    """(n_fold, n_lam) mesh shape for ``k`` folds on ``n_devices`` devices:
    the fold axis takes the largest device count dividing ``k`` (folds
    cannot be padded), the λ axis the rest (the λ grid can)."""
    n_fold = math.gcd(k, n_devices)
    return n_fold, n_devices // n_fold


def mesh_shape_candidates(k: int, n_devices: int) -> list:
    """Every legal (n_fold, n_lam) with ``n_fold · n_lam == n_devices`` and
    a fold axis dividing ``k`` — the mesh dimension of the autotuner's
    lattice."""
    return [(n_fold, n_devices // n_fold)
            for n_fold in range(1, n_devices + 1)
            if n_devices % n_fold == 0 and k % n_fold == 0]


def cv_mesh(devices: Sequence, n_fold: int, n_lam: int) -> Mesh:
    """A (n_fold, n_lam) :class:`Mesh` with the CV axis names over the
    first ``n_fold · n_lam`` of ``devices``: ``rows[i][j]`` runs fold group
    ``i``'s share of λ shard ``j``.  A device may appear more than once
    (the CPU tests split a mesh over ``[torch.device('cpu')] * n``)."""
    devices = list(devices)
    if len(devices) < n_fold * n_lam:
        raise ValueError(f"a ({n_fold}, {n_lam}) mesh needs "
                         f"{n_fold * n_lam} devices, got {len(devices)}")
    return Mesh((n_fold, n_lam), (CV_FOLD_AXIS, CV_LAM_AXIS),
                devices[:n_fold * n_lam])


def is_cv_mesh(mesh) -> bool:
    """Whether ``mesh`` is a :class:`Mesh` over the CV axes."""
    return isinstance(mesh, Mesh) and \
        mesh.axis_names == (CV_FOLD_AXIS, CV_LAM_AXIS)


def make_cv_mesh(k: int, devices: Optional[Sequence] = None) -> Mesh:
    """2-D (folds × lams) mesh over ``devices`` (``None``: every CUDA
    device; raises without one)."""
    if devices is None:
        from .._device import resolve_device
        resolve_device(None)
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = list(devices)
    n_fold, n_lam = cv_axis_sizes(k, len(devices))
    return cv_mesh(devices, n_fold, n_lam)


def pad_to_multiple(x: torch.Tensor, multiple: int, axis: int = 0):
    """Pad ``x`` along ``axis`` by repeating its last entry (edge mode) to
    a length divisible by ``multiple``; returns ``(padded, length)``."""
    n = x.shape[axis]
    pad = (-n) % multiple
    if pad == 0:
        return x, n
    last = x.narrow(axis, n - 1, 1)
    shape = list(x.shape)
    shape[axis] = pad
    return torch.cat([x, last.expand(*shape)], dim=axis), n


def auto_lam_chunk(h: int, block: int, dtype, budget: int) -> int:
    """λ chunk whose packed factors (at the storage ``dtype``) fit
    ``budget`` bytes — one definition for the engine's ``'auto'`` and the
    tuner's ladder."""
    from ..core import packing   # local: distributed ↔ core layering
    return max(1, int(budget // packing.packed_nbytes(h, block, dtype)))


def chunk_lams(lams: torch.Tensor, chunk: int):
    """(q,) → ((q_pad // chunk), chunk) plus q; the last chunk is
    edge-padded (an SPD shift that always factorizes), and callers cut
    the padded entries off."""
    if chunk <= 0:
        raise ValueError(f"chunk must be positive, got {chunk}")
    padded, n = pad_to_multiple(lams, chunk)
    return padded.reshape(-1, chunk), n


def _cuda_tensors(tree) -> list:
    from ..core.precision import map_tensors
    found: list = []
    map_tensors(lambda t: found.append(t) if t.is_cuda else None, tree)
    return found


class StageRing:
    """Bounded look-ahead of dispatched stages (double buffering at
    ``depth=2``): :meth:`admit` waits for the *oldest* outstanding stage
    before taking a new one, so at most ``depth`` stages (and the buffers
    they hold) are in flight.  The wait is on a ``torch.cuda.Event``
    recorded behind each staged output's last work on its device's
    current stream; a stage with no CUDA tensor has finished when it
    returns."""

    def __init__(self, depth: int = 2):
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        self.depth = depth
        self._live: list = []
        self._events: list = []

    def admit(self, staged: Any) -> Any:
        """Register a freshly dispatched stage output, waiting on the
        oldest one if the ring is full.  Returns ``staged``."""
        if len(self._live) >= self.depth:
            self._wait_oldest()
        events = []
        for dev in dict.fromkeys(t.device for t in _cuda_tensors(staged)):
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(dev))
            events.append(ev)
        self._live.append(staged)
        self._events.append(events)
        return staged

    def _wait_oldest(self) -> None:
        self._live.pop(0)
        for ev in self._events.pop(0):
            ev.synchronize()

    def drain(self) -> None:
        """Wait for everything still in flight."""
        while self._live:
            self._wait_oldest()
