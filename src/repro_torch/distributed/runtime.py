"""The world of ranks: one process per mesh position (the port's
counterpart of the reference's SPMD devices, ``src/repro/launch/
train.py:56-62``).

:func:`init_world` joins this process to a ``torch.distributed`` world
whose size is the mesh's and returns a :class:`World`: this rank's mesh
coordinate (row-major over the mesh's axes, as ``Mesh.devices`` orders
positions), its device, and one process group per line along every set of
the mesh's axes (each axis alone, the data axes together, all of them), so
that a collective over named axes (:mod:`.collectives`) runs on the ranks
that share every other coordinate.  The mesh over such a world is
:meth:`~repro_torch.distributed.sharding.Mesh.from_world`.

The backend follows the devices: NCCL when every rank has a CUDA device of
its own (``cuda:LOCAL_RANK``), gloo on the CPU, and gloo for ranks that
share one CUDA device, but only when the caller names ``backend="gloo"``
(NCCL will not put two ranks of one communicator on one card): without it
a shared card raises ``ValueError``.  A failed NCCL initialisation raises;
nothing falls back to another backend or to the CPU.

Without ``init_method`` the world reads torchrun's environment (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``); with it
(``file://...`` or ``tcp://...``) the caller gives ``rank``.  A process may
build several meshes of the same size over its world: the first call
starts the process group, later ones only add the groups of their shape.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
import os
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

__all__ = ["World", "init_world", "KINDS"]

#: the collective kinds a world runs, by the names the byte counts use
KINDS = ("all-reduce", "all-gather", "reduce-scatter")


@dataclasses.dataclass(eq=False)
class World:
    """This rank's place in a mesh of ranks: ``coord`` maps each axis name
    to its index; ``groups`` one process group per set of axes (in mesh
    order) holding the ranks that share every other coordinate."""
    rank: int
    size: int
    dims: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    device: torch.device
    backend: str
    groups: Dict[Tuple[str, ...], object]

    @property
    def coord(self) -> Dict[str, int]:
        out, r = {}, self.rank
        for name, n in reversed(list(zip(self.axis_names, self.dims))):
            out[name] = r % n
            r //= n
        return {name: out[name] for name in self.axis_names}

    def axes(self, axes) -> Tuple[str, ...]:
        """``axes`` (a name or names) as a tuple in mesh order;
        ``ValueError`` for a name that is not the mesh's, or names out of
        its order (a tuple's first name is the major one, as in a
        ``NamedSharding``)."""
        names = (axes,) if isinstance(axes, str) else tuple(axes)
        for a in names:
            if a not in self.axis_names:
                raise ValueError(f"axis {a!r} is not an axis of the mesh "
                                 f"{dict(zip(self.axis_names, self.dims))}")
        order = [self.axis_names.index(a) for a in names]
        if order != sorted(order) or len(set(order)) != len(order):
            raise ValueError(f"axes {names} are not in the mesh's order "
                             f"{self.axis_names}")
        return names

    def axis_size(self, axes) -> int:
        sizes = dict(zip(self.axis_names, self.dims))
        return math.prod(sizes[a] for a in self.axes(axes))

    def axis_index(self, axes) -> int:
        """This rank's index along ``axes`` (the first the major one)."""
        sizes, coord, i = dict(zip(self.axis_names, self.dims)), \
            self.coord, 0
        for a in self.axes(axes):
            i = i * sizes[a] + coord[a]
        return i

    def group(self, axes):
        return self.groups[self.axes(axes)]

    def barrier(self) -> None:
        if self.size > 1:
            dist.barrier(group=self.groups[self.axis_names])


def _line_ranks(dims: Sequence[int], keep: Sequence[int]):
    """Every group of ranks that share the coordinates outside ``keep``
    (dimension indices), each listed row-major (ascending)."""
    others = [i for i in range(len(dims)) if i not in keep]
    strides = [math.prod(dims[i + 1:]) for i in range(len(dims))]
    for fixed in itertools.product(*(range(dims[i]) for i in others)):
        base = sum(c * strides[i] for c, i in zip(fixed, others))
        yield [base + sum(c * strides[i] for c, i in zip(free, keep))
               for free in itertools.product(*(range(dims[i])
                                              for i in keep))]


def init_world(shape: Sequence[int], axis_names: Sequence[str], *, device,
               backend: Optional[str] = None,
               init_method: Optional[str] = None,
               rank: Optional[int] = None) -> World:
    """Join (or reuse) the process group of ``prod(shape)`` ranks and
    return this rank's :class:`World` over the mesh ``shape`` with
    ``axis_names``.  ``device``: this rank's device (``"cpu"``, or a CUDA
    device; ``"cuda"`` is ``cuda:LOCAL_RANK``).  ``ValueError`` when the
    world's size is not the mesh's (naming the ranks it needs), for a
    shared CUDA device without ``backend="gloo"``, for NCCL off the card;
    ``RuntimeError`` when NCCL is not available."""
    dims = tuple(int(n) for n in shape)
    names = tuple(axis_names)
    if len(dims) != len(names) or len(set(names)) != len(names):
        raise ValueError(f"mesh dims {dims} and axis names {names} do not "
                         "pair up")
    size = math.prod(dims)
    if init_method is None:
        found = int(os.environ.get("WORLD_SIZE", "1"))
        if found != size:
            raise ValueError(f"a {dims} mesh needs {size} ranks; the world "
                             f"has {found} (WORLD_SIZE)")
        rank = int(os.environ.get("RANK", "0"))
        init_method = "env://"
    elif rank is None:
        raise ValueError("init_method given without this process's rank")
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    local_size = int(os.environ.get("LOCAL_WORLD_SIZE", size))
    dev = torch.device(device)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", local_rank)
        found = torch.cuda.device_count() if torch.cuda.is_available() \
            else 0
        shared = dev.index != local_rank or local_size > found
        if shared and backend != "gloo":
            raise ValueError(
                f"rank {rank} on {dev}: ranks that share a CUDA device run "
                "only over backend='gloo' (NCCL puts one rank on a card)")
        backend = backend or "nccl"
        from .._device import resolve_device
        resolve_device(dev)
        torch.cuda.set_device(dev)
    else:
        backend = backend or "gloo"
        if backend != "gloo":
            raise ValueError(f"backend {backend!r} on {dev}: the CPU runs "
                             "gloo")
    if backend == "nccl" and not dist.is_nccl_available():
        raise RuntimeError("NCCL is not available in this torch build")
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method=init_method, rank=rank,
                                world_size=size)
    elif dist.get_world_size() != size or dist.get_backend() != backend:
        raise ValueError(f"this process is in a world of "
                         f"{dist.get_world_size()} ranks over "
                         f"{dist.get_backend()}, not {size} over {backend}")
    rank = dist.get_rank()
    groups: Dict[Tuple[str, ...], object] = {}
    for n in range(1, len(dims) + 1):
        for keep in itertools.combinations(range(len(dims)), n):
            key = tuple(names[i] for i in keep)
            for ranks in _line_ranks(dims, keep):
                g = dist.new_group(ranks) if size > 1 else None
                if rank in ranks:
                    groups[key] = g
    return World(rank, size, dims, names, dev, backend, groups)
