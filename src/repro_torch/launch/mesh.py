"""The LM's meshes (``src/repro/launch/mesh.py``).

Single pod: (16, 16) = 256 devices, axes ``("data", "model")``.  Multi-pod:
(2, 16, 16) = 512, axes ``("pod", "data", "model")``; the ``pod`` axis
carries only data parallelism.  A mesh is a
:class:`~repro_torch.distributed.sharding.Mesh`, a named grid of
``torch.device`` objects.  Nothing is built from devices the caller did
not name: without ``devices`` a mesh takes every CUDA device and raises
``ValueError`` when their count is not the mesh's; ``devices="meta"``
builds it over the ``meta`` device, for the dry run; an explicit list may
repeat a device (the port runs one card: a (1, 16) mesh over ``[cuda:0] *
16`` computes what sixteen cards would).  With ``world=`` (a
:class:`~repro_torch.distributed.runtime.World` of that shape) a mesh is
built over the world's ranks instead, one process a position
(:meth:`~repro_torch.distributed.sharding.Mesh.from_world`); a world of
another shape raises ``ValueError`` naming the ranks the mesh needs.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Union

import torch

from repro_torch._device import resolve_device
from repro_torch.distributed.sharding import Mesh

__all__ = ["make_production_mesh", "make_debug_mesh", "production_shape"]


def production_shape(multi_pod: bool = False):
    """(dims, axis names) of the production mesh."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def _over_world(world, dims, axes, what: str) -> Mesh:
    if tuple(world.dims) != tuple(dims) or \
            tuple(world.axis_names) != tuple(axes):
        raise ValueError(f"the {what} mesh {tuple(dims)} needs "
                         f"{math.prod(dims)} ranks over {tuple(axes)}; the "
                         f"world is {tuple(world.dims)} over "
                         f"{tuple(world.axis_names)}")
    return Mesh.from_world(world)


def _devices(n: int, devices: Union[None, str, Sequence], what: str) -> list:
    """``n`` devices: ``"meta"``, the caller's list (exactly ``n``), or
    every CUDA device (exactly ``n`` of them)."""
    if isinstance(devices, str) and devices == "meta":
        return [torch.device("meta")] * n
    if devices is None:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if found != n:
            raise ValueError(f"the {what} mesh needs {n} CUDA devices, "
                             f"found {found}")
        resolve_device("cuda")
        return [torch.device("cuda", i) for i in range(n)]
    devices = [torch.device(d) for d in devices]
    if len(devices) != n:
        raise ValueError(f"the {what} mesh needs {n} devices, got "
                         f"{len(devices)}")
    return devices


def make_production_mesh(*, multi_pod: bool = False,
                         devices: Union[None, str, Sequence] = None,
                         world=None) -> Mesh:
    """(16, 16) ``("data", "model")``, or (2, 16, 16) ``("pod", "data",
    "model")`` with ``multi_pod``: over every CUDA device (``ValueError``
    naming 256 or 512 against the count found), ``devices="meta"`` (the dry
    run), the caller's 256 or 512 devices, or a ``world`` of that many
    ranks."""
    shape, axes = production_shape(multi_pod)
    what = "multi-pod production" if multi_pod else "production"
    if world is not None:
        return _over_world(world, shape, axes, what)
    return Mesh(shape, axes, _devices(math.prod(shape), devices, what))


def make_debug_mesh(data: int = 1, model: int = 1,
                    devices: Optional[Sequence] = None, world=None) -> Mesh:
    """A (data, model) mesh over the first ``data · model`` CUDA devices
    (``ValueError`` when there are fewer), over ``devices`` (exactly that
    many; one may repeat), or over a ``world`` of that many ranks."""
    if world is not None:
        return _over_world(world, (data, model), ("data", "model"), "debug")
    n = data * model
    if devices is None:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if found < n:
            raise ValueError(f"a ({data}, {model}) mesh needs {n} CUDA "
                             f"devices, found {found}")
        resolve_device("cuda")
        devices = [torch.device("cuda", i) for i in range(n)]
    return Mesh((data, model), ("data", "model"),
                _devices(n, list(devices), "debug"))
