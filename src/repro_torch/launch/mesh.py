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
16`` computes what sixteen cards would).
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Union

import torch

from repro_torch._device import resolve_device
from repro_torch.distributed.sharding import Mesh

__all__ = ["make_production_mesh", "make_debug_mesh"]


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
                         devices: Union[None, str, Sequence] = None) -> Mesh:
    """(16, 16) ``("data", "model")``, or (2, 16, 16) ``("pod", "data",
    "model")`` with ``multi_pod``: over every CUDA device (``ValueError``
    naming 256 or 512 against the count found), ``devices="meta"`` (the dry
    run), or the caller's 256 or 512 devices."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    what = "multi-pod production" if multi_pod else "production"
    return Mesh(shape, axes, _devices(math.prod(shape), devices, what))


def make_debug_mesh(data: int = 1, model: int = 1,
                    devices: Optional[Sequence] = None) -> Mesh:
    """A (data, model) mesh over the first ``data · model`` CUDA devices
    (``ValueError`` when there are fewer), or over ``devices`` (exactly
    that many; one may repeat)."""
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
