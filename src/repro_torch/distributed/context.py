"""``MeshCtx``: the mesh handle and its axis-name conventions
(``src/repro/distributed/context.py``), what ``Model(cfg, ctx)`` and
``RidgeCV(ctx=)`` read.

  dp_axes — axes the rows (batch, tokens) split over;
  tp_axis — tensor/expert-parallel axis (``"model"``);
  fsdp    — whether weights also split over ``dp_axes[-1]``.

``MeshCtx(None)`` runs everything on one device.  The port has no SPMD
partitioner.  On a mesh of devices :meth:`MeshCtx.constrain` checks that
the spec names the mesh's axes, then places the tensor on the mesh's first
device, where the model lives and the CV engine's folds × λ split starts
from.  On a mesh over a world of ranks (:attr:`MeshCtx.ranks`) it checks
that the tensor has its block's shape and moves nothing: data moves only
through the collectives (:mod:`repro_torch.distributed.collectives`).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch

from .sharding import NamedSharding, _axes

__all__ = ["MeshCtx"]


@dataclasses.dataclass(frozen=True)
class MeshCtx:
    mesh: Optional[Any]
    dp_axes: Tuple[str, ...] = ("data",)
    tp_axis: str = "model"
    fsdp: bool = False

    @classmethod
    def from_mesh(cls, mesh, fsdp: bool = False) -> "MeshCtx":
        if mesh is None:
            return cls(None, fsdp=fsdp)
        dp = tuple(n for n in mesh.axis_names if n != "model")
        return cls(mesh, dp_axes=dp, tp_axis="model", fsdp=fsdp)

    @property
    def fsdp_axis(self) -> Optional[str]:
        return self.dp_axes[-1] if (self.fsdp and self.mesh is not None) \
            else None

    def axis_size(self, name: str) -> int:
        if self.mesh is None:
            return 1
        return self.mesh.shape[name]

    @property
    def tp_size(self) -> int:
        return self.axis_size(self.tp_axis) if self.mesh is not None else 1

    @property
    def dp_size(self) -> int:
        if self.mesh is None:
            return 1
        s = 1
        for a in self.dp_axes:
            s *= self.axis_size(a)
        return s

    @property
    def ranks(self) -> bool:
        """Whether the mesh is over a world of ranks (one process a
        position, each holding only its blocks)."""
        return self.mesh is not None and self.mesh.world is not None

    @property
    def world(self):
        return self.mesh.world if self.mesh is not None else None

    def rows_split(self, batch: int) -> bool:
        """Whether a batch of ``batch`` rows splits over the data axes on a
        rank mesh (else every data rank holds all of them)."""
        return self.ranks and batch % self.dp_size == 0

    def local_rows(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a whole batch ``t`` (dimension 0) on a rank
        mesh, when they split over the data axes; else ``t``."""
        if not self.rows_split(t.shape[0]):
            return t
        return NamedSharding(self.mesh, (self.dp_axes,)).local(t)

    def sharding(self, *spec) -> Optional[NamedSharding]:
        """``(mesh, spec)`` as a :class:`~repro_torch.distributed.sharding.
        NamedSharding`, or ``None`` without a mesh."""
        if self.mesh is None:
            return None
        return NamedSharding(self.mesh, spec)

    def constrain(self, x: torch.Tensor, *spec, shape=None) -> torch.Tensor:
        """``x`` on the mesh's first device, after checking that every
        axis the spec names is the mesh's; a no-op without a mesh.  On a
        rank mesh ``x`` is this rank's block of a tensor of ``shape``
        (required there): ``ValueError`` unless its shape is the spec's
        ``shard_shape``; nothing moves."""
        if self.mesh is None:
            return x
        if len(spec) > x.ndim:
            raise ValueError(f"spec {spec} has more entries than x has "
                             f"dimensions ({tuple(x.shape)})")
        for entry in spec:
            for ax in _axes(entry):
                if ax not in self.mesh.shape:
                    raise ValueError(f"axis {ax!r} is not an axis of the "
                                     f"mesh {dict(self.mesh.shape)}")
        if self.ranks:
            want = NamedSharding(self.mesh, spec).shard_shape(shape)
            if tuple(x.shape) != want:
                raise ValueError(f"a block of {tuple(x.shape)}; the spec "
                                 f"{spec} of {tuple(shape)} gives {want}")
            return x
        return x.to(self.mesh.flat[0])
