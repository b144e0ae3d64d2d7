"""``MeshCtx``: the mesh handle and its axis-name conventions
(``src/repro/distributed/context.py``), what ``Model(cfg, ctx)`` and
``RidgeCV(ctx=)`` read.

  dp_axes — axes the rows (batch, tokens) split over;
  tp_axis — tensor/expert-parallel axis (``"model"``);
  fsdp    — whether weights also split over ``dp_axes[-1]``.

``MeshCtx(None)`` runs everything on one device.  The port has no SPMD
partitioner: :meth:`MeshCtx.constrain` checks that the spec names the
mesh's axes, then places the tensor on the mesh's first device, where the
model lives and the CV engine's folds × λ split starts from.
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

    def sharding(self, *spec) -> Optional[NamedSharding]:
        """``(mesh, spec)`` as a :class:`~repro_torch.distributed.sharding.
        NamedSharding`, or ``None`` without a mesh."""
        if self.mesh is None:
            return None
        return NamedSharding(self.mesh, spec)

    def constrain(self, x: torch.Tensor, *spec) -> torch.Tensor:
        """``x`` on the mesh's first device, after checking that every
        axis the spec names is the mesh's; a no-op without a mesh."""
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
        return x.to(self.mesh.flat[0])
