"""The CV half of the JAX package's ``distributed/sharding.py``: the
folds × λ mesh, the λ grid's padding and chunking, and the stage ring.

The CV sweep is a dense (fold × λ) grid of independent solves, so its
natural mesh is 2-D: fold Hessians split over :data:`CV_FOLD_AXIS`, the λ
grid over :data:`CV_LAM_AXIS`.  JAX expresses that as a ``Mesh`` and
``shard_map``; the port has no SPMD partitioner, so :class:`CVMesh` is a
plain ``(n_fold, n_lam)`` grid of ``torch.device``\\ s and the engine
places each fold group's state and each λ shard's work on its device
itself (:class:`~repro_torch.core.engine.CVEngine` ``mesh=``).

The LM half (``spec_pspec``, ``param_pspecs``, ``param_shardings``,
``data_pspec``) comes with the port of training.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Sequence, Tuple

import torch

__all__ = ["CV_FOLD_AXIS", "CV_LAM_AXIS", "CVMesh", "make_cv_mesh",
           "cv_axis_sizes", "mesh_shape_candidates", "pad_to_multiple",
           "chunk_lams", "auto_lam_chunk", "StageRing"]

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


@dataclasses.dataclass(frozen=True, eq=False)
class CVMesh:
    """A (n_fold, n_lam) grid of devices with the CV axis names.

    ``devices[i][j]`` runs fold group ``i``'s share of λ shard ``j``;
    :attr:`shape` is keyed by the axis names, as ``jax.sharding.Mesh``
    has it.  A device may appear more than once (the CPU tests split a
    mesh over ``[torch.device('cpu')] * n``)."""

    devices: Tuple[Tuple[torch.device, ...], ...]
    axis_names: Tuple[str, str] = (CV_FOLD_AXIS, CV_LAM_AXIS)

    def __post_init__(self):
        rows = tuple(tuple(torch.device(d) for d in row)
                     for row in self.devices)
        if not rows or not rows[0] or len({len(r) for r in rows}) != 1:
            raise ValueError("CVMesh needs a non-empty rectangular grid of "
                             f"devices, got {self.devices!r}")
        object.__setattr__(self, "devices", rows)

    @classmethod
    def from_devices(cls, devices: Sequence, n_fold: int,
                     n_lam: int) -> "CVMesh":
        devices = list(devices)
        if len(devices) < n_fold * n_lam:
            raise ValueError(f"a ({n_fold}, {n_lam}) mesh needs "
                             f"{n_fold * n_lam} devices, got {len(devices)}")
        return cls(tuple(tuple(devices[i * n_lam:(i + 1) * n_lam])
                         for i in range(n_fold)))

    @property
    def shape(self) -> dict:
        return {CV_FOLD_AXIS: len(self.devices),
                CV_LAM_AXIS: len(self.devices[0])}

    @property
    def size(self) -> int:
        return len(self.devices) * len(self.devices[0])

    @property
    def flat(self) -> list:
        return [d for row in self.devices for d in row]

    def __repr__(self) -> str:
        return (f"CVMesh({self.shape}, "
                f"{[[str(d) for d in r] for r in self.devices]})")


def make_cv_mesh(k: int, devices: Optional[Sequence] = None) -> CVMesh:
    """2-D (folds × lams) mesh over ``devices`` (``None``: every CUDA
    device; raises without one)."""
    if devices is None:
        from .._device import resolve_device
        resolve_device(None)
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = list(devices)
    n_fold, n_lam = cv_axis_sizes(k, len(devices))
    return CVMesh.from_devices(devices, n_fold, n_lam)


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
