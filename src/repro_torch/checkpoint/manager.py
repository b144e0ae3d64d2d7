"""Fault-tolerant checkpointing (``src/repro/checkpoint/manager.py``).

Guarantees:

* **Atomicity** — leaves land in ``step_<N>.tmp/``; a manifest (tree
  structure and per-leaf sha256) is written last, and the directory is
  ``os.replace``d into place only after everything is written.  A crash
  mid-write never corrupts the latest valid checkpoint.
* **Auto-resume** — :meth:`CheckpointManager.restore_latest` walks the
  checkpoints newest first and skips any whose manifest hash check fails,
  restoring the newest valid one.
* **Placement** — checkpoints hold full tensors on disk; ``restore`` puts
  every leaf on the caller's ``device`` (``None``: the CUDA device), or on
  its placement where ``shardings`` gives one (a tree over ``like`` whose
  :class:`~repro_torch.distributed.sharding.NamedSharding` entries place
  every leaf below them, after checking that the spec fits the leaf's
  shape; the port keeps a placed leaf whole on its mesh's first device).
* **Async** — ``save_async`` copies every leaf to the host before it
  returns (a blocking copy, so the snapshot is complete), then writes on a
  worker thread.
* **Any mesh** — the files do not depend on the mesh (as the reference's,
  ``manager.py:11-13``).  On a mesh over a world of ranks, where each rank
  holds its blocks, ``save`` and ``save_async`` take the tree's
  ``shardings``: leaf by leaf, the ranks holding its distinct blocks send
  them to rank 0 (no other rank holds a whole leaf), rank 0 writes the
  same logical arrays in the same format, and the ranks meet
  at a barrier once the write is done (in ``wait`` for ``save_async``);
  ``restore`` with ``shardings`` on such a mesh gives each rank its
  block of every leaf.

A bf16 leaf goes to disk as its raw 16-bit view (``uint16``) with
``bfloat16`` in the manifest, and comes back through a torch view: numpy
has no bf16 type of its own.

Trees are nested dicts (keys sorted), tuples, ``NamedTuple``s (the
optimizer states; rebuilt as their own class) and lists of tensors, with
dataclasses (``PiCholesky``, ``PackedFactor``, ``LowRankFactors``) whose
tensor fields are children and whose other fields ride in the structure;
``None`` holds no leaf.
"""
from __future__ import annotations

import dataclasses
import hashlib
import itertools
import json
import math
import os
import shutil
import threading
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from .._device import resolve_device

__all__ = ["CheckpointManager", "tree_flatten", "tree_unflatten",
           "tree_leaves"]


def _is_node(x) -> bool:
    return isinstance(x, (dict, list, tuple)) or (
        dataclasses.is_dataclass(x) and not isinstance(x, type))


def tree_flatten(tree: Any) -> Tuple[List[Any], Any]:
    """(leaves, structure) of a tree; ``None`` is an empty subtree."""
    leaves: List[Any] = []

    def walk(x):
        if x is None:
            return ("none",)
        if isinstance(x, dict):
            keys = sorted(x)
            return ("dict", tuple(keys), tuple(walk(x[k]) for k in keys))
        if isinstance(x, tuple) and hasattr(type(x), "_fields"):
            return ("namedtuple", type(x), tuple(walk(v) for v in x))
        if isinstance(x, (list, tuple)):
            return (type(x).__name__, tuple(walk(v) for v in x))
        if dataclasses.is_dataclass(x) and not isinstance(x, type):
            kids, static = {}, {}
            for f in dataclasses.fields(x):
                v = getattr(x, f.name)
                if v is None or isinstance(v, (torch.Tensor, np.ndarray)) \
                        or _is_node(v):
                    kids[f.name] = walk(v)
                else:
                    static[f.name] = v
            return ("dataclass", type(x), tuple(sorted(static.items())),
                    tuple(kids.items()))
        leaves.append(x)
        return ("leaf",)

    return leaves, walk(tree)


def tree_leaves(tree: Any) -> List[Any]:
    return tree_flatten(tree)[0]


def tree_unflatten(structure: Any, leaves: List[Any]) -> Any:
    """Inverse of :func:`tree_flatten`."""
    it = iter(leaves)

    def build(s):
        kind = s[0]
        if kind == "none":
            return None
        if kind == "leaf":
            return next(it)
        if kind == "dict":
            return {k: build(c) for k, c in zip(s[1], s[2])}
        if kind in ("list", "tuple"):
            vals = [build(c) for c in s[1]]
            return vals if kind == "list" else tuple(vals)
        if kind == "namedtuple":
            return s[1](*(build(c) for c in s[2]))
        cls, static, kids = s[1], dict(s[2]), s[3]
        return cls(**static, **{name: build(c) for name, c in kids})

    return build(structure)


def _placements(like: Any, shardings: Any) -> list:
    """Per leaf of ``like``, in :func:`tree_flatten`'s order, its
    placement: ``shardings`` mirrors ``like`` down to a ``NamedSharding``
    (every leaf below it) or ``None`` (the caller's device)."""
    # local: the distributed package imports this module
    from ..distributed.sharding import NamedSharding
    if shardings is None or isinstance(shardings, NamedSharding):
        return [shardings] * len(tree_leaves(like))
    out: list = []
    if isinstance(like, dict):
        for k in sorted(like):
            out += _placements(like[k], shardings.get(k))
    elif isinstance(like, (list, tuple)):
        if len(shardings) != len(like):
            raise ValueError(f"shardings of {len(shardings)} entries for "
                             f"{len(like)}")
        for x, sh in zip(like, shardings):
            out += _placements(x, sh)
    else:
        raise ValueError(f"shardings {type(shardings).__name__} for a "
                         f"{type(like).__name__}")
    return out


def _world(places: list):
    """The world of the first placement on a mesh of ranks, or None."""
    for sh in places:
        if sh is not None and getattr(sh.mesh, "world", None) is not None:
            return sh.mesh.world
    return None


def _gathered(leaves: list, places: list, world) -> Optional[list]:
    """On rank 0 every leaf whole, else ``None``.  Leaf by leaf, the ranks
    on rank 0's line along the axes the leaf is split over (they hold its
    distinct blocks) send their blocks to rank 0 (``dist.gather``), which
    puts each at its place: no other rank holds more than its blocks, and
    rank 0 one whole leaf beside them at a time."""
    import torch.distributed as dist
    from ..distributed.sharding import _axes
    sizes, coord, out = dict(zip(world.axis_names, world.dims)), \
        world.coord, []
    with torch.no_grad():
        for leaf, sh in zip(leaves, places):
            split = set() if sh is None or not isinstance(
                leaf, torch.Tensor) else {a for e in sh.spec
                                          for a in _axes(e)}
            axes = tuple(a for a in world.axis_names
                         if a in split and sizes[a] > 1)
            if not axes:
                out.append(leaf)
                continue
            if any(coord[a] for a in world.axis_names if a not in axes):
                continue            # not on rank 0's line: sends nothing
            blk = leaf.contiguous()
            bufs = [torch.empty_like(blk) for _ in
                    range(world.axis_size(axes))] if world.rank == 0 \
                else None
            dist.gather(blk, bufs, dst=0, group=world.group(axes))
            if world.rank != 0:
                continue
            whole = blk.new_empty(tuple(
                n * math.prod(sizes[a] for a in _axes(e)) for n, e in
                itertools.zip_longest(blk.shape, sh.spec)))
            for j, b in enumerate(bufs):     # the line's ranks, row-major
                at = dict.fromkeys(world.axis_names, 0)
                for a in reversed(axes):
                    at[a], j = j % sizes[a], j // sizes[a]
                sh.block(whole, at).copy_(b)
            del bufs
            out.append(whole)
    return out if world.rank == 0 else None


def _to_host(leaf) -> Tuple[np.ndarray, str]:
    """(numpy array to write, dtype name for the manifest); the copy is
    complete when this returns."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        name = str(t.dtype).replace("torch.", "")
        return t.numpy(), name
    a = np.array(leaf, copy=True)
    return a, str(a.dtype)


class CheckpointManager:
    """``keep`` bounds how many steps survive garbage collection; ``None``
    disables it (content stores like the factor cache keep every entry)."""

    def __init__(self, directory: str, keep: Optional[int] = 3):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._world = None       # set by a save over a world of ranks

    # ------------------------------------------------------------- save

    def _snapshot(self, tree: Any, shardings: Any):
        """(host leaves to write, or None on a rank that writes nothing;
        the structure): on a mesh of ranks each leaf gathered whole."""
        leaves, structure = tree_flatten(tree)
        places = _placements(tree, shardings) if shardings is not None \
            else [None] * len(leaves)
        world = _world(places)
        if world is not None:
            self._world = world
            leaves = _gathered(leaves, places, world)
            if leaves is None:
                return None, structure
        return [_to_host(l) for l in leaves], structure

    def save(self, step: int, tree: Any, shardings: Any = None) -> str:
        host, structure = self._snapshot(tree, shardings)
        path = self.step_dir(step) if host is None else \
            self._write(step, host, structure)
        if self._world is not None:
            self._world.barrier()
        return path

    def save_async(self, step: int, tree: Any, shardings: Any = None
                   ) -> None:
        self.wait()
        # device → host snapshot now
        host, structure = self._snapshot(tree, shardings)
        if host is None:
            return

        def work():
            self._write(step, host, structure)

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._world is not None:
            self._world.barrier()

    def step_dir(self, step: int) -> str:
        """Directory a step lives in (exists only once saved)."""
        return os.path.join(self.directory, f"step_{step:012d}")

    def _write(self, step: int, host_leaves, structure) -> str:
        final = self.step_dir(step)
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        manifest = {"step": step, "treedef": str(structure), "leaves": []}
        for i, (arr, dtype) in enumerate(host_leaves):
            path = os.path.join(tmp, f"leaf_{i:06d}.npy")
            np.save(path, arr)
            with open(path, "rb") as f:
                digest = hashlib.sha256(f.read()).hexdigest()
            manifest["leaves"].append(
                {"i": i, "shape": list(arr.shape), "dtype": dtype,
                 "sha256": digest})
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
        self._gc()
        return final

    def _gc(self):
        if self.keep is None:
            return
        for s in self.all_steps()[:-self.keep]:
            shutil.rmtree(self.step_dir(s), ignore_errors=True)

    # ------------------------------------------------------------- load

    def all_steps(self):
        out = []
        for name in os.listdir(self.directory):
            if name.startswith("step_") and not name.endswith(".tmp"):
                try:
                    out.append(int(name[5:]))
                except ValueError:
                    pass
        return sorted(out)

    def _verify(self, path: str) -> Optional[dict]:
        mpath = os.path.join(path, "manifest.json")
        if not os.path.exists(mpath):
            return None
        with open(mpath) as f:
            manifest = json.load(f)
        for leaf in manifest["leaves"]:
            lp = os.path.join(path, f"leaf_{leaf['i']:06d}.npy")
            if not os.path.exists(lp):
                return None
            with open(lp, "rb") as fh:
                if hashlib.sha256(fh.read()).hexdigest() != leaf["sha256"]:
                    return None
        return manifest

    def restore(self, step: int, like: Any, device=None,
                shardings: Any = None) -> Any:
        """Restore into the structure of ``like``, every leaf a tensor on
        ``device`` (``None``: the CUDA device) or on its placement in
        ``shardings`` (``ValueError`` where the spec does not fit the
        leaf); on a mesh over a world of ranks, this rank's block of it."""
        dev = resolve_device(device)
        path = self.step_dir(step)
        manifest = self._verify(path)
        if manifest is None:
            raise IOError(f"checkpoint at {path} is missing or corrupt")
        leaves, structure = tree_flatten(like)
        places = _placements(like, shardings)
        out = []
        for i, meta in zip(range(len(leaves)), manifest["leaves"]):
            arr = np.load(os.path.join(path, f"leaf_{i:06d}.npy"))
            if meta["dtype"] == "bfloat16":
                t = torch.from_numpy(arr.view(np.int16).copy()).view(
                    torch.bfloat16)
            else:
                t = torch.from_numpy(arr.astype(np.dtype(meta["dtype"]),
                                                copy=False))
            sh = places[i]
            t = t.reshape(meta["shape"])
            if sh is not None:
                sh.shard_shape(meta["shape"])     # the spec fits the leaf
                if sh.mesh.world is not None:
                    t = sh.local(t).clone()
            out.append(t.to(dev if sh is None else sh.device))
        if len(out) != len(leaves):
            raise IOError(f"checkpoint at {path} holds {len(out)} leaves; "
                          f"the structure asks for {len(leaves)}")
        return tree_unflatten(structure, out)

    def restore_latest(self, like: Any, device=None, shardings: Any = None):
        """Newest *valid* checkpoint (skips torn writes): ``(step, tree)``,
        or ``(None, None)`` when nothing restorable exists."""
        for step in reversed(self.all_steps()):
            if self._verify(self.step_dir(step)) is not None:
                return step, self.restore(step, like, device, shardings)
        return None, None
