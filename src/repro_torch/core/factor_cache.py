"""Warm-replay factor cache (``src/repro/core/factor_cache.py``): reuse
fitted Θ and packed anchors across sweeps.

Θ has shape (r+1, P) and does not depend on the grid size q, so once the
anchors are factored it answers any later grid over the same anchor range
with no factorization.  :class:`FactorCache` is a content-addressed store
of per-fold fitted states (and optionally the per-(fold, λ_s) packed
anchor factors), consumed by :class:`~repro_torch.core.engine.CVEngine`
through ``cache=`` / ``reuse=``.  On a hit the engine skips ``fold_state``
and replays the sweep through the fused ``interp_solve`` chunk stream.

Keying — a :class:`CacheKey` is a content fingerprint:

* ``fold_hashes``  sha256 of each fold's training Hessian (shape, dtype,
                   bytes), taken on the host;
* ``anchors``      the anchor-λ grid the fit factorized at;
* ``h, block``     packed-layout geometry; ``dtype`` of the Hessians;
* ``backend``      name of the backend that produced the factors (a
                   ``cuda`` entry never serves a ``reference`` request);
* ``params``       the strategy's static fit parameters;
* ``precision``    the policy descriptor the state was fitted and stored
                   under;
* ``sketch``       how the anchor factors were produced (``'exact'``, a
                   sketch plan's descriptor, or a low-rank descriptor).

The key hashes the same bytes and strings as the reference's (a torch
dtype is named as numpy names it; a bf16 tensor is hashed as its raw
16-bit view under ``bfloat16``), so :meth:`CacheKey.digest` on the
``reference`` backend equals the JAX package's for the same inputs.

Three digests serve three lookups: :meth:`CacheKey.digest` (exact hit),
:meth:`CacheKey.base_digest` (everything but the anchor grid: the
``'covering'`` policy) and :meth:`CacheKey.anchor_digest` (what the anchor
factors depend on: a Θ miss with an anchor hit refits without factorizing).

Persistence goes through :class:`~repro_torch.checkpoint.CheckpointManager`
(one step per entry plus an ``index.json`` sidecar); ``max_bytes`` bounds
residency by a byte-budget LRU whose evictions purge every lookup index.
"""
from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import json
import os
import shutil
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..checkpoint import CheckpointManager, tree_leaves
from . import packing, picholesky, solvers

__all__ = ["CacheKey", "CacheEntry", "FactorCache", "array_hash",
           "hessian_fingerprint", "make_key", "dtype_name", "INDEX_FILENAME",
           "COVER_RTOL"]


INDEX_FILENAME = "index.json"

#: relative slack when testing whether a cached anchor range covers a
#: requested one under ``'covering'``: the float noise of recomputing grid
#: endpoints, not a semantic tolerance
COVER_RTOL = 1e-12


def dtype_name(dtype) -> str:
    """A dtype's name as numpy prints it (``float64``, ``bfloat16``)."""
    return str(dtype).replace("torch.", "")


def _host_array(arr) -> np.ndarray:
    """``arr`` on the host as a C-contiguous numpy array; a bf16 tensor as
    its raw 16-bit view."""
    if isinstance(arr, torch.Tensor):
        t = arr.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return np.ascontiguousarray(t.numpy())
    return np.ascontiguousarray(np.asarray(arr))


def array_hash(arr) -> str:
    """sha256 of an array's shape + dtype name + raw bytes (host copy)."""
    a = _host_array(arr)
    name = dtype_name(arr.dtype) if isinstance(arr, torch.Tensor) \
        else str(a.dtype)
    h = hashlib.sha256()
    h.update(str(a.shape).encode())
    h.update(name.encode())
    h.update(a.tobytes())
    return h.hexdigest()


def hessian_fingerprint(h_tr) -> Tuple[str, ...]:
    """Per-fold content hash of the (k, h, h) training-Hessian stack (one
    device-to-host copy of the stack)."""
    if h_tr.ndim != 3:
        raise ValueError(f"expected (k, h, h) fold Hessians, got "
                         f"{tuple(h_tr.shape)}")
    if isinstance(h_tr, torch.Tensor):
        host = h_tr.detach().cpu()
        return tuple(array_hash(f) for f in host)
    return tuple(array_hash(f) for f in np.asarray(h_tr))


def _digest(payload: dict) -> str:
    return hashlib.sha256(
        json.dumps(payload, sort_keys=True).encode()).hexdigest()


@dataclasses.dataclass(frozen=True)
class CacheKey:
    """Content fingerprint of one fitted fold × anchor state."""

    fold_hashes: Tuple[str, ...]
    anchors: Tuple[float, ...]
    h: int
    block: int
    dtype: str
    backend: str
    params: Tuple[Tuple[str, Any], ...]
    precision: str = "native"
    #: anchor production: ``'exact'``, ``SketchPlan.descriptor()`` or
    #: ``'lowrank/r…'``; a field of its own so that :meth:`anchor_digest`
    #: (which drops ``params``) still separates sketched from exact factors
    sketch: str = "exact"

    def _payload(self) -> dict:
        return dict(fold_hashes=list(self.fold_hashes),
                    anchors=list(self.anchors), h=self.h, block=self.block,
                    dtype=self.dtype, backend=self.backend,
                    params=[list(p) for p in self.params],
                    precision=self.precision, sketch=self.sketch)

    def digest(self) -> str:
        return _digest(self._payload())

    def base_digest(self) -> str:
        p = self._payload()
        del p["anchors"]
        return _digest(p)

    def anchor_digest(self) -> str:
        """What the anchor factors chol(H_f + λ_s I) depend on — not the
        polynomial's degree or basis."""
        p = self._payload()
        del p["params"]
        return _digest(p)

    def to_json(self) -> dict:
        return self._payload()

    @classmethod
    def from_json(cls, rec: dict) -> "CacheKey":
        return cls(fold_hashes=tuple(rec["fold_hashes"]),
                   anchors=tuple(float(a) for a in rec["anchors"]),
                   h=int(rec["h"]), block=int(rec["block"]),
                   dtype=str(rec["dtype"]), backend=str(rec["backend"]),
                   params=tuple((str(k), v) for k, v in rec["params"]),
                   precision=str(rec.get("precision", "native")),
                   sketch=str(rec.get("sketch", "exact")))


def _anchor_values(anchors) -> Tuple[float, ...]:
    if isinstance(anchors, torch.Tensor):
        anchors = anchors.detach().cpu().numpy()
    return tuple(float(a) for a in np.asarray(anchors).ravel())


def make_key(h_tr, anchors, *, block: int, backend: str,
             params: Dict[str, Any], precision: str = "native",
             sketch: str = "exact") -> CacheKey:
    """Fingerprint a sweep's λ-independent inputs: ``h_tr`` (k, h, h)
    training Hessians (hashed on the host), the anchor grid, the static fit
    ``params``, the policy descriptor and the anchor-production
    descriptor."""
    return CacheKey(
        fold_hashes=hessian_fingerprint(h_tr),
        anchors=_anchor_values(anchors),
        h=int(h_tr.shape[-1]), block=int(block),
        dtype=dtype_name(h_tr.dtype), backend=str(backend),
        params=tuple(sorted(params.items())),
        precision=str(precision), sketch=str(sketch))


def _leaf_nbytes(leaf) -> int:
    if isinstance(leaf, torch.Tensor):
        return leaf.numel() * leaf.element_size()
    return int(np.asarray(leaf).nbytes)


def _tree_nbytes(tree) -> int:
    """Bytes of every array leaf at its actual dtype (a bf16 state counts
    its bf16 bytes)."""
    return sum(_leaf_nbytes(l) for l in tree_leaves(tree))


def _tree_nbytes_at(tree, dtype: str) -> int:
    """What the leaves would weigh with every float leaf at ``dtype`` (the
    training Hessians' dtype): the baseline of ``bytes_saved``."""
    item = np.dtype(dtype).itemsize
    total = 0
    for leaf in tree_leaves(tree):
        if isinstance(leaf, torch.Tensor) and leaf.is_floating_point():
            total += leaf.numel() * item
        else:
            total += _leaf_nbytes(leaf)
    return total


@dataclasses.dataclass
class CacheEntry:
    """One cached fit: the batched-over-folds state (a
    :class:`~repro_torch.core.picholesky.PiCholesky` or, for low rank, a
    :class:`~repro_torch.core.solvers.LowRankFactors`), and optionally the
    packed anchor factors (vec (k, g, P)) that produced it.  ``state=None``
    marks an anchors-only entry, served by :meth:`FactorCache.get_anchors`
    only."""

    key: CacheKey
    state: Optional[Any]
    anchors: Optional[packing.PackedFactor] = None
    hits: int = 0
    nbytes: int = 0
    bytes_saved: int = 0
    last_used: int = 0


class FactorCache:
    """In-memory, content-addressed store of fitted interpolant states.

    ``lookup`` policies: ``'exact'`` (the full digest must match) and
    ``'covering'`` (also any entry of the same base digest whose anchor
    range covers the requested one; the tightest such range wins).
    ``max_bytes`` bounds the resident payload by LRU eviction (the entry
    being written always survives).  Counters are cumulative; per-tenant
    partitions come from :meth:`tenant_scope`.
    """

    def __init__(self, max_bytes: Optional[int] = None):
        if max_bytes is not None and max_bytes <= 0:
            raise ValueError(f"max_bytes must be positive or None, "
                             f"got {max_bytes}")
        self.max_bytes = max_bytes
        self.entries: Dict[str, CacheEntry] = {}
        self._by_base: Dict[str, List[str]] = {}
        self._by_anchor: Dict[str, str] = {}
        self.hits = 0
        self.misses = 0
        self.anchor_hits = 0
        self.evictions = 0
        self.bytes_saved = 0
        self.tenant_stats: Dict[str, Dict[str, int]] = {}
        self._tenant: Optional[str] = None
        self._tick = 0

    def __len__(self) -> int:
        return len(self.entries)

    @property
    def total_bytes(self) -> int:
        return sum(e.nbytes for e in self.entries.values())

    @property
    def live_bytes_saved(self) -> int:
        return sum(e.bytes_saved for e in self.entries.values())

    @property
    def stats(self) -> dict:
        return dict(entries=len(self.entries), hits=self.hits,
                    misses=self.misses, anchor_hits=self.anchor_hits,
                    evictions=self.evictions, bytes=self.total_bytes,
                    bytes_saved=self.bytes_saved,
                    live_bytes_saved=self.live_bytes_saved,
                    max_bytes=self.max_bytes)

    # ------------------------------------------------- per-tenant counters

    @contextlib.contextmanager
    def tenant_scope(self, tenant: Optional[str]):
        """Attribute every cache operation inside the scope to ``tenant``
        (scopes nest; the innermost wins)."""
        prev, self._tenant = self._tenant, tenant
        try:
            yield self
        finally:
            self._tenant = prev

    def _tenant_count(self, field: str, amount: int = 1) -> None:
        if self._tenant is None:
            return
        rec = self.tenant_stats.setdefault(
            self._tenant, dict(hits=0, misses=0, anchor_hits=0, puts=0))
        rec[field] += amount

    def hit_rate(self, tenant: Optional[str] = None) -> float:
        """hits / (hits + misses), overall or for one tenant."""
        if tenant is None:
            hits, misses = self.hits, self.misses
        else:
            rec = self.tenant_stats.get(tenant, dict(hits=0, misses=0))
            hits, misses = rec["hits"], rec["misses"]
        total = hits + misses
        return hits / total if total else 0.0

    def _touch(self, entry: CacheEntry) -> None:
        self._tick += 1
        entry.last_used = self._tick

    # ---------------------------------------------------------------- read

    def lookup(self, key: CacheKey, policy: str = "exact"
               ) -> Optional[CacheEntry]:
        if policy not in ("exact", "covering"):
            raise ValueError(f"unknown reuse policy {policy!r}; "
                             "expected 'exact' or 'covering'")
        entry = self.entries.get(key.digest())
        if entry is not None and entry.state is None:
            entry = None        # anchors-only entry: no Θ to serve
        if entry is None and policy == "covering" and key.anchors:
            lo, hi = min(key.anchors), max(key.anchors)
            best_width = None
            for digest in self._by_base.get(key.base_digest(), ()):
                cand = self.entries[digest]
                if cand.state is None:
                    continue
                c_lo, c_hi = min(cand.key.anchors), max(cand.key.anchors)
                if (c_lo <= lo + abs(lo) * COVER_RTOL
                        and hi <= c_hi + abs(c_hi) * COVER_RTOL):
                    width = c_hi - c_lo
                    if best_width is None or width < best_width:
                        best_width, entry = width, cand
        if entry is None:
            self.misses += 1
            self._tenant_count("misses")
            return None
        self.hits += 1
        self._tenant_count("hits")
        entry.hits += 1
        self._touch(entry)
        return entry

    def get_anchors(self, key: CacheKey) -> Optional[packing.PackedFactor]:
        """Cached packed anchor factors for ``key``'s anchor fingerprint, or
        None.  Counts as an anchor hit."""
        digest = self._by_anchor.get(key.anchor_digest())
        if digest is None:
            return None
        entry = self.entries[digest]
        if entry.anchors is not None:
            self.anchor_hits += 1
            self._tenant_count("anchor_hits")
            self._touch(entry)
        return entry.anchors

    # --------------------------------------------------------------- write

    def put(self, key: CacheKey, state, anchors: Optional[
            packing.PackedFactor] = None) -> CacheEntry:
        """Write one entry (``state=None`` with ``anchors``: anchors
        only)."""
        if state is None and anchors is None:
            raise ValueError("refusing to cache an empty entry: "
                             "need a fitted state, packed anchors, or both")
        digest = key.digest()
        nbytes = _tree_nbytes((state, anchors))
        baseline = _tree_nbytes_at((state, anchors), key.dtype)
        entry = CacheEntry(key=key, state=state, anchors=anchors,
                           nbytes=nbytes,
                           bytes_saved=max(0, baseline - nbytes))
        self.bytes_saved += entry.bytes_saved
        self._tenant_count("puts")
        if digest not in self.entries:
            self._by_base.setdefault(key.base_digest(), []).append(digest)
        self.entries[digest] = entry
        if anchors is not None:
            self._by_anchor[key.anchor_digest()] = digest
        self._touch(entry)
        self._evict_to_budget(keep=digest)
        return entry

    # ------------------------------------------------------ byte-budget LRU

    def _evict(self, digest: str) -> None:
        """Drop one entry and purge every index that could serve it."""
        entry = self.entries.pop(digest)
        base = entry.key.base_digest()
        siblings = self._by_base.get(base)
        if siblings is not None:
            siblings[:] = [d for d in siblings if d != digest]
            if not siblings:
                del self._by_base[base]
        anchor = entry.key.anchor_digest()
        if self._by_anchor.get(anchor) == digest:
            del self._by_anchor[anchor]
        self.evictions += 1

    def _evict_to_budget(self, keep: str) -> None:
        if self.max_bytes is None:
            return
        while self.total_bytes > self.max_bytes and len(self.entries) > 1:
            victim = min((d for d in self.entries if d != keep),
                         key=lambda d: self.entries[d].last_used)
            self._evict(victim)

    # --------------------------------------------------- persistence (disk)

    @staticmethod
    def _leaf_spec(t: torch.Tensor) -> dict:
        return dict(shape=list(t.shape), dtype=dtype_name(t.dtype))

    @staticmethod
    def _leaf_like(spec: dict) -> torch.Tensor:
        from .precision import as_dtype
        return torch.zeros(tuple(spec["shape"]), dtype=as_dtype(spec["dtype"]))

    def save(self, directory: str) -> str:
        """Persist every entry (one checkpoint step each, never garbage
        collected) plus ``index.json``.  New saves take fresh step numbers,
        the index flips last by ``os.replace``, and only then are steps it
        does not reference pruned."""
        mgr = CheckpointManager(directory, keep=None)
        base = max(mgr.all_steps(), default=-1) + 1
        index = {"schema": "factor_cache/v1", "entries": []}
        for offset, (digest, e) in enumerate(sorted(self.entries.items())):
            step = base + offset
            tree = {}
            if isinstance(e.state, solvers.LowRankFactors):
                tree["vt"], tree["evals"] = e.state.vt, e.state.evals
                srec = {"kind": "low_rank",
                        "vt": self._leaf_spec(e.state.vt),
                        "evals": self._leaf_spec(e.state.evals)}
            elif e.state is not None:
                tree["theta"], tree["center"] = e.state.theta, e.state.center
                srec = {"h": e.state.h, "block": e.state.block,
                        "theta": self._leaf_spec(e.state.theta),
                        "center": self._leaf_spec(e.state.center)}
            else:
                srec = None
            if e.anchors is not None:
                tree["anchors_vec"] = e.anchors.vec
            mgr.save(step, tree)
            index["entries"].append({
                "step": step, "digest": digest, "key": e.key.to_json(),
                "state": srec,
                "anchors": None if e.anchors is None else {
                    "h": e.anchors.h, "block": e.anchors.block,
                    "vec": self._leaf_spec(e.anchors.vec)}})
        path = os.path.join(directory, INDEX_FILENAME)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(index, f, indent=2, sort_keys=True)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        referenced = {rec["step"] for rec in index["entries"]}
        for s in mgr.all_steps():
            if s not in referenced:
                shutil.rmtree(mgr.step_dir(s), ignore_errors=True)
        return path

    @classmethod
    def load(cls, directory: str, max_bytes: Optional[int] = None,
             device=None) -> "FactorCache":
        """Rebuild a cache from :meth:`save` output onto ``device``
        (``None``: the CUDA device).  Entries that fail the manager's hash
        check, or whose index and payload disagree, are skipped; the byte
        budget applies during the load (index order, oldest first)."""
        from .._device import resolve_device
        dev = resolve_device(device)
        cache = cls(max_bytes=max_bytes)
        path = os.path.join(directory, INDEX_FILENAME)
        if not os.path.exists(path):
            return cache
        with open(path) as f:
            index = json.load(f)
        mgr = CheckpointManager(directory, keep=None)
        for rec in index.get("entries", ()):
            key = CacheKey.from_json(rec["key"])
            if key.digest() != rec["digest"]:
                continue
            srec = rec["state"]
            kind = (srec or {}).get("kind", "picholesky")
            like = {}
            if srec is not None and kind == "low_rank":
                like["vt"] = cls._leaf_like(srec["vt"])
                like["evals"] = cls._leaf_like(srec["evals"])
            elif srec is not None:
                like["theta"] = cls._leaf_like(srec["theta"])
                like["center"] = cls._leaf_like(srec["center"])
            arec = rec.get("anchors")
            if arec is not None:
                like["anchors_vec"] = cls._leaf_like(arec["vec"])
            try:
                tree = mgr.restore(rec["step"], like, device=dev)
            except IOError:
                continue
            if any(tree[n].shape != ref.shape or tree[n].dtype != ref.dtype
                   for n, ref in like.items()):
                continue     # index/payload mismatch: drop, never mis-serve
            if srec is None:
                state = None
            elif kind == "low_rank":
                state = solvers.LowRankFactors(vt=tree["vt"],
                                               evals=tree["evals"])
            else:
                state = picholesky.PiCholesky(
                    theta=tree["theta"], center=tree["center"],
                    h=int(srec["h"]), block=int(srec["block"]))
            anchors = None
            if arec is not None:
                anchors = packing.PackedFactor(
                    vec=tree["anchors_vec"], h=int(arec["h"]),
                    block=int(arec["block"]))
            cache.put(key, state, anchors)
        return cache
