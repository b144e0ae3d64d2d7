"""Roofline-guided autotuner for the CV sweep
(``src/repro/distributed/autotune.py``), with zero candidate executions.

1. **Enumerate** the legal lattice for a problem geometry (h, k, q,
   dtype / precision, devices): kernel and packing block × λ chunk (the
   ``'auto'`` chunk and a power-of-two ladder around it) × the mesh shapes
   whose fold axis divides k (:func:`~.sharding.mesh_shape_candidates`).
2. **Price** each candidate's sweep from the launch plan the engine would
   run (:func:`~.plan_cost.engine_cost`) — the reference compiles each
   candidate ahead of time and walks its HLO; the port has no HLO, and
   runs nothing either.
3. **Score** it against the roofline (:func:`~.roofline.roofline`) of the
   detected :class:`~.roofline.HW`: ``max(compute, memory, collective) +
   launches · launch_s``, per device.
4. **Choose** the predicted-fastest :class:`TunedConfig`.  The engine's
   default configuration is always the first candidate and wins ties
   (strict ``<``): tuning can refine the default's prediction, never
   regress it.

Repeat tuning is free through the content-addressed :class:`TuningCache`,
persisted through the checkpoint manager.  Its ``lowerings`` counter keeps
the reference's name and counts priced plans.

Differences by design: :data:`DEFAULT_BLOCKS` is ``(32, 64, 128)``, not
the reference's MXU widths ``(128, 256, 512)``, and the lattice of a
``cuda`` backend keeps only the blocks its kernels are compiled for
(:data:`repro_torch.kernels._build.BLOCKS`), so a tuned block never
reaches the kernels' block refusal.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import math
import os
import shutil
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..checkpoint.manager import CheckpointManager
from . import plan_cost
from . import roofline as rl
from . import sharding as shardlib

__all__ = ["TunedConfig", "TuningCache", "fingerprint", "device_fingerprint",
           "chunk_ladder", "candidate_lattice", "score_candidates",
           "default_config", "tune", "DEFAULT_BLOCKS"]

#: The block lattice on real problems: the card's kernel tiles.  Blocks
#: wider than the problem (block ≥ 2h) are pruned as in the reference.
DEFAULT_BLOCKS = (32, 64, 128)

INDEX_FILENAME = "tuning_index.json"


@dataclasses.dataclass(frozen=True)
class TunedConfig:
    """One point of the lattice (and the tuner's verdict).

    ``mesh_shape`` is ``(n_fold, n_lam)`` or ``None`` (one device);
    ``predicted_s`` the priced step; ``source`` ``'tuned'`` (a fresh
    search), ``'cache'`` (a tuning-cache hit), ``'default'`` (the engine's
    untuned configuration) or ``'candidate'``.
    """

    block: int
    lam_chunk: int
    mesh_shape: Optional[Tuple[int, int]] = None
    predicted_s: float = float("nan")
    source: str = "candidate"

    def key(self) -> tuple:
        return (self.block, self.lam_chunk, self.mesh_shape)

    def to_json(self) -> dict:
        return {"block": self.block, "lam_chunk": self.lam_chunk,
                "mesh_shape": (None if self.mesh_shape is None
                               else list(self.mesh_shape)),
                "predicted_s": self.predicted_s, "source": self.source}

    @classmethod
    def from_json(cls, d: dict) -> "TunedConfig":
        ms = d.get("mesh_shape")
        return cls(block=int(d["block"]), lam_chunk=int(d["lam_chunk"]),
                   mesh_shape=None if ms is None else tuple(int(x) for x in ms),
                   predicted_s=float(d.get("predicted_s", float("nan"))),
                   source=str(d.get("source", "candidate")))


def device_fingerprint() -> dict:
    """What makes a verdict machine-specific: platform, device name and how
    many devices the mesh lattice can factor over."""
    if torch.cuda.is_available():
        return {"platform": "gpu",
                "device_kind": torch.cuda.get_device_name(0),
                "n_devices": torch.cuda.device_count()}
    return {"platform": "cpu", "device_kind": "cpu", "n_devices": 1}


def _dtype_name(d) -> str:
    return str(d).replace("torch.", "")


def fingerprint(*, h: int, k: int, n_f: int, q: int, dtype: str,
                lam_dtype: str, params: dict, backend: str, precision: str,
                lattice: dict, hw_name: str,
                devices: Optional[dict] = None) -> str:
    """Content digest of everything a verdict depends on: geometry, dtypes,
    strategy parameters, backend, precision, devices, the lattice and the
    HW preset.  The payload is the reference's ``tuning_key/v1`` (dtypes
    by their bare names), so the digest equals the JAX package's for the
    same inputs."""
    payload = {
        "schema": "tuning_key/v1",
        "h": int(h), "k": int(k), "n_f": int(n_f), "q": int(q),
        "dtype": _dtype_name(dtype), "lam_dtype": _dtype_name(lam_dtype),
        "params": {str(a): repr(b) for a, b in sorted(params.items())},
        "backend": str(backend), "precision": str(precision),
        "lattice": {str(a): repr(b) for a, b in sorted(lattice.items())},
        "hw": str(hw_name),
        "devices": devices or device_fingerprint(),
    }
    blob = json.dumps(payload, sort_keys=True).encode()
    return hashlib.sha256(blob).hexdigest()


class TuningCache:
    """Content-addressed store of verdicts (digest → config).

    ``lowerings`` counts priced candidate plans, so a second :func:`tune`
    of a geometry must be a ``hit`` that leaves it unchanged.  :meth:`save`
    writes the table as one checkpoint step (a uint8 JSON blob) plus an
    index file flipped last with ``os.replace``, and prunes older steps
    after the flip."""

    def __init__(self):
        self.configs: dict = {}    # digest -> TunedConfig
        self.hits = 0
        self.misses = 0
        self.lowerings = 0         # candidate plans priced

    def __len__(self) -> int:
        return len(self.configs)

    def get(self, digest: str) -> Optional[TunedConfig]:
        cfg = self.configs.get(digest)
        if cfg is None:
            self.misses += 1
            return None
        self.hits += 1
        return cfg

    def put(self, digest: str, config: TunedConfig) -> TunedConfig:
        self.configs[digest] = config
        return config

    @property
    def stats(self) -> dict:
        return dict(entries=len(self.configs), hits=self.hits,
                    misses=self.misses, lowerings=self.lowerings)

    def save(self, directory: str) -> str:
        mgr = CheckpointManager(directory, keep=None)
        step = max(mgr.all_steps(), default=-1) + 1
        blob = json.dumps({d: c.to_json()
                           for d, c in sorted(self.configs.items())},
                          sort_keys=True).encode()
        arr = np.frombuffer(blob, dtype=np.uint8).copy()
        mgr.save(step, [arr])
        index = {"schema": "tuning_cache/v1", "step": step,
                 "nbytes": int(arr.size)}
        path = os.path.join(directory, INDEX_FILENAME)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(index, f, indent=1)
        os.replace(tmp, path)                      # atomic flip
        for s in mgr.all_steps():                  # prune superseded steps
            if s != step:
                shutil.rmtree(mgr.step_dir(s), ignore_errors=True)
        return path

    @classmethod
    def load(cls, directory: str) -> "TuningCache":
        cache = cls()
        path = os.path.join(directory, INDEX_FILENAME)
        if not os.path.exists(path):
            return cache
        with open(path) as f:
            index = json.load(f)
        if index.get("schema") != "tuning_cache/v1":
            return cache
        mgr = CheckpointManager(directory, keep=None)
        like = [np.zeros(int(index["nbytes"]), dtype=np.uint8)]
        try:
            (arr,) = mgr.restore(int(index["step"]), like, device="cpu")
        except IOError:
            return cache          # torn step: an empty cache, re-tune
        table = json.loads(arr.numpy().astype(np.uint8).tobytes().decode())
        for digest, d in table.items():
            cache.configs[digest] = TunedConfig.from_json(d)
        return cache


def _pow2_near(x: float, lo: int, hi: int) -> int:
    """The power of two nearest ``x`` (log scale), clipped to [lo, hi]."""
    x = max(float(x), 1.0)
    p = 2 ** int(round(math.log2(x)))
    return max(lo, min(hi, p))


def chunk_ladder(auto: int, q: int) -> Tuple[int, ...]:
    """λ-chunk candidates: the ``'auto'`` chunk and powers of two near
    ×¼, ×½, ×2, ×4 of it, clipped to [1, q] and deduplicated."""
    auto = max(1, min(int(auto), q))
    out = {auto}
    for mult in (0.25, 0.5, 2.0, 4.0):
        out.add(_pow2_near(auto * mult, 1, q))
    return tuple(sorted(out))


def candidate_lattice(*, h: int, k: int, q: int, n_devices: int,
                      default: TunedConfig,
                      blocks: Optional[Sequence[int]] = None,
                      chunks: Optional[Sequence[int]] = None,
                      mesh_shapes: Optional[Sequence] = None,
                      store_dtype=None,
                      budget: Optional[int] = None) -> List[TunedConfig]:
    """The legal lattice for one geometry, ``default`` first.  Blocks of
    ``2h`` and wider are pruned (one padded tile either way); each block's
    chunk ladder follows its own packed bytes."""
    blocks = tuple(blocks) if blocks is not None else DEFAULT_BLOCKS
    blocks = tuple(dict.fromkeys(
        b for b in blocks if b == default.block or b < 2 * h or b <= h))
    if default.block not in blocks:
        blocks = (default.block,) + blocks
    if mesh_shapes is None:
        mesh_shapes = ([None] if n_devices <= 1 else
                       [None] + [tuple(s) for s in
                                 shardlib.mesh_shape_candidates(k, n_devices)
                                 if s != (1, 1)])
    else:
        mesh_shapes = [None if s is None else tuple(s) for s in mesh_shapes]
    if default.mesh_shape not in mesh_shapes:
        mesh_shapes = [default.mesh_shape] + list(mesh_shapes)

    cands = [default]
    seen = {default.key()}
    for mesh_shape in mesh_shapes:
        n_lam = 1 if mesh_shape is None else mesh_shape[1]
        q_loc = max(1, math.ceil(q / n_lam))
        for block in blocks:
            if chunks is not None:
                ladder = tuple(max(1, min(int(c), q_loc)) for c in chunks)
            elif store_dtype is not None and budget is not None:
                auto = shardlib.auto_lam_chunk(h, block, store_dtype, budget)
                ladder = chunk_ladder(auto, q_loc)
            else:
                ladder = chunk_ladder(default.lam_chunk, q_loc)
            for chunk in dict.fromkeys(ladder):
                cand = TunedConfig(block=block, lam_chunk=chunk,
                                   mesh_shape=mesh_shape)
                if cand.key() not in seen:
                    seen.add(cand.key())
                    cands.append(cand)
    return cands


def _geometry(folds, lams) -> tuple:
    k, n_f, h = folds.x_folds.shape
    return k, n_f, h, int(lams.shape[0]), folds.fold_hess.dtype


def score_candidates(engine, folds, lams, candidates: Sequence[TunedConfig],
                     *, hw: Optional[rl.HW] = None,
                     cache: Optional[TuningCache] = None,
                     devices: Optional[Sequence] = None
                     ) -> List[TunedConfig]:
    """Each candidate with its priced ``predicted_s`` (order kept); prices
    plans only, executes nothing.  ``cache`` only counts the plans."""
    k, _, h, q, dtype = _geometry(folds, lams)
    hw = hw or rl.detect_hw(dtype, engine._prec)
    out = []
    for cand in candidates:
        derived = engine._apply_tuned(cand, devices=devices)
        cost, chips = plan_cost.engine_cost(derived, k, h, q, dtype)
        if cache is not None:
            cache.lowerings += 1
        roof = rl.roofline(cost, chips, hw=hw)
        out.append(dataclasses.replace(cand, predicted_s=roof.step_s))
    return out


def default_config(engine, k: int, h: int, q: int, dtype) -> TunedConfig:
    """The engine's untuned configuration as a lattice point: its block,
    its resolved λ chunk (the whole grid when streaming is off) and the
    mesh it would build."""
    block = getattr(engine.strategy, "block", None) or engine.block or 128
    chunk = engine._resolve_chunk(h, plan_cost._dtype(dtype))
    chunk = q if chunk is None else min(chunk, q)
    mesh = engine._resolve_mesh(k)
    mesh_shape = (None if mesh is None else
                  (mesh.shape[shardlib.CV_FOLD_AXIS],
                   mesh.shape[shardlib.CV_LAM_AXIS]))
    return TunedConfig(block=block, lam_chunk=chunk, mesh_shape=mesh_shape,
                       source="default")


def tune(engine, folds, lams, *, cache: Optional[TuningCache] = None,
         blocks: Optional[Sequence[int]] = None,
         chunks: Optional[Sequence[int]] = None,
         mesh_shapes: Optional[Sequence] = None,
         hw: Optional[rl.HW] = None,
         devices: Optional[Sequence] = None) -> TunedConfig:
    """The predicted-fastest configuration of ``engine`` on this geometry
    (``source`` ``'cache'`` on a tuning-cache hit, which prices nothing,
    else ``'tuned'``).  ``devices`` are the devices the lattice's meshes
    may span (default: the engine's, :meth:`CVEngine._device_pool`)."""
    lams = torch.as_tensor(lams)
    k, n_f, h, q, dtype = _geometry(folds, lams)
    hw = hw or rl.detect_hw(dtype, engine._prec)
    pool = engine._device_pool() if devices is None else list(devices)

    default = default_config(engine, k, h, q, dtype)
    lattice_desc = dict(
        blocks=tuple(blocks) if blocks else DEFAULT_BLOCKS,
        chunks=tuple(chunks) if chunks else "auto-ladder",
        mesh_shapes=(tuple("none" if s is None else tuple(s)
                           for s in mesh_shapes)
                     if mesh_shapes is not None else "factorizations"),
        default=default.key())
    meta = engine.strategy.cache_meta(lams)
    params = dict(meta["params"]) if meta else {}
    params.pop("block", None)                     # block is what we tune
    params.setdefault("strategy", engine.strategy.name)

    digest = fingerprint(
        h=h, k=k, n_f=n_f, q=q, dtype=dtype, lam_dtype=lams.dtype,
        params=params, backend=engine._bk.name,
        precision=engine._prec.descriptor(), lattice=lattice_desc,
        hw_name=hw.name)
    if cache is not None:
        hit = cache.get(digest)
        if hit is not None:
            return dataclasses.replace(hit, source="cache")

    if engine._bk.name == "cuda":
        from ..kernels import _build
        blocks = tuple(b for b in (blocks or DEFAULT_BLOCKS)
                       if b in _build.BLOCKS)
    from ..core.engine import LAM_CHUNK_BUDGET_BYTES
    cands = candidate_lattice(
        h=h, k=k, q=q, n_devices=len(pool), default=default,
        blocks=blocks, chunks=chunks, mesh_shapes=mesh_shapes,
        store_dtype=engine._prec.store_dtype(dtype),
        budget=LAM_CHUNK_BUDGET_BYTES)
    scored = score_candidates(engine, folds, lams, cands, hw=hw, cache=cache,
                              devices=pool)
    # strict < over a default-first list: ties go to the default
    best = scored[0]
    for cand in scored[1:]:
        if cand.predicted_s < best.predicted_s:
            best = cand
    chosen = dataclasses.replace(best, source="tuned")
    if cache is not None:
        cache.put(digest, chosen)
    return chosen
