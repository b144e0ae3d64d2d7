"""Cost of a CV sweep from its launch plan — the port's counterpart of
``src/repro/distributed/hlo_cost.py``.

The reference prices a candidate configuration by compiling it ahead of
time and walking the optimized HLO, expanding each ``lax.map`` λ-chunk
loop by its trip count.  The port has no HLO.  It prices the plan the
engine would run instead, without running anything.  Each strategy states
its own plan (``launch_plan``, given a :class:`PlanBuilder` that holds the
geometry and prices each kernel call); a strategy with none raises.  The
strategies' plans:

* the state stage — the blocked Cholesky of the anchors (one call of
  ``3·nt − 2`` launches: a diagonal, a panel and a trailing step per tile
  column, the last column without the latter two) and ``pack_tril``;
* the λ stage — ``interp_solve`` once per λ chunk, ⌈q_loc / chunk⌉ trips
  (a refining policy adds one ``interp_solve`` a refinement sweep), or,
  for ``exact``, the Cholesky of the chunk's shifted Hessians and the
  trsm pair per trip.

Each launch gets its FLOPs and bytes from the formulas of ``PERF.md`` §6's
bound column (``chip_smoke.py``'s ``bound_ms``: each input read once, each
output written once), multiplied by its trips.  The work PyTorch does
around the kernels (shifting the Hessians, the Θ fit's small GEMM, the
hold-out scores) is not priced: it is the same for every candidate of a
geometry.  The result keeps :class:`HloCost`'s fields
(``flops``, ``hbm_bytes``, ``wire``, ``unknown_trip_loops``) and adds
``launches`` (what the roofline's launch term multiplies), the kernel
``calls`` per engine stage (what a
:class:`~repro_torch.core.backends.CountingBackend` counts) and
``temp_bytes``, the plan's largest live working set.

On a mesh every number is per device, for the busiest device: fold group
0's ``k / n_fold`` folds on its share of the λ grid, ⌈q / n_lam⌉ λs.
``wire`` holds the bytes the mesh moves: the fold group's inputs to its
device (``scatter``), its fitted state along the λ axis (``broadcast``)
and the errors back to the engine's device (``gather``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Tuple

import torch

from .dtype_bytes import itemsize

__all__ = ["HloCost", "PlanCost", "Launch", "PlanBuilder", "chol_launches",
           "plan_sweep", "price_sweep", "engine_cost", "STEP_KINDS",
           "price_lm_step"]


def chol_launches(h: int, block: int) -> int:
    """CUDA launches of one blocked Cholesky call: ``3·nt − 2``."""
    return 3 * (-(-h // block)) - 2


@dataclasses.dataclass(frozen=True)
class Launch:
    """``calls`` calls of one kernel wrapper in one engine stage, with the
    work of one call."""

    kernel: str          # the backend method: cholesky, pack_tril, ...
    stage: str           # prepare | fold_state | fold_errors
    calls: int
    launches: int        # CUDA launches of one call
    flops: float         # of one call
    bytes: float         # of one call
    state_bytes: float = 0.0   # of the fitted state one call reads


@dataclasses.dataclass
class HloCost:
    """The reference walker's result fields (per device)."""

    flops: float = 0.0
    hbm_bytes: float = 0.0
    wire: Dict[str, float] = dataclasses.field(default_factory=dict)
    unknown_trip_loops: int = 0

    @property
    def wire_bytes(self) -> float:
        return sum(self.wire.values())


@dataclasses.dataclass
class PlanCost(HloCost):
    launches: int = 0
    trips: int = 0
    calls: Dict[str, Dict[str, int]] = dataclasses.field(
        default_factory=dict)
    temp_bytes: float = 0.0
    plan: tuple = ()

    def stage_calls(self, stage: str, kernel: str) -> int:
        return self.calls.get(stage, {}).get(kernel, 0)


def _tri(h: int) -> int:
    return h * (h + 1) // 2


def _packed(h: int, block: int) -> int:
    nt = -(-h // block)
    return nt * (nt + 1) // 2 * block * block


@dataclasses.dataclass(frozen=True)
class PlanBuilder:
    """The geometry of one sweep on the busiest device, and the priced
    :class:`Launch` of each kernel call a strategy's ``launch_plan`` names.

    ``k_loc`` folds and ``q_loc`` λs on the device, ``c`` λs a chunk in
    ``trips`` chunks; ``block`` is the backend's Cholesky tile, ``isz``
    the accumulation dtype's bytes and ``store`` the storage dtype's."""

    h: int
    k: int
    k_loc: int
    q_loc: int
    c: int
    trips: int
    block: int
    isz: int
    store: int
    precision: object

    def cholesky(self, stage, nb, calls=1):
        h = self.h
        return Launch("cholesky", stage, calls, chol_launches(h, self.block),
                      nb * h ** 3 / 3, nb * (_tri(h) + h * h) * self.isz)

    def pack(self, stage, nb, block):
        h = self.h
        return Launch("pack_tril", stage, 1, 1, 0.0,
                      nb * (_tri(h) + _packed(h, block)) * self.isz)

    def trsm_pair(self, stage, nb, calls):
        # the pair's bound (both sweeps) split over its two launches
        h = self.h
        return Launch("solve_lower", stage, 2 * calls, 1, nb * h * h,
                      nb * (_tri(h) + 2 * h) * self.isz / 2)

    def interp(self, stage, block, degree, calls, rhs_per_lam=False):
        """``calls`` trips of ``interp_solve`` over the device's folds at
        the chunk; the Θ it reads is the fitted state the λ axis
        broadcasts."""
        k, c, h = self.k_loc, self.c, self.h
        p = _packed(h, block)
        theta = k * (degree + 1) * p * self.store
        rhs = k * c * h if rhs_per_lam else k * h
        return Launch("interp_solve", stage, calls, 1,
                      k * c * 2.0 * p * (2 * degree + 2),
                      theta + (rhs + k * c * h) * self.isz,
                      state_bytes=theta)


def plan_sweep(strategy, *, h: int, k: int, q: int, dtype, precision,
               block: int, chunk, n_fold: int = 1, n_lam: int = 1):
    """The launches of one sweep of ``strategy`` on the busiest device of
    an ``(n_fold, n_lam)`` mesh, as :class:`Launch` records from the
    strategy's ``launch_plan``, with the device's geometry (a
    :class:`PlanBuilder`).  A strategy without a launch plan (one that
    runs none of the port's kernels: ``svd``, ``low_rank``) raises
    ``ValueError``: it has nothing to tune."""
    plan_of = getattr(strategy, "launch_plan", None)
    if plan_of is None:
        raise ValueError(
            f"strategy {getattr(strategy, 'name', strategy)!r} has no launch "
            "plan, so tune= cannot price it; run it with tune=False")
    q_loc = -(-q // n_lam)
    if chunk is None or chunk >= q_loc:
        c, trips = q_loc, 1
    else:
        c, trips = int(chunk), -(-q_loc // int(chunk))
    geo = PlanBuilder(h=h, k=k, k_loc=k // n_fold, q_loc=q_loc, c=c,
                      trips=trips, block=block,
                      isz=itemsize(precision.accum_dtype(dtype)),
                      store=itemsize(precision.store_dtype(dtype)),
                      precision=precision)
    return list(plan_of(geo)), geo


def price_sweep(strategy, *, h: int, k: int, q: int, dtype, precision,
                block: int, chunk, n_fold: int = 1, n_lam: int = 1
                ) -> PlanCost:
    """The :class:`PlanCost` of one sweep (see the module docstring);
    executes nothing."""
    plan, geo = plan_sweep(strategy, h=h, k=k, q=q, dtype=dtype,
                           precision=precision, block=block, chunk=chunk,
                           n_fold=n_fold, n_lam=n_lam)
    cost = PlanCost(trips=geo.trips, plan=tuple(plan))
    for ln in plan:
        cost.flops += ln.flops * ln.calls
        cost.hbm_bytes += ln.bytes * ln.calls
        cost.launches += ln.launches * ln.calls
        rec = cost.calls.setdefault(ln.stage, {})
        rec[ln.kernel] = rec.get(ln.kernel, 0) + ln.calls
    isz, k_loc, q_loc = geo.isz, geo.k_loc, geo.q_loc
    if n_fold * n_lam > 1:
        if n_fold > 1:
            cost.wire["scatter"] = k_loc * (h * h + h) * isz
        if n_lam > 1:
            cost.wire["broadcast"] = max(
                [ln.state_bytes for ln in plan] or [0.0])
        # the engine's device receives every other device's errors
        cost.wire["gather"] = (n_fold * n_lam - 1) * k_loc * q_loc * isz
    # live working set: the largest of the state stage's (shifted anchors
    # and their factors, the packed targets) and a trip's
    state_set = max([ln.bytes for ln in plan if ln.stage != "fold_errors"]
                    or [0.0])
    trip_set = max([ln.bytes for ln in plan if ln.stage == "fold_errors"]
                   or [0.0])
    cost.temp_bytes = float(max(state_set, trip_set)
                            + k_loc * q_loc * isz)
    return cost


def _dtype(d) -> torch.dtype:
    return d if isinstance(d, torch.dtype) else getattr(torch, str(d))


def engine_cost(engine, k: int, h: int, q: int, dtype):
    """``(PlanCost, chips)`` of ``engine``'s sweep at a geometry: its
    strategy, kernel block, resolved λ chunk and mesh."""
    from . import sharding as shardlib
    mesh = engine._resolve_mesh(k)
    engine._check_fold_axis(mesh, k)
    n_fold = 1 if mesh is None else mesh.shape[shardlib.CV_FOLD_AXIS]
    n_lam = 1 if mesh is None else mesh.shape[shardlib.CV_LAM_AXIS]
    bk = getattr(engine._bk, "inner", engine._bk)      # a counting view
    block = getattr(bk, "chol_block", None) or \
        getattr(engine.strategy, "block", None) or engine.block or 128
    cost = price_sweep(engine.strategy, h=h, k=k, q=q, dtype=_dtype(dtype),
                       precision=engine._prec, block=block,
                       chunk=engine._resolve_chunk(h, _dtype(dtype)),
                       n_fold=n_fold, n_lam=n_lam)
    return cost, n_fold * n_lam



# ------------------------------------------------------------- an LM step
#
# The reference prices an LM step by compiling it for the mesh
# (``src/repro/launch/dryrun.py``, ``roofline(compiled, chips)``).  The
# port prices it from the shapes each device holds under the partition
# (the batch over the data axes, heads, widths, experts and vocabulary
# over ``"model"``, weights over the FSDP axis), the operations the port's
# code runs at those shapes, and the collectives that partition implies.
# The shapes are the dry run's own placements of the parameters, the batch
# and the cache (``launch/specs.py``), and the blocks in order the model's
# own (``models/model.py`` ``block_kinds``), so the price follows the
# layout and the model without a second description of either.  The rule
# it is held to:
#
# * Products follow their formulas exactly: 2·m·k·n per (m, k) × (k, n)
#   product at the local shard shape; attention as the port computes it
#   (``models/layers.py`` ``_FlashCore``: every chunk pair, the causally
#   masked half and the chunk padding too; its recompute backward five
#   products a pair); the MoE's expert products over the (E_loc, C, d)
#   capacity buffers.  The backward runs twice the forward's products
#   (attention: its own five), ``cfg.remat`` runs each group's forward a
#   second time, and the optimizer's passes run over the local parameters.
# * Elementwise work counts one FLOP an element per pass (the reference's
#   convention, ``src/repro/distributed/hlo_cost.py:11``); each operation
#   names its passes below.
# * Bytes: each operation reads its inputs once and writes its outputs
#   once (PyTorch runs the elementwise passes unfused, so each pass reads
#   and writes); weights once a pass; a decode step reads its cache (and
#   copies it: the port's decode keeps the cache it is given).
# * Wire bytes by kind, with the ring formulas of
#   ``src/repro/distributed/roofline.py:150-175``: the all-reduce over
#   ``"model"`` after each row-split product and, in the backward, after
#   each column-split one; the all-gather of k and v where the kv heads
#   are split over ``"model"`` (the reference takes each query head's kv
#   head with a gather, ``blocks.py:104``); under training the residual
#   stream split over the sequence (``Model.forward``'s placement), so an
#   all-gather of each block's input (twice more in the backward) and an
#   all-to-all of the block's elementwise intermediates in the backward;
#   the embedding's all-reduce where the vocabulary is split; the MoE's
#   psum (``blocks.py:305-320``) and, with FSDP, its weights' all-gather;
#   FSDP's all-gather of each weight over the data axis once a pass and
#   the reduce-scatter of its gradient; the gradient all-reduce over the
#   data axes otherwise.  Today the port runs these shards in order on one
#   card (ROADMAP queue 1 item 8): they are priced as the partition would
#   run them.
# * ``temp_bytes`` is the port's own per-device working set beyond the
#   arguments, at its peak: for a training step the gradients, the
#   activations the backward keeps (under remat each group's input and one
#   group's set), the float32 logits and their gradient, the attention
#   chunk buffers, the MoE's capacity buffers and the optimizer's float32
#   temporaries; for a prefill the cache it returns and the largest
#   layer's transients; for a decode step the copy of the cache it returns
#   and the float32 copies of one layer's k and v.
#
# Held against the reference: per-device FLOPs and wire bytes by kind
# within 2× either way of ``roofline(compiled, 4).summary()`` of the same
# reduced cell compiled on a (2, 2) ``("data", "model")`` mesh of 4 CPU
# devices (``tests/test_torch_step_cost.py``); ``temp_bytes`` against the
# card's allocator, from above and from below (``chip_smoke.py`` phase
# ``step_cost``).

STEP_KINDS = ("train", "prefill", "decode")

# elementwise passes an element (one FLOP each)
_NORM_PASSES = 4        # square, mean, rsqrt · x, · scale
_ROPE_PASSES = 6        # two products, two sums, the half swap, the cat
_SCORE_PASSES = 6       # scale, mask, max, subtract, exp, sum
_SILU_PASSES = 5        # sigmoid (3), · x, · gate
_GELU_PASSES = 8        # the tanh form
_SOFTMAX_PASSES = 4     # max, subtract and exp, sum, divide
_CONV_PASSES = 5        # bias, silu (past the taps' 2·K)
_SCAN_PASSES = 8        # exp(dt·A), dt·B·x, a·h + b, C·h  (per (t, c, n))
_MAMBA_GATE_PASSES = 9  # softplus (3), D skip (2), silu(z) (3), · gate
_RGLRU_PASSES = 22      # the gates (2 sigmoids), a, b, the gelu gate
_ADAMW_PASSES = 12      # moments, bias corrections, sqrt, divide, decay
_ADAFACTOR_PASSES = 10
_OPT_TEMPS = 4          # float32 temporaries of the largest leaf


class _Step:
    """FLOPs, bytes and wire bytes of one pass, accumulated op by op."""

    def __init__(self, act: int):
        self.act = act          # the activation dtype's bytes
        self.flops = 0.0
        self.bytes = 0.0
        self.launches = 0
        self.wire: Dict[str, float] = {}

    def gemm(self, m, k, n, times=1, isz=None, w_isz=None):
        """``times`` (m, k) × (k, n) products, a launch each."""
        isz = isz or self.act
        w_isz = w_isz or isz
        self.flops += 2.0 * m * k * n * times
        self.bytes += (m * k * isz + k * n * w_isz + m * n * isz) * times
        self.launches += times

    def elem(self, n, passes, isz=None):
        """``passes`` elementwise passes over ``n`` elements, a launch
        each."""
        self.flops += float(n) * passes
        self.bytes += 2.0 * n * (isz or self.act) * passes
        self.launches += passes

    def coll(self, kind: str, size: float, g: int, times=1):
        """A collective whose result is ``size`` bytes over a group of
        ``g`` devices (nothing moves for ``g == 1``)."""
        if g <= 1 or size <= 0:
            return
        frac = {"all-reduce": 2.0 * (g - 1) / g,
                "all-gather": (g - 1) / g,
                "reduce-scatter": (g - 1) / g,     # (g−1) × result
                "all-to-all": (g - 1) / g}[kind]
        self.wire[kind] = self.wire.get(kind, 0.0) + frac * size * times

    def add(self, other: "_Step", times: float = 1.0):
        self.flops += other.flops * times
        self.bytes += other.bytes * times
        self.launches += int(other.launches * times)
        for k, v in other.wire.items():
            self.wire[k] = self.wire.get(k, 0.0) + v * times


@dataclasses.dataclass(frozen=True)
class _Geo:
    """The local shapes of one device under the partition, read off the
    model's parameter placements and the batch's
    (:func:`_geometry`)."""

    cfg: object
    dp: int
    tp: int
    b: int            # local batch rows
    s: int            # tokens a row this pass (1 for decode)
    hq: int           # local query heads
    kv: int           # local kv heads (for the products)
    kva: int          # kv heads attention reads (padded: one a query head)
    hd: int           # local head dim
    kv_split: bool    # the kv heads split over "model" (the take gathers)
    attn_split: bool  # the heads or head dim over "model": wo row-split
    # (local, whole) width of each kind of block that has one: "mlp",
    # "shared" (the MoE's shared expert), "mamba" (d_inner), "rglru"
    widths: Dict[str, Tuple[int, int]]
    experts: Tuple[int, int]   # (local experts, their local width)
    vocab: int        # local vocabulary
    vocab_split: bool
    seq_split: bool   # training: the residual stream over the sequence
    mesh: bool        # under a mesh (the MoE's capacity rounded up to 8)
    rows_on: str      # the device type whose products pad their rows
    act: int
    par: int

    @property
    def t(self) -> int:
        return self.b * self.s


def _leaf(params: Dict, suffix: str):
    """The first parameter whose dotted name ends with ``suffix`` (every
    layer places its blocks alike), or ``None``."""
    return next((leaf for name, leaf in params.items()
                 if name.endswith(suffix)), None)


def _width(params: Dict, suffix: str, dim: int) -> Tuple[int, int]:
    """(local, whole) size of dimension ``dim`` of a parameter, (0, 0)
    when the model has none."""
    leaf = _leaf(params, suffix)
    return (0, 0) if leaf is None else (leaf.local_shape[dim],
                                        leaf.shape[dim])


def _geometry(cfg, ctx, kind: str, seq: int, params: Dict, tokens,
              rows_on: str) -> _Geo:
    """A device's shapes: its batch rows from the tokens' placement, heads,
    widths, experts and vocabulary from the parameters' (``params``:
    :func:`~repro_torch.launch.specs.param_specs_sharded`)."""
    wq, wk = _leaf(params, ".attn.wq"), _leaf(params, ".attn.wk")
    hq = hd = kv = 0
    kv_split = attn_split = False
    if wq is not None:
        _, hq, hd = wq.local_shape
        kv = wk.local_shape[1]
        kv_split = kv < wk.shape[1]
        attn_split = hq < wq.shape[1] or hd < wq.shape[2]
    padded = wq is not None and wq.shape[1] != cfg.n_heads
    moe = _leaf(params, ".moe.wi")
    head = params["lm_head"]
    return _Geo(
        cfg=cfg, dp=ctx.dp_size, tp=ctx.tp_size, b=tokens.local_shape[0],
        s=1 if kind == "decode" else seq, hq=hq, kv=kv,
        kva=hq if padded else kv, hd=hd, kv_split=kv_split,
        attn_split=attn_split,
        widths={"mlp": _width(params, ".mlp.wi", 1),
                "shared": _width(params, ".moe.shared.wi", 1),
                "mamba": _width(params, ".mamba.wx", 1),
                "rglru": _width(params, ".mix.wx", 1)},
        experts=(0, 0) if moe is None else (moe.local_shape[0],
                                            moe.local_shape[2]),
        vocab=head.local_shape[1], vocab_split=head.local_shape[1]
        < head.shape[1],
        seq_split=kind == "train" and ctx.tp_size > 1
        and seq % ctx.tp_size == 0,
        mesh=ctx.mesh is not None, rows_on=rows_on,
        act=itemsize(cfg.activation_dtype), par=itemsize(cfg.parameter_dtype))


def _norm(st: _Step, g: _Geo):
    st.elem(g.t * g.cfg.d_model, _NORM_PASSES)


def _block_in(st: _Step, g: _Geo):
    """A block's normed input: the sequence gathered under training."""
    _norm(st, g)
    if g.seq_split:
        st.coll("all-gather", g.t * g.cfg.d_model * g.act, g.tp)


def _row_out(st: _Step, g: _Geo, t: int, width: int, split: bool):
    """A row-split product's partial sums summed over ``"model"``, and the
    residual add."""
    if split:
        st.coll("all-reduce", t * width * g.act, g.tp)
    st.elem(t * g.cfg.d_model, 1)


def _flash(st: _Step, g: _Geo, b: int, sq: int, sk: int, causal_rope: bool):
    """The port's chunked attention over (sq, sk): every chunk pair of the
    padded lengths, two products a pair, the score passes."""
    c = g.cfg.attn_chunk
    qc, kc = min(c, sq), min(c, sk)
    sqp, skp = -(-sq // qc) * qc, -(-sk // kc) * kc
    st.gemm(b * g.hq * sqp, g.hd, skp, times=2, isz=4)
    st.elem(b * g.hq * sqp * skp, _SCORE_PASSES, isz=4)
    # each chunk pair is its own launches
    st.launches += (sqp // qc * (skp // kc) - 1) * (2 + _SCORE_PASSES)
    # float32 copies of q, k, v and the output
    st.elem(b * (sq * g.hq + 2 * sk * g.kva) * g.hd, 1, isz=4)
    if causal_rope:
        st.elem(b * sq * (g.hq + g.kv) * g.hd, _ROPE_PASSES)


def _attention(st: _Step, g: _Geo, *, src_len: int = 0, cache=None):
    """A self- (or, with ``src_len``, cross-) attention block on the
    normed input: the projections, attention, the output product.  A
    decode step with ``cache``, the block's cached k (a
    :class:`~repro_torch.launch.specs.Placed`: its slots and their
    placement)."""
    cfg, d = g.cfg, g.cfg.d_model
    decode = cache is not None
    _block_in(st, g)
    t = g.t
    kv_rows = g.b * src_len if src_len else t
    st.gemm(t, d, g.hq * g.hd)
    if not (src_len and decode):            # a cross decode reads its cache
        st.gemm(kv_rows, d, g.kv * g.hd, times=2)
    if cfg.qkv_bias and not src_len:
        st.elem(t * (g.hq + 2 * g.kv) * g.hd, 1)
    if decode:
        _, slots, c_kv, c_hd = cache.local_shape
        split = cache.shape[1] // slots          # the sequence-split cache
        if split > 1:
            st.coll("all-reduce", 3 * g.b * g.hq * g.hd * 4, split)
        if not src_len:
            st.elem(t * (g.hq + g.kv) * g.hd, _ROPE_PASSES)
            # the port copies the cache it is given, one slot replaced
            st.elem(2 * math.prod(cache.local_shape), 1)
        st.elem(2 * g.b * slots * g.kva * g.hd, 1, isz=4)  # float32 k, v
        st.gemm(g.b * g.hq, g.hd, slots, times=2, isz=4)
        st.elem(g.b * g.hq * slots, _SOFTMAX_PASSES, isz=4)
        if g.kv_split:
            st.coll("all-gather", 2 * g.b * slots * g.kv * g.tp * g.hd
                    * g.act, g.tp)
        elif c_kv * c_hd < g.kv * g.hd:          # the cache's head dim split
            st.coll("all-gather", 2 * g.b * slots * g.kva * g.hd * g.act,
                    g.tp)
    else:
        sk = src_len or g.s
        _flash(st, g, g.b, g.s, sk, causal_rope=not src_len)
        if g.kv_split:
            st.coll("all-gather", 2 * g.b * sk * g.kv * g.tp * g.hd * g.act,
                    g.tp)
    if src_len:
        st.elem(t * d, 2)                    # the gate
    st.gemm(t, g.hq * g.hd, d)
    _row_out(st, g, t, d, g.attn_split)


def _mlp(st: _Step, g: _Geo, which: str = "mlp"):
    cfg, d, t = g.cfg, g.cfg.d_model, g.t
    f, f_full = g.widths[which]
    _block_in(st, g)
    n_in = 2 if cfg.act == "silu" else 1
    st.gemm(t, d, f, times=n_in)
    st.elem(t * f, _SILU_PASSES if cfg.act == "silu" else _GELU_PASSES)
    st.gemm(t, f, d)
    _row_out(st, g, t, d, f != f_full)


def _moe_capacity(g: _Geo) -> int:
    """The capacity C of a data shard's routing (``blocks.py:283-295``:
    rounded up to 8 under a mesh)."""
    cfg = g.cfg
    cap = int(g.t * cfg.top_k / cfg.n_experts * cfg.capacity_factor) + 1
    return -(-cap // 8) * 8 if g.mesh else cap


def _moe(st: _Step, g: _Geo):
    """The router (float32), the dispatch, the experts' three products over
    the (E_loc, C, d) buffers, the combine, the psum over ``"model"``; the
    shared expert.  Under FSDP the experts' weights are gathered with the
    others (:func:`price_lm_step`)."""
    cfg, d, t = g.cfg, g.cfg.d_model, g.t
    e, k = cfg.n_experts, cfg.top_k
    e_loc, f = g.experts
    _block_in(st, g)
    cap = _moe_capacity(g)
    st.gemm(t, d, e, isz=4)
    st.elem(t * e, _SOFTMAX_PASSES + 2, isz=4)
    st.elem(t * k * d, 2)                    # dispatch and combine
    st.gemm(e_loc * cap, d, f, times=2)
    st.elem(e_loc * cap * f, _SILU_PASSES)
    st.gemm(e_loc * cap, f, d)
    st.elem(e_loc * cap * d, 1)              # the gate's scale
    if g.tp > 1:
        st.coll("all-reduce", t * d * g.act, g.tp)
    st.elem(t * d, 1)
    if g.widths["shared"][0]:
        _mlp(st, g, "shared")


def _rows(g: _Geo, name: str) -> int:
    """The rows the product ``name`` runs on (``models/blocks.py``
    :func:`~repro_torch.models.blocks.rows_run`: on the card at least its
    minimum)."""
    from repro_torch.models.blocks import rows_run
    return rows_run(name, g.b, g.s, g.rows_on)


def _mamba(st: _Step, g: _Geo):
    cfg, d, t = g.cfg, g.cfg.d_model, g.t
    n, r = cfg.ssm_state, cfg.dt_rank_
    di, di_full = g.widths["mamba"]
    split = di < di_full
    _block_in(st, g)
    st.gemm(t, d, di, times=2)                       # wx, wz
    st.elem(t * di, 2 * cfg.d_conv + _CONV_PASSES)   # the conv, bias, silu
    st.gemm(_rows(g, "x_proj"), di, r + 2 * n)
    if split:
        st.coll("all-reduce", t * (r + 2 * n) * g.act, g.tp)
    st.gemm(_rows(g, "dt_proj"), r, di, isz=4)       # float32
    st.elem(t * di * n, _SCAN_PASSES, isz=4)
    st.elem(t * di, _MAMBA_GATE_PASSES)
    st.gemm(_rows(g, "out_proj"), di, d)
    _row_out(st, g, t, d, split)


def _rglru(st: _Step, g: _Geo):
    cfg, d, t = g.cfg, g.cfg.d_model, g.t
    w, w_full = g.widths["rglru"]
    split = w < w_full
    _block_in(st, g)
    st.gemm(t, d, w, times=2)                        # wx, wy
    st.elem(t * w, 2 * cfg.d_conv + 1)               # the conv and bias
    if split:                                        # the gates read all W
        st.coll("all-gather", t * w_full * g.act, g.tp)
    st.gemm(t, w_full, w, times=2, isz=4)            # w_input, w_rec
    chunk = max(min(cfg.scan_chunk, g.s), 1)
    steps = max(int(math.ceil(math.log2(chunk))), 1)
    st.elem(t * w, _RGLRU_PASSES + 4 * steps, isz=4)
    st.gemm(t, w, d)
    _row_out(st, g, t, d, split)


def _decoder(cfg) -> Tuple[List[str], List[str]]:
    """(one entry of ``groups``, the ``tail`` after them): the blocks each
    runs in order (``models/model.py`` :func:`~repro_torch.models.model.
    block_kinds`), the tail's entries repeated."""
    from repro_torch.models.model import block_kinds, stack_sizes
    kinds, sizes = block_kinds(cfg), stack_sizes(cfg)
    return kinds["groups"], kinds.get("tail", []) * sizes.get("tail", 0)


def _blocks_pass(g: _Geo, blocks_: List[str], src_len: int,
                 caches: Dict[str, object]) -> _Step:
    """``blocks_`` in order, one forward pass; a decode step with
    ``caches`` (``"attn"``, ``"cross"``: each kind's cached k)."""
    st = _Step(g.act)
    for blk in blocks_:
        if blk == "attn":
            _attention(st, g, cache=caches.get("attn"))
        elif blk == "cross":
            _attention(st, g, src_len=src_len, cache=caches.get("cross"))
        elif blk == "mlp":
            _mlp(st, g)
        elif blk == "moe":
            _moe(st, g)
        elif blk == "mamba":
            _mamba(st, g)
        else:
            _rglru(st, g)
    return st


def _saved(g: _Geo, blocks_: List[str]) -> float:
    """Bytes ``blocks_`` keep for the backward (no remat): each block's
    normed input and output, and its intermediates."""
    cfg, d, t = g.cfg, g.cfg.d_model, g.t
    out = 0.0
    for blk in blocks_:
        out += 2 * t * d * g.act
        if blk in ("attn", "cross"):
            out += t * 2 * (g.hq + g.kv) * g.hd * g.act \
                + 2 * g.b * g.hq * g.s * 4
        elif blk == "mlp":
            out += 3 * t * g.widths["mlp"][0] * g.act
        elif blk == "moe":
            e_loc, f = g.experts
            out += t * cfg.n_experts * 3 * 4 \
                + e_loc * _moe_capacity(g) * (2 * d + 3 * f) * g.act
            out += 3 * t * g.widths["shared"][0] * g.act
        elif blk == "mamba":
            di = g.widths["mamba"][0]
            # xz, xc, z, y; dt float32; the scan's segment states
            out += t * 4 * di * g.act + t * di * 4 \
                + g.b * di * cfg.ssm_state * 4 * -(-g.s // cfg.scan_chunk)
        elif blk == "rglru":
            w = g.widths["rglru"][0]
            out += t * 4 * w * g.act + 4 * t * w * 4
    return out


def _transient(g: _Geo, blk: str) -> float:
    """Bytes a block holds at once beyond the residual stream in a
    prefill: its input, output and intermediates (attention: float32
    copies and one score block; the MLP's ``silu(x wi)``, ``x wg`` and
    their product at once, or ``x wi`` and its gelu)."""
    cfg, d, t = g.cfg, g.cfg.d_model, g.t
    if blk in ("attn", "cross"):
        return t * (4 * d + 3 * (g.hq + 2 * g.kv) * g.hd) * 4 \
            + _score_block(g, g.s, g.s)
    if blk == "mlp":
        f = g.widths["mlp"][0]
        return t * (4 * d + (3 if cfg.act == "silu" else 2) * f) * g.act
    if blk == "moe":
        e_loc, f = g.experts
        return e_loc * _moe_capacity(g) * (2 * d + 3 * f) * g.act \
            + t * cfg.n_experts * 16
    if blk == "mamba":
        di = g.widths["mamba"][0]
        return max(t * (4 * d + 4 * di) * g.act, t * di * (6 * g.act + 8))
    return t * (4 * d + 4 * g.widths["rglru"][1]) * g.act


def _score_block(g: _Geo, sq: int, sk: int) -> float:
    """Bytes of one chunk pair's float32 score block.  ``_FlashCore``'s
    forward holds one (the probabilities overwrite the scores), its
    backward two (the probabilities; dp, overwritten by ds)."""
    c = g.cfg.attn_chunk
    return 4.0 * g.b * g.hq * min(c, sq) * min(c, sk)


def _cache_leaves(tree, path: str = ""):
    """(dotted path, leaf) of a cache tree's placed leaves."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _cache_leaves(v, f"{path}.{k}" if path else k)
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _cache_leaves(v, f"{path}.{i}")
    else:
        yield path, tree


def _cache(model, batch: int, cache_len: int, src_len: int
           ) -> Tuple[float, Dict[str, object]]:
    """A cache's bytes per device (``launch/specs.py``
    :func:`~repro_torch.launch.specs.cache_specs`) and its cached k of a
    self- (``"attn"``) and a cross-attention layer (``"cross"``, the
    reference's key), where it has them."""
    from repro_torch.launch.specs import cache_specs
    total, ks = 0.0, {}
    for path, leaf in _cache_leaves(cache_specs(model, batch, cache_len,
                                                src_len)):
        total += leaf.local_nbytes
        parts = path.split(".")
        if parts[-1] == "k":
            ks.setdefault("cross" if parts[-2] == "cross" else "attn", leaf)
    return total, ks


def _on_meta(ctx):
    """``ctx`` with its mesh's devices the ``meta`` device (a model under
    it holds no storage; the placements are the same)."""
    if ctx.mesh is None:
        return ctx
    mesh = dataclasses.replace(ctx.mesh, devices=(torch.device("meta"),)
                               * ctx.mesh.size)
    return dataclasses.replace(ctx, mesh=mesh)


def price_lm_step(cfg, ctx, kind: str, batch: int, seq: int, *,
                  microbatches: int = 1, optimizer: str = "adamw",
                  model=None) -> PlanCost:
    """The :class:`PlanCost` of one LM step per device (the busiest; the
    layouts split evenly): a training step (``kind="train"``: loss,
    gradients, ``optimizer`` ``"adamw"`` or ``"adafactor"``, in
    ``microbatches``), a prefill of ``batch`` × ``seq`` tokens, or one
    decode step from a cache of ``seq`` slots.  ``ctx`` is a
    :class:`~repro_torch.distributed.context.MeshCtx` (``MeshCtx(None)``:
    one device, the CUDA device).  The parameters', the batch's and the
    cache's placements are those the dry run builds
    (:mod:`repro_torch.launch.specs`) on ``model``, the abstract model
    (``ctx``'s mesh over the ``meta`` device; built when not given); the
    blocks
    are the model's own (:func:`~repro_torch.models.model.block_kinds`).
    Unless the mesh is of CPU devices the step runs on cards, whose
    few-row products run on at least ``models/blocks.py``'s minimum rows
    (the CPU pads none).  The rule it follows is stated above; executes
    nothing."""
    from repro_torch.launch import specs as specmod
    from repro_torch.models.model import Model, block_kinds, stack_sizes
    if kind not in STEP_KINDS:
        raise ValueError(f"kind {kind!r}: the kinds are {STEP_KINDS}")
    if optimizer not in ("adamw", "adafactor"):
        raise ValueError(f"optimizer {optimizer!r}: adamw or adafactor")
    if model is None:
        model = Model(cfg, _on_meta(ctx), device="meta")
    on_cpu = ctx.mesh is not None and ctx.mesh.flat[0].type == "cpu"
    params = specmod.param_specs_sharded(model)
    tokens = specmod.batch_specs(cfg, ctx, batch, seq,
                                 with_labels=False)["tokens"]
    extra = specmod.extra_specs(cfg, ctx, batch, seq)
    src_len = 0 if extra is None else next(iter(extra.values())).shape[1]
    g = _geometry(cfg, ctx, kind, seq, params, tokens,
                  "cpu" if on_cpu else "cuda")
    d = cfg.d_model
    group_blocks, tail = _decoder(cfg)
    n_groups = stack_sizes(cfg)["groups"]
    fa = ctx.fsdp_axis
    fsdp_g = ctx.axis_size(fa) if fa is not None else 1
    # each parameter: (its bytes whole over the FSDP axis, split over it)
    leaves = []
    for leaf in params.values():
        fsdp = fa is not None and any(
            fa in ((e,) if isinstance(e, str) else tuple(e or ()))
            for e in leaf.sharding.spec)
        leaves.append((leaf.local_nbytes * (fsdp_g if fsdp else 1), fsdp))
    local_p = sum(leaf.local_nbytes for leaf in params.values())
    largest = max(math.prod(leaf.local_shape) for leaf in params.values())

    # ---- one forward pass (the prefill's, a decode step, or a microbatch
    # of the training step's)
    if kind == "train" and microbatches > 1:
        g = dataclasses.replace(g, b=max(g.b // microbatches, 1))
    t = g.t
    caches: Dict[str, object] = {}
    if kind == "decode":
        cache_bytes, caches = _cache(model, batch, seq, src_len)
    fwd = _blocks_pass(g, group_blocks * n_groups + tail, src_len, caches)
    enc = _Step(g.act)
    if "enc_groups" in stack_sizes(cfg) and kind != "decode":
        # the audio encoder over the frames (not causal; its own length)
        ge = dataclasses.replace(g, s=src_len, seq_split=False)
        enc = _blocks_pass(ge, block_kinds(cfg)["enc_groups"]
                           * stack_sizes(cfg)["enc_groups"], 0, {})
        _norm(enc, ge)
    head = _Step(g.act)
    head.elem(t * d, 1)                           # the embedding's gather
    if g.vocab_split:
        head.coll("all-reduce", t * d * g.act, g.tp)
    rows = t if kind == "train" else g.b          # logits of every token
    _norm(head, dataclasses.replace(g, s=rows // g.b))
    head.gemm(rows, d, g.vocab)
    head.elem(rows * g.vocab, 1, isz=4)           # to float32
    gathers = _Step(g.act)                        # FSDP: weights per pass
    for n, f in leaves:
        if f:
            gathers.coll("all-gather", n, fsdp_g)

    cost = PlanCost()
    total = _Step(g.act)
    if kind != "train":
        total.add(fwd)
        total.add(enc)
        total.add(head)
        total.add(gathers)
    else:
        head.elem(t * g.vocab, _SOFTMAX_PASSES, isz=4)   # logsumexp, gold
        if g.vocab_split:
            head.coll("all-reduce", 3 * t * 4, g.tp)
        body = _Step(g.act)
        body.add(fwd)
        body.add(enc)
        bwd = _Step(g.act)
        bwd.flops = 2.0 * (body.flops + head.flops)
        bwd.bytes = 2.0 * (body.bytes + head.bytes)
        bwd.launches = 2 * (body.launches + head.launches)
        _backward_wire(bwd, g, group_blocks * n_groups + tail, fwd, head)
        step = _Step(g.act)
        step.add(body, 2 if cfg.remat else 1)
        step.add(head)
        step.add(bwd)
        step.add(gathers, 3 if cfg.remat else 2)
        total.add(step, microbatches)
        if microbatches > 1:                      # float32 accumulation
            total.elem(local_p // g.par, microbatches, isz=4)
        # the gradients: reduce-scattered over the FSDP axis (then summed
        # over the other data axes), else all-reduced over the data axes
        for n, f in leaves:
            grad = n // g.par * 4 if microbatches > 1 else n
            if f:
                total.coll("reduce-scatter", grad, fsdp_g)
                total.coll("all-reduce", grad // fsdp_g, g.dp // fsdp_g)
            else:
                total.coll("all-reduce", grad, g.dp)
        passes = _ADAMW_PASSES if optimizer == "adamw" else \
            _ADAFACTOR_PASSES
        n_local = local_p // g.par
        total.flops += passes * n_local
        total.launches += passes * len(leaves)
        state = 8 if optimizer == "adamw" else 0
        total.bytes += n_local * (2 * g.par + 2 * state + g.par)
    cost.flops = total.flops
    cost.hbm_bytes = total.bytes
    cost.launches = total.launches
    cost.wire = {k: v for k, v in total.wire.items() if v}

    # ---- the working set beyond the arguments
    if kind == "train":
        group = _saved(g, group_blocks)
        if cfg.remat:           # each group's input; one group's set
            acts = n_groups * t * d * g.act + group
        else:
            acts = n_groups * group
        acts += _saved(g, tail)
        if "enc_groups" in stack_sizes(cfg):
            acts += stack_sizes(cfg)["enc_groups"] * _saved(
                dataclasses.replace(g, s=src_len),
                block_kinds(cfg)["enc_groups"])
        logits = t * g.vocab * (4 + 4 + 4 + g.act)
        score = 2 * _score_block(g, g.s, g.s)
        grads = local_p + (local_p // g.par * 4 if microbatches > 1 else 0)
        opt_tmp = _OPT_TEMPS * largest * 4
        temp = grads + acts + logits + score + opt_tmp
    elif kind == "prefill":
        # the cache it returns (``Model.prefill``'s default S + 128 slots)
        cache = _cache(model, batch, seq + 128, src_len)[0]
        layer = max(_transient(g, blk) for blk in set(group_blocks + tail))
        src = src_len * g.b * d * g.act * 4
        temp = cache + layer + 2 * t * d * g.act + src
    else:
        # the copy of the cache it returns; one layer's float32 k and v
        heaviest = 0.0
        if caches:
            slots = max(k.local_shape[1] for k in caches.values())
            heaviest = 2 * g.b * slots * g.kva * g.hd * (4 + g.act)
        if g.widths["mamba"][0]:
            heaviest = max(heaviest, _rows(g, "x_proj")
                           * (g.widths["mamba"][0] + d) * g.act)
        temp = cache_bytes + heaviest + g.b * g.vocab * 4 * 2
    cost.temp_bytes = float(temp)
    return cost


def _backward_wire(bwd: _Step, g: _Geo, blocks_: List[str], fwd: _Step,
                   head: _Step):
    """The backward's collectives: the forward's all-reduces again (each
    column-split product's input gradient summed over ``"model"``), the
    kv gather's gradient, under the sequence split the block inputs
    gathered twice more and the elementwise intermediates resharded
    (all-to-all)."""
    for kind_, v in fwd.wire.items():
        if kind_ == "all-reduce":
            bwd.wire["all-reduce"] = bwd.wire.get("all-reduce", 0.0) + v
        elif kind_ == "all-gather":
            bwd.wire["all-gather"] = bwd.wire.get("all-gather", 0.0) + 2 * v
    for kind_, v in head.wire.items():
        bwd.wire[kind_] = bwd.wire.get(kind_, 0.0) + v
    if not g.seq_split:
        return
    t, cfg = g.t, g.cfg
    a2a = 0.0
    for blk in blocks_:
        if blk in ("attn", "cross"):
            a2a += 2 * t * g.hq * g.hd
        elif blk == "mlp":
            a2a += (3 if cfg.act == "silu" else 2) * t * g.widths["mlp"][0]
        elif blk == "moe":
            a2a += 3 * t * g.widths["shared"][0]
        elif blk == "mamba":
            di = g.widths["mamba"][0]
            a2a += 9 * t * di + 2 * t * di * cfg.ssm_state
        elif blk == "rglru":
            a2a += 6 * t * g.widths["rglru"][0]
    bwd.coll("all-to-all", a2a * g.act, g.tp)
