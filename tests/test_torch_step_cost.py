"""The port's priced LM step (``repro_torch.distributed.plan_cost.
price_lm_step``) held against the reference's compiled one, on the CPU.

The band rule of ``plan_cost``'s docstring: on the reduced cells of the
dense (Qwen2-1.5B), MoE (Mixtral-8x7B) and SSM (Falcon-Mamba-7B) families,
4 × 64 tokens for a training step (AdamW) and a prefill and a decode step
from a cache of 64, the reference is compiled on a ``jax.sharding.Mesh``
(Auto axes) over the suite's 4 CPU devices, (2, 2) as ``("data",
"model")`` without FSDP (the dry run's choice below 2e9 parameters), and
``roofline(compiled, 4).summary()`` read; the port prices the same cell on
a (2, 2) mesh of the CPU (whose products pad no rows).
Per-device FLOPs and the wire bytes of every collective kind either side
moves lie within ``BAND`` either way.  Also: the dry run's ``ok`` cells on
both production meshes carry a positive temp size and a priced roofline,
``useful_flops_frac ≤ 1`` (see
:func:`test_useful_flops_fraction_at_most_one`), ``fits`` counts the
temporaries, and the pricing's refusals.

``PYTHONPATH=src python tests/test_torch_step_cost.py`` prints the ratios
of every configuration's reduced cells, with and without FSDP (one JSON
line a cell).
"""
import math
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

os.environ.setdefault("JAX_PLATFORMS", "cpu")
if "xla_force_host_platform_device_count" not in os.environ.get("XLA_FLAGS",
                                                                ""):
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") + " --xla_"
                               "force_host_platform_device_count=4").strip()
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.distributed import roofline as jroofline  # noqa: E402
from repro.distributed.context import MeshCtx as JMeshCtx  # noqa: E402
from repro.launch import specs as jspecs  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.train.steps import make_train_step as jtrain_step  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.distributed import plan_cost, roofline  # noqa: E402
from repro_torch.distributed.context import MeshCtx  # noqa: E402
from repro_torch.distributed.sharding import Mesh  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402

BAND = 2.0                     # either way
BATCH, SEQ = 4, 64
FAMILIES = {"dense": "qwen2-1.5b", "moe": "mixtral-8x7b",
            "ssm": "falcon-mamba-7b"}
KINDS = ("train", "prefill", "decode")
_CACHE: dict = {}


def _reference(arch: str, kind: str, fsdp: bool = False) -> dict:
    """The reference's compiled roofline of a reduced cell on the (2, 2)
    mesh of the CPU devices (compiled once per module)."""
    if (arch, kind, fsdp) in _CACHE:
        return _CACHE[arch, kind, fsdp]
    cfg = jconfigs.get(arch).reduced()
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2),
                             ("data", "model"))
    ctx = JMeshCtx.from_mesh(mesh, fsdp=fsdp)
    model = JModel(cfg, ctx)
    params = jspecs.param_specs_sharded(model)
    if kind == "train":
        opt = jadamw()
        fn = jax.jit(jtrain_step(model, opt), donate_argnums=(0, 1))
        args = (params, jspecs.opt_state_specs(opt[0], model),
                jspecs.batch_specs(cfg, ctx, BATCH, SEQ, with_labels=True),
                jspecs.extra_specs(cfg, ctx, BATCH, SEQ))
    elif kind == "prefill":
        fn = jax.jit(lambda p, t, x: model.prefill(p, t, x))
        args = (params, jspecs.batch_specs(cfg, ctx, BATCH, SEQ,
                                           with_labels=False)["tokens"],
                jspecs.extra_specs(cfg, ctx, BATCH, SEQ))
    else:
        tok = jax.ShapeDtypeStruct((BATCH, 1), jnp.int32,
                                   sharding=ctx.sharding(ctx.dp_axes, None))
        fn = jax.jit(lambda p, c, t: model.decode(p, c, t))
        extra_len = (SEQ // cfg.enc_seq_ratio if cfg.family == "audio" else
                     cfg.n_image_tokens if cfg.family == "vlm" else 0)
        args = (params, jspecs.cache_specs(model, BATCH, SEQ, extra_len),
                tok)
    with mesh:
        compiled = fn.lower(*args).compile()
    _CACHE[arch, kind, fsdp] = jroofline.roofline(compiled, 4).summary()
    return _CACHE[arch, kind, fsdp]


def _priced(arch: str, kind: str, fsdp: bool = False) -> plan_cost.PlanCost:
    """The port's price of the cell on a (2, 2) mesh of the CPU (no padded
    rows)."""
    mesh = Mesh((2, 2), ("data", "model"), [torch.device("cpu")] * 4)
    return plan_cost.price_lm_step(configs.get(arch).reduced(),
                                   MeshCtx.from_mesh(mesh, fsdp=fsdp), kind,
                                   BATCH, SEQ)


def _ratios(arch: str, kind: str, fsdp: bool = False) -> dict:
    """Priced over compiled: FLOPs, and the wire bytes of each kind either
    side moves (0 or inf where only one does)."""
    want = _reference(arch, kind, fsdp)
    cost = _priced(arch, kind, fsdp)
    out = {"flops": cost.flops / want["flops_per_device"]}
    for k in sorted(set(want["by_collective"]) | set(cost.wire)):
        ref = want["by_collective"].get(k, 0.0)
        out[k] = cost.wire.get(k, 0.0) / ref if ref else float("inf")
    return out


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("family", list(FAMILIES))
def test_priced_step_within_band_of_compiled(family, kind):
    """FLOPs per device and wire bytes per collective kind within BAND of
    the reference's compiled program."""
    ratios = _ratios(FAMILIES[family], kind)
    assert all(1 / BAND <= r <= BAND for r in ratios.values()), ratios


def test_one_device_moves_nothing_and_pads_on_the_card():
    """One device: no wire bytes; on the card (no mesh: the CUDA device) a
    decode step's Mamba products run on at least ``_MIN_ROWS`` rows, so it
    prices more FLOPs than on a mesh of the CPU."""
    cfg = configs.get("falcon-mamba-7b").reduced()
    ctx = MeshCtx(None)
    on_cpu = MeshCtx.from_mesh(Mesh((1, 1), ("data", "model"),
                                    [torch.device("cpu")]))
    cpu = plan_cost.price_lm_step(cfg, on_cpu, "decode", 4, 64)
    card = plan_cost.price_lm_step(cfg, ctx, "decode", 4, 64)
    assert cpu.wire == {} and card.wire == {}
    assert card.flops > cpu.flops > 0
    for kind in KINDS:
        cost = plan_cost.price_lm_step(cfg, ctx, kind, 4, 64)
        assert cost.temp_bytes > 0 and cost.launches > 0
    with pytest.raises(ValueError, match="kind"):
        plan_cost.price_lm_step(cfg, ctx, "serve", 4, 64)
    with pytest.raises(ValueError, match="optimizer"):
        plan_cost.price_lm_step(cfg, ctx, "train", 4, 64, optimizer="sgd")


def test_remat_and_microbatches_price_their_work():
    """Remat runs each group's forward twice; microbatches run the step's
    passes per microbatch and keep float32 accumulators."""
    import dataclasses
    cfg = configs.get("qwen2-1.5b").reduced()
    ctx = MeshCtx(None)
    plain = plan_cost.price_lm_step(cfg, ctx, "train", 4, 64)
    remat = plan_cost.price_lm_step(dataclasses.replace(cfg, remat=True),
                                    ctx, "train", 4, 64)
    assert remat.flops > plain.flops and remat.temp_bytes < plain.temp_bytes
    two = plan_cost.price_lm_step(cfg, ctx, "train", 4, 64, microbatches=2)
    assert two.flops == pytest.approx(plain.flops, rel=0.05)
    assert two.temp_bytes < plain.temp_bytes


# each block kind by the parameter that only it has
_KIND_LEAF = {"attn": ".attn.wq", "cross": ".xattn.wq", "mlp": "mlp.wi",
              "moe": ".moe.wi", "mamba": ".mamba.wx", "rglru": ".mix.wx"}


@pytest.mark.parametrize("arch", configs.names())
def test_block_kinds_follow_the_model(arch):
    """The blocks the pricing walks (``block_kinds``) are the model's own:
    each stacked list's first entry has its blocks' parameters in that
    order, and the kinds times the list sizes count every block of the
    model (the MoE's shared expert counted with its layer)."""
    from repro_torch.models.model import Model, block_kinds, stack_sizes
    cfg = configs.get(arch).reduced()
    names = [n for n, _ in Model(cfg, MeshCtx(None),
                                 device="meta").named_parameters()
             if ".shared." not in n]
    kinds, sizes = block_kinds(cfg), stack_sizes(cfg)
    assert set(kinds) == set(sizes)
    for lst, blocks in kinds.items():
        first = [n for n in names if n.startswith(f"{lst}.0.")]
        seen = [k for n in first for k, leaf in _KIND_LEAF.items()
                if n.endswith(leaf)]
        assert seen == blocks, (lst, seen, blocks)
    for kind, leaf in _KIND_LEAF.items():
        want = sum(blocks.count(kind) * sizes[lst]
                   for lst, blocks in kinds.items())
        assert sum(n.endswith(leaf) for n in names) == want, kind


@pytest.mark.parametrize("multi_pod", [False, True])
def test_priced_cache_is_the_dry_runs(multi_pod):
    """A decode cell's priced cache is the dry run's cache argument, placed
    alike (``launch/specs.py``), and its temporaries hold at least the
    copy of it the step returns; the abstract model is the dry run's."""
    for arch, shape, meta, skip in configs.cells():
        if skip or meta["kind"] != "decode":
            continue
        built = dryrun.build_cell(arch, shape, multi_pod)
        cfg, _, _, ctx, model = built
        cache = dryrun.argument_bytes(dryrun.cell_args(
            arch, shape, multi_pod=multi_pod)[0][1])
        extra = dryrun.specmod.extra_specs(cfg, ctx, meta["global_batch"],
                                           meta["seq_len"])
        src = 0 if extra is None else next(iter(extra.values())).shape[1]
        priced = plan_cost._cache(model, meta["global_batch"],
                                  meta["seq_len"], src)[0]
        assert priced == cache, (arch, shape)
        assert dryrun.cell_cost(arch, shape, multi_pod=multi_pod
                                ).temp_bytes >= cache, (arch, shape)


def test_rows_run_pads_as_the_card_runs():
    """The rows a padded product runs on (``blocks.rows_run``, what
    ``_on_rows`` pads to and the pricing counts): on the card at least its
    minimum, in whole rows of the sequence; the CPU and the unlisted
    products pad none."""
    from repro_torch.models import blocks
    assert blocks.rows_run("x_proj", 4, 1, "cuda") == 1024
    assert blocks.rows_run("x_proj", 1, 300, "cuda") == 1200
    assert blocks.rows_run("x_proj", 8, 300, "cuda") == 2400
    assert blocks.rows_run("x_proj", 4, 1, "cpu") == 4
    assert blocks.rows_run("mlp", 4, 1, "cuda") == 4


@pytest.fixture(scope="module")
def cells():
    return {mp: [dryrun.run_cell(a, s, multi_pod=mp, verbose=False)
                 for a, s, _, _ in configs.cells()] for mp in (False, True)}


# 2·N·D counts the embedding as a product and, for a prefill, the head at
# every position; the port looks the embedding up and computes the head at
# the last position only (as the reference does).  Where that work is more
# than the rest adds, the fraction of the convention passes 1 (the
# Falcon-Mamba prefill: 1.07; the reference's own compiled reduced cell:
# 1.14); the test takes it out of the model FLOPs.
def _skipped(cell: dict, cfg) -> float:
    meta = configs.SHAPES[cell["cell"].split("×")[1]]
    tokens = meta["global_batch"] * (meta["seq_len"] if meta["kind"]
                                     != "decode" else 1)
    mult = 6 if meta["kind"] == "train" else 2
    vd = cfg.vocab_size * cfg.d_model
    out = mult * vd * tokens
    if meta["kind"] == "prefill":
        out += mult * vd * (tokens - meta["global_batch"])
    return out


@pytest.mark.parametrize("multi_pod", [False, True])
def test_useful_flops_fraction_at_most_one(cells, multi_pod):
    """On every ok cell: temp > 0, the roofline priced and finite, and the
    model FLOPs the step runs at most the priced FLOPs on every chip; the
    raw fraction at most 1 on every cell but the SSM prefills."""
    ok = [r for r in cells[multi_pod] if r["status"] == "ok"]
    assert len(ok) == 34
    over = []
    for r in ok:
        cfg = configs.get(r["cell"].split("×")[0])
        assert r["memory"]["temp_size_in_bytes"] > 0, r["cell"]
        flops = r["roofline"]["flops_per_device"] * r["chips"]
        assert (r["model_flops"] - _skipped(r, cfg)) / flops <= 1.0, \
            r["cell"]
        assert r["useful_flops_frac"] == pytest.approx(
            r["model_flops"] / flops)
        if r["useful_flops_frac"] > 1.0:
            over.append(r["cell"].split("×")[:2])
    assert over == [["falcon-mamba-7b", "prefill_32k"]]


def test_roofline_summary_has_the_reference_keys(cells):
    """The reference's summary keys, plus the port's launch term, every
    number finite; the bottleneck one of the terms."""
    want = {"flops_per_device", "hbm_bytes_per_device",
            "wire_bytes_per_device", "compute_s", "memory_s",
            "collective_s", "step_s", "bottleneck", "by_collective", "hw",
            "temp_bytes_per_device", "effective_bw"}
    for r in cells[False]:
        if r["status"] != "ok":
            continue
        roof = r["roofline"]
        assert set(roof) == want | {"launches", "launch_s"}
        for k, v in roof.items():
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                assert math.isfinite(v), (r["cell"], k)
        assert roof["bottleneck"] in ("compute", "memory", "collective",
                                      "launch")
        assert roof["temp_bytes_per_device"] == \
            r["memory"]["temp_size_in_bytes"]
        assert roof["step_s"] >= max(roof["compute_s"], roof["memory_s"],
                                     roof["collective_s"])


def test_fits_counts_the_temporaries(monkeypatch):
    """``fits`` compares arguments plus temporaries with the card's
    memory: a card between the arguments and that sum does not fit the
    cell; one at the sum does."""
    res = dryrun.run_cell("qwen2-1.5b", "train_4k", verbose=False)
    args = res["memory"]["argument_size_in_bytes"]
    temp = res["memory"]["temp_size_in_bytes"]
    monkeypatch.setattr(dryrun, "card_memory", lambda: args + temp // 2)
    assert dryrun.run_cell("qwen2-1.5b", "train_4k",
                           verbose=False)["fits"] is False
    monkeypatch.setattr(dryrun, "card_memory", lambda: args + temp)
    assert dryrun.run_cell("qwen2-1.5b", "train_4k",
                           verbose=False)["fits"] is True


def test_dryrun_line_prints_the_bottleneck(capsys):
    dryrun.run_cell("falcon-mamba-7b", "decode_32k")
    line = capsys.readouterr().out
    assert "bottleneck=" in line and "compute=" in line \
        and "coll=" in line and "temp=" in line


def test_detect_hw_follows_the_compute_dtype(monkeypatch):
    """The dry run's hardware: the card's preset at the configuration's
    compute dtype (bf16 on the tensor cores), the CPU's without a card."""
    monkeypatch.setenv("REPRO_HW", "h100-sxm")
    hw = roofline.detect_hw(torch.bfloat16)
    assert hw.peak_flops == roofline.PEAKS["SXM"]["bf16_tc"]
    res = dryrun.run_cell("qwen2-1.5b", "prefill_32k", verbose=False)
    assert res["roofline"]["hw"] == "h100-sxm"
    assert res["roofline"]["compute_s"] == pytest.approx(
        res["roofline"]["flops_per_device"] / hw.peak_flops)
    monkeypatch.delenv("REPRO_HW")
    if not torch.cuda.is_available():
        assert dryrun.run_cell("qwen2-1.5b", "prefill_32k", verbose=False
                               )["roofline"]["hw"] == "cpu"


if __name__ == "__main__":
    import json
    for name in configs.names():
        for kind in KINDS:
            for fsdp in (False, True):
                print(json.dumps({"arch": name, "kind": kind, "fsdp": fsdp,
                                  **{k: round(v, 3) for k, v in
                                     _ratios(name, kind, fsdp).items()}}),
                      flush=True)
