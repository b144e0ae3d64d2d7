"""The port's LM over a world of ranks, on the CPU: one gloo process per
mesh position, each holding only its blocks, exchanging through
``repro_torch.distributed.collectives``.

One world of 4 ranks serves the module: a module-scoped fixture spawns it
once (the ``spawn`` context, one torch thread a rank; the ranks meet
through a ``file://`` store under the fixture's directory) and the ranks
run every case of ``tests/_ranks_worker.py``, writing their results
there.  Meanwhile the test process computes what they are held against:
the same models on the mesh of repeated CPU devices (the oracle: each
rank's block within 1e-5 of the repeated-device run's
``NamedSharding.block``, measured against the largest entry of the whole
quantity: a block of a gradient that cancels to float32 noise, as the k
biases' does with the head dim split, moved by up to 1e-3 of its own
largest entry when summed in another order) and, for one case of each
family, JAX under its mesh of the 4 CPU devices (within 1e-4,
``tests/test_torch_mesh.py``'s bound).  Also: each collective and its
gradient against ``jax.lax``'s under ``shard_map``;
``compressed_psum_tree`` over ranks; the MoE's kept (token, expert) pairs
exactly; a 3-step AdamW run under (2, 2) with FSDP and remat (plain, with
``compress_grads``, in microbatches); a checkpoint written by a
(2, 2) world and read by a (1, 4) world and by one process, bit for bit;
each rank's parameter bytes against the dry run's; the refusals.

``python tests/test_torch_ranks.py`` prints one (2, 2) training step's
collective bytes by kind beside ``plan_cost.price_lm_step``'s wire bytes.
"""
import dataclasses
import multiprocessing as mp
import os
import sys
import time
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

os.environ.setdefault("JAX_PLATFORMS", "cpu")
if __name__ == "__main__":      # tests/conftest.py's 4 CPU devices
    os.environ.setdefault("XLA_FLAGS",
                          "--xla_force_host_platform_device_count=4")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh as JMesh  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.distributed import compression as jcompression  # noqa: E402
from repro.distributed.context import MeshCtx as JMeshCtx  # noqa: E402
from repro.models import blocks as jblocks  # noqa: E402
from repro.models import params as jparams  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro_torch import configs, convert  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.distributed import compression  # noqa: E402
from repro_torch.distributed.context import MeshCtx  # noqa: E402
from repro_torch.distributed.runtime import init_world  # noqa: E402
from repro_torch.distributed.sharding import (  # noqa: E402
    Mesh, NamedSharding, param_pspecs)
from repro_torch.launch import specs as specmod  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import Model, blocks  # noqa: E402
from repro_torch.models.params import flatten  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.optim._tree import zeros_like_tree  # noqa: E402
from repro_torch.train import make_train_step  # noqa: E402
from repro_torch.train.steps import loss_and_grads  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _ranks_worker  # noqa: E402

CPU = torch.device("cpu")
AXES = ("data", "model")
N_RANKS = 4
RANK_TOL = 1e-5        # rank block against the repeated-device run's
RTOL = 1e-4            # against JAX (tests/test_torch_mesh.py)
BATCH, SEQ, N_DECODE = 2, 20, 2
HEADS = {"gqa_padded": (6, 2, True), "mha_padded": (5, 5, True),
         "head_dim_tp": (6, 2, False)}
MOE = {"ep_2x2": ((2, 2), False, 8), "ep_2x2_fsdp": ((2, 2), True, 8),
       "width_1x4": ((1, 4), False, 6)}
MAMBA = {"mamba_2x2": (2, 2), "mamba_1x4": (1, 4)}
# one case of each family is also held against JAX
JAX_CASES = ("dense_gqa_padded", "moe_ep_2x2", "mamba_2x2")
TRAIN_STEPS, TRAIN_LR = 3, 1e-2
# (name, compress_grads, microbatches) of the training runs
TRAIN_MODES = (("plain", False, 1), ("compressed", True, 1),
               ("microbatched", False, 2))
WORLD_TIMEOUT = 300.0


def _np64(t) -> np.ndarray:
    return np.asarray(t.detach() if isinstance(t, torch.Tensor) else t,
                      np.float64)


def _rel(got, want, whole=None) -> float:
    """max |got − want| over max |whole| (default ``want``): a rank's block
    is held to the largest entry of the whole quantity it is a block of."""
    got, want = _np64(got), _np64(want)
    scale = np.max(np.abs(_np64(want if whole is None else whole)))
    return float(np.max(np.abs(got - want)) / max(scale, 1e-30))


def _coord(shape, rank):
    return dict(zip(AXES, np.unravel_index(rank, shape)))


def _mesh(shape):
    return Mesh(shape, AXES, [CPU] * int(np.prod(shape)))


def _jmesh(shape):
    n = int(np.prod(shape))
    return JMesh(np.asarray(jax.devices()[:n]).reshape(shape), AXES)


def _pspecs(cfg, shape, fsdp):
    """Every parameter's partition spec at a mesh of ``shape``."""
    ctx = MeshCtx.from_mesh(Mesh(shape, AXES, ["meta"] * N_RANKS), fsdp=fsdp)
    return param_pspecs(Model(cfg, ctx, device="meta").param_specs(), ctx)


def _block(full, spec, shape, rank):
    return NamedSharding(_mesh(shape), spec).block(torch.as_tensor(full),
                                                   _coord(shape, rank))


def _draw(jm, seed):
    """The JAX model's parameters drawn with numpy from its specs (the
    norm scales, biases and routers redrawn as ``tests/test_torch_mesh.py``
    draws them; Mamba's A and dt bias by their rules)."""
    rng = np.random.default_rng(seed)

    def init(spec):
        if spec.init in ("zeros", "ones"):
            return np.full(spec.shape, float(spec.init == "ones"), np.float32)
        if spec.init == "mamba_a":
            a = np.log(np.arange(1, spec.shape[-1] + 1, dtype=np.float32))
            return np.broadcast_to(a, spec.shape).copy()
        if spec.init == "dt_bias":
            dt = np.exp(rng.uniform(np.log(1e-3), np.log(1e-1), spec.shape))
            return (dt + np.log(-np.expm1(-dt))).astype(np.float32)
        return (spec.scale * rng.standard_normal(spec.shape)).astype(
            np.float32)

    def leaf(path, a):
        name = jax.tree_util.keystr(path)
        a = np.asarray(a)
        if "'scale'" in name or "'b" in name.split("][")[-1]:
            return 0.1 * rng.standard_normal(a.shape).astype(np.float32)
        if "'router'" in name:
            return (rng.standard_normal(a.shape)
                    / np.sqrt(jm.cfg.d_model)).astype(np.float32)
        return a

    return jax.tree_util.tree_map_with_path(
        leaf, jparams.map_specs(init, jm.param_specs()))


def _cfgs(arch, **kw):
    return tuple(dataclasses.replace(c.get(arch).reduced(), **kw)
                 for c in (jconfigs, configs))


def _batch(vocab, seed, b=BATCH, s=SEQ):
    tokens = np.random.default_rng(seed).integers(0, vocab, (b, s + 1))
    return {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}


def _model_cases():
    """name → (JAX config, port config, mesh shape, FSDP, params seed,
    decode steps or None)."""
    out = {}
    for name, (h, kv, pad) in HEADS.items():
        out[f"dense_{name}"] = _cfgs("qwen2-1.5b", n_layers=2, n_heads=h,
                                     n_kv_heads=kv, head_dim=16,
                                     pad_heads=pad) + ((1, 4), False, 3, True)
    # the vocabulary (510) not over "model": the width is, the head's
    # partial logits summed; and attention split nowhere (head dim 18)
    out["dense_width_vocab"] = _cfgs("qwen2-1.5b", n_layers=2,
                                     vocab_size=510) + ((1, 4), False, 9,
                                                        True)
    out["dense_unsplit_heads"] = _cfgs(
        "qwen2-1.5b", n_layers=2, n_heads=5, n_kv_heads=5, head_dim=18,
        pad_heads=False) + ((1, 4), False, 10, True)
    for name, (shape, fsdp, e) in MOE.items():
        out[f"moe_{name}"] = _cfgs("mixtral-8x7b", n_layers=2, n_experts=e,
                                   capacity_factor=1.0) + (shape, fsdp, 5,
                                                           False)
    for name, shape in MAMBA.items():
        out[name] = _cfgs("falcon-mamba-7b", n_layers=2) + (
            shape, False, 7, shape == (1, 4))
    return out


MODEL_CASES = _model_cases()


def _inputs(root):
    """Every case the ranks run, with the inputs the test process holds
    them against."""
    rng = np.random.default_rng(11)
    cases = {}
    x = rng.standard_normal((8, 12)).astype(np.float32)
    outs = {"psum_model": (8, 12), "psum_all": (8, 12),
            "pmean_data": (8, 12), "gather_model": (8, 24),
            "scatter_data": (4, 12)}
    cases["collectives"] = dict(kind="collectives", x=x, w={
        n: rng.standard_normal(s).astype(np.float32)
        for n, s in outs.items()})
    for shape, axes in (((4, 1), ("data",)), ((2, 2), ("data", "model"))):
        cases[f"psum_tree_{shape[0]}x{shape[1]}"] = dict(
            kind="psum_tree", shape=shape, axes=axes,
            g={n: rng.standard_normal((4,) + s).astype(np.float32)
               for n, s in (("w", (6, 5)), ("b", (7,)))},
            r={n: 0.01 * rng.standard_normal((4,) + s).astype(np.float32)
               for n, s in (("w", (6, 5)), ("b", (7,)))})
    for name, (jcfg, cfg, shape, fsdp, seed, dec) in MODEL_CASES.items():
        jm = JModel(jcfg, JMeshCtx.from_mesh(_jmesh(shape), fsdp=fsdp))
        case = dict(kind="model", cfg=cfg, shape=shape, fsdp=fsdp,
                    params=_draw(jm, seed), batch=_batch(cfg.vocab_size,
                                                         seed + 1))
        if dec:
            case["steps"] = np.random.default_rng(seed + 2).integers(
                0, cfg.vocab_size, (N_DECODE, BATCH, 1))
        cases[name] = case
    for name, (shape, fsdp, e) in MOE.items():
        cases[f"pairs_{name}"] = dict(kind="moe_pairs", shape=shape,
                                      fsdp=fsdp, **_pairs_inputs(e))
    jcfg, cfg = _cfgs("qwen2-1.5b", n_layers=2, remat=True)
    jm = JModel(jcfg, JMeshCtx.from_mesh(_jmesh((2, 2)), fsdp=True))
    params = _draw(jm, 13)
    batches = [_batch(cfg.vocab_size, 20 + i, b=4, s=8)
               for i in range(TRAIN_STEPS)]
    for mode, compress, micro in TRAIN_MODES:
        cases[f"train_{mode}"] = dict(
            kind="train", cfg=cfg, shape=(2, 2), fsdp=True, params=params,
            batches=batches, lr=TRAIN_LR, compress=compress,
            microbatches=micro)
    cases["checkpoint"] = dict(kind="checkpoint", cfg=cfg,
                               dir=str(root / "ckpt"), batches=batches[:2])
    cases["refusals"] = dict(kind="refusals", dense=cfg, cfgs={
        fam: configs.get(arch).reduced() for fam, arch in
        (("hybrid", "recurrentgemma-2b"), ("audio", "whisper-base"),
         ("vlm", "llama-3.2-vision-11b"))})
    return cases


def _pairs_inputs(e):
    """``tests/test_torch_mesh.py``'s pair test: experts 0 and 1 favoured
    on every token, expert j writing only columns [8j, 8j + 8)."""
    _, cfg = _cfgs("mixtral-8x7b", n_layers=2, n_experts=e,
                   capacity_factor=1.0)
    rng = np.random.default_rng(8)
    t, d, f = 32, cfg.d_model, cfg.moe_d_ff
    router = rng.standard_normal((d, e)).astype(np.float32)
    router[0, :2] += 3.0 * np.sqrt(d)
    wo = np.zeros((e, f, d), np.float32)
    for j in range(e):
        wo[j, :, 8 * j:8 * j + 8] = rng.standard_normal((f, 8))
    p = dict(router=router / np.sqrt(d), wo=wo,
             wi=rng.standard_normal((e, d, f)).astype(np.float32),
             wg=rng.standard_normal((e, d, f)).astype(np.float32))
    x = rng.standard_normal((1, t, d)).astype(np.float32)
    x[..., 0] = 1.0
    return dict(cfg=cfg, p=p, x=x)


def _kept(out, e):
    out = np.asarray(out)
    return {(i, j) for i in range(out.shape[0]) for j in range(e)
            if np.abs(out[i, 8 * j:8 * j + 8]).max() > 0}


# ---------------------------------------------------------------- oracles


def _repeated(case):
    """The case on the mesh of repeated CPU devices: logits, loss, aux,
    gradients, prefill and decode; the partition specs."""
    ctx = MeshCtx.from_mesh(_mesh(case["shape"]), fsdp=case["fsdp"])
    net = convert.model_from_numpy(case["cfg"], case["params"], device="cpu",
                                   ctx=ctx)
    out = {"pspecs": param_pspecs(net.param_specs(), ctx)}
    with torch.no_grad():
        out["logits"] = net(case["batch"]["tokens"])[0]
    with blocks.routing_stats() as stats:
        loss, metrics, grads = loss_and_grads(net, case["batch"])
    out.update(loss=float(loss), aux=float(metrics["aux"]), grads=grads,
               stats=stats)
    if "steps" in case:
        out["prefill"], cache = net.prefill(case["batch"]["tokens"])
        out["decode"] = []
        for tok in case["steps"]:
            logits, cache = net.decode(cache, tok)
            out["decode"].append(logits)
        out["cache_after"] = cache
    return out


def _jax_model(case):
    """JAX's forward logits, loss, aux and gradients of the case under
    its mesh."""
    jmesh = _jmesh(case["shape"])
    jm = JModel(MODEL_CASES[case["name"]][0],
                JMeshCtx.from_mesh(jmesh, fsdp=case["fsdp"]))

    def run(p, b):
        logits = jm.forward(p, b["tokens"])[0]
        (loss, metrics), grads = jax.value_and_grad(jm.loss,
                                                    has_aux=True)(p, b)
        return logits, loss, metrics["aux"], grads

    with jmesh:
        logits, loss, aux, grads = jax.jit(run)(
            jax.tree.map(jnp.asarray, case["params"]),
            jax.tree.map(jnp.asarray, case["batch"]))
    return dict(logits=np.asarray(logits), loss=float(loss), aux=float(aux),
                grads=jax.tree.map(np.asarray, grads))


def _jax_collectives(case):
    smap = jax.shard_map
    jmesh = _jmesh((2, 2))
    ops = {"psum_model": lambda a: jax.lax.psum(a, "model"),
           "psum_all": lambda a: jax.lax.psum(a, ("data", "model")),
           "pmean_data": lambda a: jax.lax.pmean(a, "data"),
           "gather_model": lambda a: jax.lax.all_gather(a, "model", axis=1,
                                                        tiled=True),
           "scatter_data": lambda a: jax.lax.psum_scatter(
               a, "data", scatter_dimension=0, tiled=True)}
    spec = P("data", "model")
    out = {}
    x = jnp.asarray(case["x"])
    for name, op in ops.items():
        f = smap(op, mesh=jmesh, in_specs=spec, out_specs=spec)

        def value_and_grad(a, w, f=f):
            y, vjp = jax.vjp(f, a)
            return y, vjp(w)[0]     # the gradient of Σ f(a) · w

        y, g = jax.jit(value_and_grad)(x, jnp.asarray(case["w"][name]))
        out[name] = dict(value=np.asarray(y), grad=np.asarray(g))
    out["pmax_model"] = dict(value=np.asarray(jax.jit(smap(
        lambda a: jax.lax.pmax(a, "model"), mesh=jmesh, in_specs=spec,
        out_specs=spec))(x)))
    return out


def _jax_psum_tree(case):
    jmesh = _jmesh(case["shape"])
    spec = P(case["axes"])

    def fn(gl, rl):
        d, res = jcompression.compressed_psum_tree(
            {n: a[0] for n, a in gl.items()}, {n: a[0] for n, a in rl.items()},
            case["axes"])
        return ({n: a[None] for n, a in d.items()},
                {n: a[None] for n, a in res.items()})

    deq, res = jax.jit(jax.shard_map(fn, mesh=jmesh, in_specs=(spec, spec),
                                     out_specs=(spec, spec)))(case["g"],
                                                              case["r"])
    return jax.tree.map(np.asarray, deq), jax.tree.map(np.asarray, res)


def _train_repeated(case):
    ctx = MeshCtx.from_mesh(_mesh(case["shape"]), fsdp=case["fsdp"])
    net = convert.model_from_numpy(case["cfg"], case["params"], device="cpu",
                                   ctx=ctx)
    opt = adamw(lr=case["lr"])
    state = opt[0](net)
    if case["compress"]:
        state = (state, zeros_like_tree(net))
    step = make_train_step(net, opt, compress_grads=case["compress"],
                           microbatches=case["microbatches"])
    losses, norms = [], []
    for batch in case["batches"]:
        net, state, metrics = step(net, state, batch)
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
    return dict(losses=losses, norms=norms)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Spawns the world of 4 ranks once; computes the oracles while they
    run; returns (cases, oracles, per-rank results)."""
    root = tmp_path_factory.mktemp("ranks")
    cases = _inputs(root)
    inputs = str(root / "inputs.pt")
    torch.save(cases, inputs)
    spawn = mp.get_context("spawn")
    procs = [spawn.Process(target=_ranks_worker.run,
                           args=(r, N_RANKS, f"file://{root}/store", inputs,
                                 str(root)))
             for r in range(N_RANKS)]
    for p in procs:
        p.start()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)    # beside the ranks and the other workers
    try:
        refs = {"collectives": _jax_collectives(cases["collectives"])}
        for name, case in cases.items():
            if case["kind"] == "model":
                refs[name] = _repeated(case)
                if name in JAX_CASES:
                    refs[f"jax_{name}"] = _jax_model(dict(case, name=name))
            elif case["kind"] == "psum_tree":
                refs[name] = _jax_psum_tree(case)
            elif case["kind"] == "train":
                refs[name] = _train_repeated(case)
    finally:
        torch.set_num_threads(threads)
        deadline = time.monotonic() + WORLD_TIMEOUT
        for p in procs:
            p.join(max(deadline - time.monotonic(), 0.0))
            if p.is_alive():
                p.terminate()
                p.join()
    codes = [p.exitcode for p in procs]
    assert codes == [0] * N_RANKS, f"rank exit codes {codes}"
    ranks = [torch.load(root / f"rank{r}.pt", weights_only=False)
             for r in range(N_RANKS)]
    for r, res in enumerate(ranks):
        for name, out in res.items():
            assert "error" not in out, f"rank {r}, {name}:\n{out['error']}"
        assert set(res) == set(cases), f"rank {r} ran {sorted(res)}"
    return dict(cases=cases, refs=refs, ranks=ranks, root=root)


# ---------------------------------------------------------------- tests


@pytest.mark.parametrize("op", ["psum_model", "psum_all", "pmean_data",
                                "gather_model", "scatter_data",
                                "pmax_model"])
def test_collective_and_its_gradient_match_jax(world, op):
    """Each rank's output and input gradient are its blocks of
    ``jax.lax``'s under ``shard_map`` (P("data", "model") in and out):
    the backward of psum is psum, of the tiled gather a reduce-scatter and
    back; pmax has no gradient, in JAX either."""
    want = world["refs"]["collectives"][op]
    for r, res in enumerate(world["ranks"]):
        got = res["collectives"][op]
        for key in want:
            blk = _block(want[key], ("data", "model"), (2, 2), r)
            assert got[key].shape == blk.shape, (op, key)
            np.testing.assert_allclose(got[key].numpy(), blk.numpy(),
                                       rtol=1e-6, atol=1e-6)


def test_collectives_count_their_bytes(world):
    """A psum of 6 floats over 2 ranks and a gather of (4, 3) blocks over
    2: payload 24 and 96 bytes, ring wire 24 and 48."""
    got = world["ranks"][0]["collectives"]["bytes"]
    assert got["payload"] == {"all-reduce": 24, "all-gather": 96,
                              "reduce-scatter": 0}
    assert got["wire"] == {"all-reduce": 24.0, "all-gather": 48.0,
                           "reduce-scatter": 0.0}


@pytest.mark.parametrize("shape", ["4x1", "2x2"])
def test_compressed_psum_tree_over_ranks(world, shape):
    """Each rank's reduced tree and residual against JAX's under
    ``shard_map`` and against the repeated-device port's list form,
    within 1e-6 of max |g|."""
    name = f"psum_tree_{shape}"
    case = world["cases"][name]
    deq_j, res_j = world["refs"][name]
    deq_p, res_p = compression.compressed_psum_tree(
        [{n: torch.from_numpy(a[i]) for n, a in case["g"].items()}
         for i in range(4)],
        [{n: torch.from_numpy(a[i]) for n, a in case["r"].items()}
         for i in range(4)], case["axes"], _mesh(case["shape"]))
    for r, res in enumerate(world["ranks"]):
        got = res[name]
        for n in case["g"]:
            scale = np.abs(case["g"][n]).max()
            for want in (deq_j[n][r], deq_p[r][n].numpy()):
                assert np.abs(got["deq"][n].numpy() - want).max() \
                    <= 1e-6 * scale
            for want in (res_j[n][r], res_p[r][n].numpy()):
                assert np.abs(got["res"][n].numpy() - want).max() \
                    <= 1e-6 * scale


def _logits_spec(cfg, shape, batch):
    rows = ("data",) if batch % shape[0] == 0 else None
    vocab = "model" if shape[1] > 1 and cfg.vocab_size % shape[1] == 0 \
        else None
    return (rows, None, vocab)


def _cache_spec(full, local, rows):
    """A cache leaf's placement from its whole and local shapes."""
    return (rows,) + tuple("model" if f != lo else None
                           for f, lo in zip(full[1:], local[1:]))


@pytest.mark.parametrize("name", list(MODEL_CASES))
def test_rank_blocks_match_the_repeated_mesh(world, name):
    """Logits, loss, aux and every gradient: each rank's block within
    1e-5 of max |·| of the repeated-device run's; each parameter's shape
    its ``shard_shape``."""
    case, ref = world["cases"][name], world["refs"][name]
    shape, cfg = case["shape"], case["cfg"]
    lspec = _logits_spec(cfg, shape, BATCH)
    for r, res in enumerate(world["ranks"]):
        got = res[name]
        assert _rel(got["logits"], _block(ref["logits"], lspec, shape, r),
                    ref["logits"]) <= RANK_TOL
        assert abs(got["loss"] - ref["loss"]) <= RANK_TOL * ref["loss"]
        assert abs(got["aux"] - ref["aux"]) <= RANK_TOL * max(ref["aux"],
                                                               1e-30)
        for n, g in ref["grads"].items():
            want = _block(g, ref["pspecs"][n], shape, r)
            assert got["shapes"][n] == tuple(want.shape), n
            assert _rel(got["grads"][n], want, g) <= RANK_TOL, n


@pytest.mark.parametrize("name", [n for n, c in MODEL_CASES.items() if c[5]])
def test_rank_prefill_and_decode_match_the_repeated_mesh(world, name):
    """Prefill and 2 decode steps: logits and the cache after them, each
    rank's block within 1e-5 of the repeated-device run's; the cache holds
    this rank's heads or channels."""
    case, ref = world["cases"][name], world["refs"][name]
    shape, cfg = case["shape"], case["cfg"]
    lspec = _logits_spec(cfg, shape, BATCH)
    for r, res in enumerate(world["ranks"]):
        got = res[name]
        assert _rel(got["prefill"], _block(ref["prefill"], lspec, shape, r),
                    ref["prefill"]) <= RANK_TOL
        for g, w in zip(got["decode"], ref["decode"]):
            assert _rel(g, _block(w, lspec, shape, r), w) <= RANK_TOL
        for gl, wl in zip(got["cache_after"]["groups"],
                          ref["cache_after"]["groups"]):
            for key, want in wl.items():
                spec = _cache_spec(want.shape, gl[key].shape, ("data",))
                # KV replicated (the query heads over "model", padded or
                # not) or attention split nowhere: the cache holds every kv
                # head; else the head dim or the mixer's channels split
                split = 0 if name in ("dense_gqa_padded", "dense_mha_padded",
                                      "dense_width_vocab",
                                      "dense_unsplit_heads") else 1
                assert spec.count("model") == split, (key, spec)
                assert _rel(gl[key], _block(want, spec, shape, r), want) \
                    <= RANK_TOL, key
        assert got["cache_after"]["pos"] == SEQ + N_DECODE


@pytest.mark.parametrize("name", JAX_CASES)
def test_one_case_of_each_family_matches_jax(world, name):
    """Rank 0's logits block, the loss, aux and each rank's gradient
    blocks against JAX under the case's mesh, within 1e-4."""
    case, want = world["cases"][name], world["refs"][f"jax_{name}"]
    shape, cfg = case["shape"], case["cfg"]
    pspecs = world["refs"][name]["pspecs"]
    n_layers = cfg.n_layers
    for r, res in enumerate(world["ranks"]):
        got = res[name]
        assert _rel(got["logits"], _block(
            want["logits"], _logits_spec(cfg, shape, BATCH), shape, r),
            want["logits"]) <= RTOL
        assert abs(got["loss"] - want["loss"]) <= RTOL * want["loss"]
        if name.startswith("moe"):
            assert abs(got["aux"] - want["aux"]) <= RTOL * want["aux"]
        for jname, g in flatten(want["grads"]):
            head, _, rest = jname.partition(".")
            if head == "groups":
                for i in range(n_layers):
                    port = f"groups.{i}.{rest}"
                    assert _rel(got["grads"][port], _block(
                        g[i], pspecs[port], shape, r), g) <= RTOL, port
            else:
                assert _rel(got["grads"][jname], _block(
                    g, pspecs[jname], shape, r), g) <= RTOL, jname


@pytest.mark.parametrize("case", list(MOE))
def test_moe_ranks_keep_the_same_pairs(world, case):
    """One MoE layer: every rank's output (summed over ``"model"``,
    gathered over the data axes) keeps exactly the (token, expert) pairs
    the repeated-device port keeps, with the same drops per data shard,
    within 1e-5 of its output; for the case of ``JAX_CASES``, the pairs
    JAX's ``shard_map`` keeps too (``tests/test_torch_mesh.py`` holds the
    repeated-device port's pairs to JAX's in every case)."""
    shape, fsdp, e = MOE[case]
    inp = world["cases"][f"pairs_{case}"]
    cfg = inp["cfg"]
    with blocks.routing_stats() as stats:
        out_p, _ = blocks.moe_apply(
            types.SimpleNamespace(**{n: torch.from_numpy(a)
                                     for n, a in inp["p"].items()}),
            torch.from_numpy(inp["x"]), cfg,
            MeshCtx.from_mesh(_mesh(shape), fsdp=fsdp))
    out_p = out_p[0]
    want = _kept(out_p, e)
    assert len(want) < 32 * cfg.top_k                # some pairs dropped
    if f"moe_{case}" in JAX_CASES:
        jcfg = _cfgs("mixtral-8x7b", n_layers=2, n_experts=e,
                     capacity_factor=1.0)[0]
        jmesh = _jmesh(shape)
        jctx = JMeshCtx.from_mesh(jmesh, fsdp=fsdp)
        with jmesh:
            out_j, _ = jax.jit(lambda p, x: jblocks.moe_apply(
                p, x, jcfg, jctx))(jax.tree.map(jnp.asarray, inp["p"]),
                                   jnp.asarray(inp["x"]))
        assert _kept(np.asarray(out_j)[0], e) == want
    dropped = {(r["data_shard"], r["experts"]): int(r["dropped"])
               for r in stats}
    ranks = {}
    for res in world["ranks"]:
        got = res[f"pairs_{case}"]
        assert _kept(got["out"][0], e) == want
        assert _rel(got["out"][0], out_p) <= RANK_TOL
        for d, ex, n in got["dropped"]:
            ranks[(d, tuple(ex))] = n
    assert ranks == dropped


@pytest.mark.parametrize("mode", [m[0] for m in TRAIN_MODES])
def test_adamw_steps_under_fsdp_match_the_repeated_mesh(world, mode):
    """3 AdamW steps on a (2, 2) world with FSDP and remat (plain, with
    ``compress_grads``, in 2 microbatches): each step's loss within 1e-5 of the
    repeated-device run's, and the first step's grad norm.  (AdamW turns
    a gradient's float32 noise into a step of up to lr where the gradient
    is ~0, as the k biases' is, so later norms and weights drift by more
    and are not held.)"""
    name = f"train_{mode}"
    ref = world["refs"][name]
    assert ref["losses"][-1] < ref["losses"][0]
    for res in world["ranks"]:
        got = res[name]
        assert len(got["losses"]) == TRAIN_STEPS
        for g, w in zip(got["losses"], ref["losses"]):
            assert abs(g - w) <= RANK_TOL * w
        assert abs(got["norms"][0] - ref["norms"][0]) \
            <= RANK_TOL * ref["norms"][0]


def test_checkpoint_restores_across_worlds(world):
    """A checkpoint written by the (2, 2) world holds the whole logical
    arrays: one process restores them, and their blocks equal the (2, 2)
    ranks' parameters and moments and what the (1, 4) world restored, bit
    for bit."""
    cfg = world["cases"]["checkpoint"]["cfg"]
    mgr = CheckpointManager(str(world["root"] / "ckpt"))
    assert mgr.all_steps()[-1] == 2
    net = Model(cfg, device="cpu")
    opt = adamw()
    state = mgr.restore(2, {"params": dict(net.named_parameters()),
                            "opt": opt[0](net)}, "cpu")
    for shape in ((2, 2), (1, 4)):
        pspecs = _pspecs(cfg, shape, shape == (2, 2))
        for r, res in enumerate(world["ranks"]):
            got = res["checkpoint"][shape]
            assert got["start"] == (0 if shape == (2, 2) else 2)
            for n, t in state["params"].items():
                assert torch.equal(got["params"][n],
                                   _block(t, pspecs[n], shape, r)), n
            for n, t in state["opt"].mu.items():
                first = next(p for p in pspecs if p == n or p.replace(
                    ".0.", ".", 1) == n)
                spec = pspecs[first]
                spec = ((None,) + spec) if t.ndim > len(spec) else spec
                assert torch.equal(got["mu"][n], _block(t, spec, shape, r)), n


@pytest.mark.parametrize("name", list(MODEL_CASES))
def test_each_rank_holds_only_its_blocks(world, name):
    """Each rank's parameter bytes equal the per-device argument bytes of
    the dry run's placements at the same mesh
    (``launch/specs.py`` ``param_specs_sharded``)."""
    case = world["cases"][name]
    ctx = MeshCtx.from_mesh(Mesh(case["shape"], AXES,
                                 ["meta"] * N_RANKS), fsdp=case["fsdp"])
    placed = specmod.param_specs_sharded(Model(case["cfg"], ctx,
                                               device="meta"))
    want = sum(p.local_nbytes for p in placed.values())
    full = sum(p.tensor.numel() * p.tensor.element_size()
               for p in placed.values())
    for res in world["ranks"]:
        assert res[name]["param_bytes"] == want < full


def test_rank_meshes_refuse_what_they_do_not_run(world):
    """``hybrid``, ``audio`` and ``vlm`` on a rank mesh raise naming ROADMAP
    item 8b, Adafactor item 8c (the repeated-device mesh runs them, as
    ``tests/test_torch_mesh.py`` and the families' tests show)."""
    for res in world["ranks"]:
        got = res["refusals"]
        for fam in ("hybrid", "audio", "vlm"):
            assert got[fam][0] == "NotImplementedError" and \
                "item 8b" in got[fam][1], fam
        assert got["adafactor"][0] == "NotImplementedError" and \
            "item 8c" in got["adafactor"][1]


def test_a_shared_card_needs_gloo_and_the_launcher_its_world(
        tmp_path, monkeypatch):
    """Ranks sharing one CUDA device without ``backend="gloo"`` raise
    before any process group starts; a world of 4 asked for ``--mesh
    16x16`` raises naming 256 ranks; a world of another size than the
    mesh's too."""
    with pytest.raises(ValueError, match="gloo"):
        init_world((1, 2), AXES, device="cuda:0", rank=1,
                   init_method=f"file://{tmp_path}/store")
    with pytest.raises(ValueError, match="gloo"):
        init_world((1, 2), AXES, device="cuda:0", rank=0, backend="nccl",
                   init_method=f"file://{tmp_path}/store")
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("RANK", "0")
    with pytest.raises(ValueError, match="256 ranks"):
        launch_train.main(["--arch", "qwen2-1.5b", "--mesh", "16x16",
                           "--reduced", "--device", "cpu"])
    with pytest.raises(ValueError, match="needs 2 ranks"):
        init_world((1, 2), AXES, device="cpu")


def test_wire_bytes_beside_their_price(world):
    """One (2, 2) training step's collective bytes by kind, beside
    ``plan_cost.price_lm_step``'s wire bytes at the same mesh (printed by
    this file's ``__main__``): the all-reduce and the FSDP gather and
    reduce-scatter each moved bytes, the same on every rank."""
    got = [res["train_plain"]["wire"][0] for res in world["ranks"]]
    assert all(g == got[0] for g in got)
    assert all(got[0][k] > 0 for k in ("all-reduce", "all-gather",
                                       "reduce-scatter"))


def _wire_report():
    """Spawn a world of 4 ranks, run one (2, 2) FSDP training step and
    print its wire bytes by kind beside the priced ones."""
    import tempfile

    from repro_torch.distributed import plan_cost
    with tempfile.TemporaryDirectory() as d:
        from pathlib import Path
        root = Path(d)
        case = _inputs(root)["train_plain"]
        case = dict(case, batches=case["batches"][:1])
        inputs = str(root / "inputs.pt")
        torch.save({"train_plain": case}, inputs)
        spawn = mp.get_context("spawn")
        procs = [spawn.Process(target=_ranks_worker.run,
                               args=(r, N_RANKS, f"file://{root}/store",
                                     inputs, str(root)))
                 for r in range(N_RANKS)]
        for p in procs:
            p.start()
        for p in procs:
            p.join()
        got = torch.load(root / "rank0.pt", weights_only=False)
    wire = got["train_plain"]["wire"][0]
    cfg = case["cfg"]
    ctx = MeshCtx.from_mesh(_mesh((2, 2)), fsdp=True)
    priced = plan_cost.price_lm_step(cfg, ctx, "train", 4, 8).wire
    names = {"all-reduce": "all-reduce", "all-gather": "all-gather",
             "reduce-scatter": "reduce-scatter"}
    for kind in sorted(set(names) | set(priced)):
        m, pr = wire.get(kind, 0.0), priced.get(kind, 0.0)
        ratio = m / pr if pr else float("nan")
        print(f"{kind:15s} measured {m:12.0f}  priced {pr:12.0f}  "
              f"measured/priced {ratio:.3f}")


if __name__ == "__main__":
    _wire_report()
