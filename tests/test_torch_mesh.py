"""The port's LM under a mesh held against the JAX package, on the CPU.

The reference computes differently under a mesh: query heads padded where
the ``"model"`` axis does not divide them (their k and v by
``_kv_index``), and the MoE run per shard under ``shard_map`` (each data
shard's own capacity, rounded up to 8; experts or their width split over
``"model"``; the psum of the partial outputs; the aux loss's pmean).  The
JAX side runs on a ``jax.sharding.Mesh`` of the 4 CPU devices
(``tests/conftest.py``; Auto axes: ``jax.make_mesh``'s Explicit axes make
the reference's ``with_sharding_constraint`` raise), the port on a
:class:`~repro_torch.distributed.sharding.Mesh` of the same shape over
``[cpu] * 4``; JAX's weights go to the port through
``convert.model_from_numpy(..., ctx=)`` (the padded ``wq``, ``wo``, ``bq``
included).  Logits, loss and aux are held to 1e-4 of max |JAX| (the
acceptance bound is 1e-3), gradients to 1e-4 of max |JAX leaf|, the MoE's
kept (token, expert) pairs exactly.  Also: ``compressed_psum_tree``
against JAX's under ``shard_map``, ``NamedSharding.block`` against the
shards JAX places, the meshes' refusals, ``TrainLoop(shardings=)`` and
``launch.train --mesh 1x1``.
"""
import dataclasses
import os
import shutil
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

os.environ.setdefault("JAX_PLATFORMS", "cpu")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh as JMesh  # noqa: E402
from jax.sharding import NamedSharding as JSharding  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.distributed import compression as jcompression  # noqa: E402
from repro.distributed.context import MeshCtx as JMeshCtx  # noqa: E402
from repro.models import params as jparams  # noqa: E402
from repro.models import blocks as jblocks  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro_torch import configs, convert  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.distributed import compression  # noqa: E402
from repro_torch.distributed.context import MeshCtx  # noqa: E402
from repro_torch.distributed.sharding import (  # noqa: E402
    Mesh, NamedSharding, param_shardings)
from repro_torch.launch import mesh as launch_mesh  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import blocks  # noqa: E402
from repro_torch.models.params import flatten  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.train import TrainLoop, TrainLoopConfig  # noqa: E402
from repro_torch.train import make_train_step  # noqa: E402

CPU = torch.device("cpu")
RTOL = 1e-4            # max |Δ| / max |JAX|, float32
BATCH, SEQ, N_DECODE = 2, 20, 2
# the head layouts under a (1, 4) mesh: (n_heads, n_kv_heads, pad_heads)
HEADS = {"gqa_padded": (6, 2, True),      # 6 → 8 query heads, KV replicated
         "mha_padded": (5, 5, True),      # 5 → 8
         "head_dim_tp": (6, 2, False)}    # head dim over "model"
# the MoE cases: (mesh, FSDP, experts): EP with two data shards, the same
# with FSDP, and 6 experts over 4 model shards (their width split)
MOE = {"ep_2x2": ((2, 2), False, 8), "ep_2x2_fsdp": ((2, 2), True, 8),
       "width_1x4": ((1, 4), False, 6)}


def _rel(got, want) -> float:
    if isinstance(got, torch.Tensor):
        got = got.detach()
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def _meshes(shape):
    """(JAX Mesh of the first CPU devices, the port's Mesh over [cpu])."""
    n = int(np.prod(shape))
    jmesh = JMesh(np.asarray(jax.devices()[:n]).reshape(shape),
                  ("data", "model"))
    return jmesh, Mesh(shape, ("data", "model"), [CPU] * n)


def _draw(jm, seed):
    """The JAX model's parameter tree drawn with numpy from its specs
    (N(0, scale²), zeros, ones), the norm scales, biases and routers
    (zero or tiny at init) redrawn, the router at 1/√d so that routing
    margins stand far above float32 rounding."""
    jcfg = jm.cfg
    rng = np.random.default_rng(seed)

    def init(spec):
        if spec.init in ("zeros", "ones"):
            return np.full(spec.shape, float(spec.init == "ones"), np.float32)
        assert spec.init == "normal", spec.init
        return (spec.scale * rng.standard_normal(spec.shape)).astype(
            np.float32)

    def leaf(path, a):
        name = jax.tree_util.keystr(path)
        a = np.asarray(a)
        if "'scale'" in name or "'b" in name.split("][")[-1]:
            return 0.1 * rng.standard_normal(a.shape).astype(np.float32)
        if "'router'" in name:
            return (rng.standard_normal(a.shape)
                    / np.sqrt(jcfg.d_model)).astype(np.float32)
        return a

    return jax.tree_util.tree_map_with_path(
        leaf, jparams.map_specs(init, jm.param_specs()))


def _port_grads(model, batch):
    loss, metrics = model.loss(batch)
    named = dict(model.named_parameters())
    return loss, metrics, dict(zip(named, torch.autograd.grad(
        loss, list(named.values()))))


def _check_grads(got, grads, n_layers):
    for name, want in flatten(grads):
        head, _, rest = name.partition(".")
        g = got[name] if head != "groups" else torch.stack(
            [got[f"groups.{i}.{rest}"] for i in range(n_layers)])
        assert _rel(g, want) <= RTOL, name


# ---------------------------------------------------------------- heads


def _head_cfgs(case):
    h, kv, pad = HEADS[case]
    return tuple(dataclasses.replace(c.get("qwen2-1.5b").reduced(),
                                     n_layers=2, n_heads=h, n_kv_heads=kv,
                                     head_dim=16, pad_heads=pad)
                 for c in (jconfigs, configs))


@pytest.fixture(scope="module", params=list(HEADS))
def heads_ref(request):
    """The JAX model under a (1, 4) mesh: weights, forward, loss and its
    gradients, prefill and two decodes (one compiled program)."""
    case = request.param
    jcfg, _ = _head_cfgs(case)
    jmesh, _ = _meshes((1, 4))
    jm = JModel(jcfg, JMeshCtx.from_mesh(jmesh))
    params = _draw(jm, 3)
    rng = np.random.default_rng(4)
    tokens = rng.integers(0, jcfg.vocab_size, (BATCH, SEQ + 1))
    batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
    steps = rng.integers(0, jcfg.vocab_size, (N_DECODE, BATCH, 1))

    def run(p, b, steps):
        out = {"forward": jm.forward(p, b["tokens"])[0]}
        (loss, _), grads = jax.value_and_grad(jm.loss, has_aux=True)(p, b)
        logits, cache = jm.prefill(p, b["tokens"])
        out["prefill"], out["cache_k"] = logits, cache["groups"]["k"]
        out["decode"] = []
        for tok in steps:
            step, cache = jm.decode(p, cache, tok)
            out["decode"].append(step)
        return loss, grads, out

    with jmesh:
        loss, grads, out = jax.jit(run)(
            jax.tree.map(jnp.asarray, params),
            jax.tree.map(jnp.asarray, batch), jnp.asarray(steps))
    return dict(case=case, params=params, batch=batch, steps=steps,
                loss=float(loss), grads=jax.tree.map(np.asarray, grads),
                out=jax.tree.map(np.asarray, out))


def test_padded_heads_and_their_kv_map(heads_ref):
    """The padded head count, the layout and the kv map equal the
    reference's (``_kv_index``: padded heads read the last real head's
    group); ``wq``, ``wo`` and ``bq`` carry the padded count."""
    jcfg, cfg = _head_cfgs(heads_ref["case"])
    jmesh, mesh = _meshes((1, 4))
    jctx, ctx = JMeshCtx.from_mesh(jmesh), MeshCtx.from_mesh(mesh)
    assert blocks._padded_heads(cfg, ctx) == jblocks._padded_heads(jcfg,
                                                                   jctx)
    assert blocks._attn_layout(cfg, ctx) == jblocks._attn_layout(jcfg, jctx)
    assert blocks._kv_index(cfg, ctx) == list(jblocks._kv_index(jcfg, jctx))
    model = convert.model_from_numpy(cfg, heads_ref["params"], ctx=ctx)
    hp = blocks._padded_heads(cfg, ctx)
    assert model.groups[0].attn.wq.shape[1] == hp
    assert model.groups[0].attn.wo.shape[0] == hp
    assert model.groups[0].attn.bq.shape[0] == hp
    assert model.device == CPU and model.ctx is ctx


def test_padded_heads_forward_prefill_decode_match_jax(heads_ref):
    _, cfg = _head_cfgs(heads_ref["case"])
    ctx = MeshCtx.from_mesh(_meshes((1, 4))[1])
    model = convert.model_from_numpy(cfg, heads_ref["params"], ctx=ctx)
    want = heads_ref["out"]
    tokens = heads_ref["batch"]["tokens"]
    with torch.no_grad():
        assert _rel(model(tokens)[0], want["forward"]) <= RTOL
    logits, cache = model.prefill(tokens)
    assert _rel(logits, want["prefill"]) <= RTOL
    k = torch.stack([c["k"] for c in cache["groups"]])
    assert k.shape[3] == cfg.n_kv_heads          # the cache keeps KV heads
    assert _rel(k, want["cache_k"]) <= RTOL
    for tok, step_want in zip(heads_ref["steps"], want["decode"]):
        step, cache = model.decode(cache, tok)
        assert _rel(step, step_want) <= RTOL


def test_padded_heads_loss_and_gradients_match_jax(heads_ref):
    _, cfg = _head_cfgs(heads_ref["case"])
    ctx = MeshCtx.from_mesh(_meshes((1, 4))[1])
    model = convert.model_from_numpy(cfg, heads_ref["params"], ctx=ctx)
    loss, _, got = _port_grads(model, heads_ref["batch"])
    assert abs(float(loss.detach()) - heads_ref["loss"]) \
        <= RTOL * heads_ref["loss"]
    _check_grads(got, heads_ref["grads"], cfg.n_layers)


def test_padded_heads_with_zero_rows_compute_the_unpadded_model(heads_ref):
    """The padded heads' ``wo`` rows zeroed, the model over the mesh gives
    the logits of the unsharded model carrying the real heads' weights
    (within float32 rounding: attention over more heads sums in another
    order); with the head dim over ``"model"`` nothing is padded, and the
    two are the same bits."""
    case = heads_ref["case"]
    _, cfg = _head_cfgs(case)
    ctx = MeshCtx.from_mesh(_meshes((1, 4))[1])
    padded = convert.model_from_numpy(cfg, heads_ref["params"], ctx=ctx)
    h = cfg.n_heads
    named = dict(padded.named_parameters())
    with torch.no_grad():
        for name, t in named.items():
            if name.endswith("attn.wo"):
                t[h:] = 0
    real = {n: (t[:, :h] if n.endswith("attn.wq") else
                t[:h] if n.endswith(("attn.wo", "attn.bq")) else t)
            for n, t in named.items()}
    from repro_torch.models import Model
    plain = Model(cfg, device="cpu", params=real)
    tokens = heads_ref["batch"]["tokens"]
    with torch.no_grad():
        got, want = padded(tokens)[0], plain(tokens)[0]
    if HEADS[case][2]:
        assert _rel(got, want) <= 1e-5
    else:
        assert torch.equal(got, want)


# ---------------------------------------------------------------- MoE


def _moe_cfgs(case, capacity_factor=1.0):
    _, fsdp, e = MOE[case]
    return tuple(dataclasses.replace(c.get("mixtral-8x7b").reduced(),
                                     n_layers=2, n_experts=e,
                                     capacity_factor=capacity_factor)
                 for c in (jconfigs, configs))


@pytest.fixture(scope="module", params=list(MOE))
def moe_ref(request):
    """The reduced Mixtral under the case's mesh in JAX (capacity 1.0, so
    that choices drop): loss, aux and gradients on a numpy batch."""
    case = request.param
    shape, fsdp, _ = MOE[case]
    jcfg, _ = _moe_cfgs(case)
    jmesh, _ = _meshes(shape)
    jm = JModel(jcfg, JMeshCtx.from_mesh(jmesh, fsdp=fsdp))
    params = _draw(jm, 5)
    tokens = np.random.default_rng(6).integers(0, jcfg.vocab_size,
                                               (BATCH, SEQ + 1))
    batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
    with jmesh:
        (loss, metrics), grads = jax.jit(jax.value_and_grad(
            jm.loss, has_aux=True))(jax.tree.map(jnp.asarray, params),
                                    jax.tree.map(jnp.asarray, batch))
    return dict(case=case, params=params, batch=batch, loss=float(loss),
                aux=float(metrics["aux"]),
                grads=jax.tree.map(np.asarray, grads))


def test_moe_under_a_mesh_loss_aux_and_gradients_match_jax(moe_ref):
    case = moe_ref["case"]
    shape, fsdp, _ = MOE[case]
    _, cfg = _moe_cfgs(case)
    ctx = MeshCtx.from_mesh(_meshes(shape)[1], fsdp=fsdp)
    model = convert.model_from_numpy(cfg, moe_ref["params"], ctx=ctx)
    with blocks.routing_stats() as stats:
        loss, metrics, got = _port_grads(model, moe_ref["batch"])
    assert abs(float(loss.detach()) - moe_ref["loss"]) \
        <= RTOL * moe_ref["loss"]
    aux = float(metrics["aux"].detach())
    assert abs(aux - moe_ref["aux"]) <= RTOL * moe_ref["aux"]
    _check_grads(got, moe_ref["grads"], cfg.n_layers)
    # one record per layer, data shard and model shard; choices dropped
    assert len(stats) == cfg.n_layers * shape[0] * shape[1]
    assert {(r["data_shard"], r["model_shard"]) for r in stats} == {
        (i, m) for i in range(shape[0]) for m in range(shape[1])}
    assert sum(int(r["dropped"]) for r in stats) > 0


@pytest.mark.parametrize("case", list(MOE))
def test_moe_under_a_mesh_keeps_jaxs_pairs(case):
    """One MoE layer on tokens routed mostly to two experts: expert e
    writes only columns [8e, 8e + 8) (its ``wo`` zero elsewhere), so the
    output shows which (token, expert) pairs each path kept; the port's
    equal JAX's ``shard_map``'s, and so does its count of dropped
    pairs."""
    shape, fsdp, e = MOE[case]
    jcfg, cfg = _moe_cfgs(case, capacity_factor=1.0)
    jmesh, mesh = _meshes(shape)
    rng = np.random.default_rng(8)
    t, d, f, k = 32, cfg.d_model, cfg.moe_d_ff, cfg.top_k
    # every token's x[0] is 1 and experts 0 and 1 gain 3 on it: they take
    # most choices, over any data shard's capacity
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
    jctx = JMeshCtx.from_mesh(jmesh, fsdp=fsdp)
    with jmesh:
        out_j, aux_j = jax.jit(lambda p, x: jblocks.moe_apply(
            p, x, jcfg, jctx))(jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    out_j = np.asarray(out_j)[0]
    with blocks.routing_stats() as stats:
        out, aux = blocks.moe_apply(
            types.SimpleNamespace(**{n: torch.from_numpy(a)
                                     for n, a in p.items()}),
            torch.from_numpy(x), cfg, MeshCtx.from_mesh(mesh, fsdp=fsdp))
    out = out[0]

    def kept(o):
        return {(i, j) for i in range(t) for j in range(e)
                if np.abs(np.asarray(o)[i, 8 * j:8 * j + 8]).max() > 0}

    assert kept(out) == kept(out_j)
    dropped = {(r["data_shard"], r["experts"]): int(r["dropped"])
               for r in stats}
    assert sum(dropped.values()) == t * k - len(kept(out_j))
    assert len(kept(out_j)) < t * k                 # some pairs dropped
    assert _rel(out, out_j) <= RTOL
    assert abs(float(aux) - float(aux_j)) <= RTOL * float(aux_j)


# ---------------------------------------------------------------- int8 psum


@pytest.mark.parametrize("shape,axes", [((4, 1), ("data",)),
                                        ((2, 2), ("data", "model"))])
def test_compressed_psum_tree_matches_jax(shape, axes):
    """Four positions' gradient trees (and residuals) reduced by JAX under
    ``shard_map`` and by the port, position by position: the reduced
    trees and each position's residual within 1e-6 of max |g|."""
    rng = np.random.default_rng(9)
    shapes = {"w": (6, 5), "b": (7,)}
    g = {n: rng.standard_normal((4,) + s).astype(np.float32)
         for n, s in shapes.items()}
    r = {n: 0.01 * rng.standard_normal((4,) + s).astype(np.float32)
         for n, s in shapes.items()}
    jmesh, mesh = _meshes(shape)
    spec = P(axes)

    def fn(gl, rl):
        gl = {n: a[0] for n, a in gl.items()}
        rl = {n: a[0] for n, a in rl.items()}
        d, res = jcompression.compressed_psum_tree(gl, rl, axes)
        return ({n: a[None] for n, a in d.items()},
                {n: a[None] for n, a in res.items()})

    smap = getattr(jax, "shard_map", None)
    if smap is None:
        from jax.experimental.shard_map import shard_map as smap
    deq_j, res_j = jax.jit(smap(fn, mesh=jmesh, in_specs=(spec, spec),
                                out_specs=(spec, spec)))(g, r)
    deq, res = compression.compressed_psum_tree(
        [{n: torch.from_numpy(a[i]) for n, a in g.items()} for i in range(4)],
        [{n: torch.from_numpy(a[i]) for n, a in r.items()} for i in range(4)],
        axes, mesh)
    for n in shapes:
        scale = np.abs(g[n]).max()
        for i in range(4):
            assert np.abs(deq[i][n].numpy() - np.asarray(deq_j[n])[i]).max() \
                <= 1e-6 * scale
            assert np.abs(res[i][n].numpy() - np.asarray(res_j[n])[i]).max() \
                <= 1e-6 * scale
    with pytest.raises(ValueError, match="positions"):
        compression.compressed_psum_tree(deq[:3], res[:3], axes, mesh)


# ---------------------------------------------------------------- placement


@pytest.mark.parametrize("spec", [("data", "model"), (("data", "model"),),
                                  (None, "model"), ("model", "data"), ()])
def test_block_is_the_shard_jax_places(spec):
    """``NamedSharding.block`` at each coordinate of a (2, 2) mesh is the
    shard JAX's ``device_put`` puts on the device there, and
    ``shard_shape`` its shape."""
    jmesh, mesh = _meshes((2, 2))
    x = np.arange(8 * 12, dtype=np.float32).reshape(8, 12)
    placed = jax.device_put(x, JSharding(jmesh, P(*spec)))
    sh = NamedSharding(mesh, spec)
    assert sh.shard_shape(x.shape) == JSharding(jmesh, P(*spec)).shard_shape(
        x.shape)
    by_device = {s.device: np.asarray(s.data)
                 for s in placed.addressable_shards}
    for idx in np.ndindex(2, 2):
        coord = dict(zip(mesh.axis_names, idx))
        want = by_device[jmesh.devices[idx]]
        np.testing.assert_array_equal(sh.block(torch.from_numpy(x),
                                               coord).numpy(), want)
    with pytest.raises(ValueError, match="divisible"):
        NamedSharding(mesh, ("data",)).shard_shape((3, 4))


def test_meshes_refuse_what_is_not_there():
    """On a machine without CUDA devices the production meshes raise,
    naming 256 and 512; ``devices="meta"`` builds them for the dry run;
    the debug mesh takes the caller's devices, repeats allowed, and
    without them raises for want of CUDA devices."""
    with pytest.raises(ValueError, match="256"):
        launch_mesh.make_production_mesh()
    with pytest.raises(ValueError, match="512"):
        launch_mesh.make_production_mesh(multi_pod=True)
    with pytest.raises(ValueError, match="256"):
        launch_mesh.make_production_mesh(devices=[CPU] * 4)
    m = launch_mesh.make_production_mesh(multi_pod=True, devices="meta")
    assert m.shape == {"pod": 2, "data": 16, "model": 16} and m.size == 512
    assert m.flat[0].type == "meta"
    d = launch_mesh.make_debug_mesh(2, 2, devices=[CPU] * 4)
    assert d.shape == {"data": 2, "model": 2} and d.flat == [CPU] * 4
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="CUDA"):
            launch_mesh.make_debug_mesh()
    with pytest.raises(ValueError, match="4 devices"):
        launch_mesh.make_debug_mesh(2, 2, devices=[CPU] * 3)
    ctx = MeshCtx.from_mesh(d)
    assert ctx.dp_axes == ("data",) and ctx.tp_size == 2
    assert ctx.sharding("data") == NamedSharding(d, ("data",))
    with pytest.raises(ValueError, match="first device"):
        from repro_torch.models import Model
        Model(configs.get("qwen2-1.5b").reduced(), ctx, device="meta")


# ---------------------------------------------------------------- training


def _tiny(arch="qwen2-1.5b"):
    return dataclasses.replace(configs.get(arch).reduced(), n_layers=2)


def test_train_loop_restores_onto_its_shardings(tmp_path):
    """Two steps under a (1, 4) mesh of the CPU, checkpointed; a new loop
    with the parameters' shardings restores them onto their placements
    (equal to the saved ones); a placement on another device, a name
    that is not a parameter's and a spec that does not fit its leaf are
    refused."""
    from repro_torch.models import Model
    cfg = _tiny()
    mesh = Mesh((1, 4), ("data", "model"), [CPU] * 4)
    ctx = MeshCtx.from_mesh(mesh)
    tokens = np.random.default_rng(11).integers(0, cfg.vocab_size, (2, 9))
    batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}

    def loop(model, shardings=None, steps=2):
        opt = adamw()
        return TrainLoop(TrainLoopConfig(total_steps=steps, ckpt_every=1,
                                         ckpt_dir=str(tmp_path), log_every=1),
                         make_train_step(model, opt), model, opt[0](model),
                         shardings=shardings)

    first = Model(cfg, ctx, generator=torch.Generator().manual_seed(0))
    shardings = param_shardings(first.param_specs(), ctx)
    loop(first, shardings).run(iter([batch] * 2))
    saved = {n: t.detach().clone() for n, t in first.named_parameters()}
    second = Model(cfg, ctx, generator=torch.Generator().manual_seed(1))
    resumed = loop(second, shardings)
    assert resumed.start_step == 2
    for n, t in second.named_parameters():
        assert torch.equal(t, saved[n]), n
    meta = Mesh((1, 4), ("data", "model"), ["meta"] * 4)
    with pytest.raises(ValueError, match="placed on meta"):
        loop(second, {n: NamedSharding(meta, s.spec)
                      for n, s in shardings.items()})
    with pytest.raises(ValueError, match="missing or unknown"):
        loop(second, dict(shardings, extra=shardings["embed"]))
    bad = dict(shardings, **{"final_norm.scale": NamedSharding(
        Mesh((1, 3), ("data", "model"), [CPU] * 3), ("model",))})
    with pytest.raises(ValueError, match="divisible"):
        loop(second, bad)


def test_launcher_resumes_under_a_1x1_mesh_bit_for_bit(tmp_path, capsys):
    """``launch.train --mesh 1x1 --reduced --device cpu``: 4 steps with a
    checkpoint every 2; a second run from the step-2 checkpoint alone
    (through ``TrainLoop(shardings=)``, the batches of the first two steps
    skipped) ends on the first run's step-4 loss bit for bit."""
    argv = ["--arch", "qwen2-1.5b", "--mesh", "1x1", "--reduced",
            "--device", "cpu", "--steps", "4", "--batch", "2", "--seq", "8",
            "--ckpt-every", "2"]
    first = launch_train.main(argv + ["--ckpt-dir", str(tmp_path / "a")])
    assert first["final_step"] == 4
    mgr = CheckpointManager(str(tmp_path / "a"))
    assert mgr.all_steps()[-2:] == [2, 4]
    shutil.copytree(mgr.step_dir(2), tmp_path / "b" / "step_000000000002")
    second = launch_train.main(argv + ["--ckpt-dir", str(tmp_path / "b")])
    assert second["final_step"] == 4
    assert second["log"][-1]["loss"] == first["log"][-1]["loss"]
    assert "final step 4" in capsys.readouterr().out
