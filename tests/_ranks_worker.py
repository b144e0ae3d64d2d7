"""The rank side of ``tests/test_torch_ranks.py`` (not a test module).

``run(rank, size, store, inputs, out)`` joins a gloo world of ``size`` CPU
processes through the ``file://`` store ``store``, runs every case of the
pickled ``inputs`` in order (each builds its mesh over the world) and
saves this rank's results by case name to ``out/rank<rank>.pt``.  A case
that raises records its traceback and ends the rank's run, so the test
names it.  Imports torch and ``repro_torch`` only.
"""
import os
import sys
import traceback
import types

import torch

from repro_torch import convert
from repro_torch.distributed import collectives as coll
from repro_torch.distributed import compression
from repro_torch.distributed.context import MeshCtx
from repro_torch.distributed.runtime import init_world
from repro_torch.distributed.sharding import NamedSharding, spec_pspec
from repro_torch.launch import mesh as launch_mesh
from repro_torch.models import Model, blocks
from repro_torch.optim import adafactor, adamw
from repro_torch.optim._tree import zeros_like_tree
from repro_torch.train import TrainLoop, TrainLoopConfig, make_train_step
from repro_torch.train.steps import loss_and_grads

CPU = torch.device("cpu")
AXES = ("data", "model")


class _World:
    """The world's meshes by shape (the process group is started once)."""

    def __init__(self, rank, size, store):
        self.rank, self.size, self.store = rank, size, store
        self.worlds = {}

    def ctx(self, shape, fsdp=False) -> MeshCtx:
        shape = tuple(shape)
        if shape not in self.worlds:
            self.worlds[shape] = init_world(shape, AXES, device=CPU,
                                            init_method=self.store,
                                            rank=self.rank)
        w = self.worlds[shape]
        return MeshCtx.from_mesh(launch_mesh.make_debug_mesh(*shape, world=w),
                                 fsdp=fsdp)


def _np(t):
    return t.detach().clone() if isinstance(t, torch.Tensor) else t


# ---------------------------------------------------------------- cases


def collectives(case, world):
    """Each collective on this rank's block of ``x`` (a (2, 2) mesh), and
    the gradient of Σ out · w (w's block of the output's placement)."""
    ctx = world.ctx((2, 2))
    w = ctx.world
    spec = NamedSharding(ctx.mesh, ("data", "model"))
    out = {}
    ops = {"psum_model": lambda x: coll.psum(x, "model", w),
           "psum_all": lambda x: coll.psum(x, ("data", "model"), w),
           "pmean_data": lambda x: coll.pmean(x, "data", w),
           "gather_model": lambda x: coll.all_gather(x, "model", w, axis=1),
           "scatter_data": lambda x: coll.psum_scatter(x, "data", w,
                                                       axis=0)}
    x_all = torch.from_numpy(case["x"])
    for name, fn in ops.items():
        x = spec.local(x_all).clone().requires_grad_(True)
        y = fn(x)
        cot = spec.local(torch.from_numpy(case["w"][name]))
        (y * cot).sum().backward()
        out[name] = dict(value=_np(y), grad=_np(x.grad))
    out["pmax_model"] = dict(value=coll.pmax(spec.local(x_all), "model", w))
    coll.reset_bytes()
    coll.psum(torch.ones(6), "model", w)
    coll.all_gather(torch.ones(4, 3), "data", w, axis=0)
    out["bytes"] = dict(payload=dict(coll.PAYLOAD), wire=dict(coll.WIRE))
    return out


def psum_tree(case, world):
    ctx = world.ctx(case["shape"])
    i = ctx.world.rank
    g = {n: torch.from_numpy(a[i]) for n, a in case["g"].items()}
    r = {n: torch.from_numpy(a[i]) for n, a in case["r"].items()}
    deq, res = compression.compressed_psum_tree(g, r, case["axes"], ctx.mesh)
    return dict(deq=deq, res=res)


def model(case, world):
    """Forward logits, loss, aux and every gradient of this rank; prefill
    and decode steps when the case has them; the bytes of its
    parameters; the MoE's routing records."""
    ctx = world.ctx(case["shape"], case.get("fsdp", False))
    net = convert.model_from_numpy(case["cfg"], case["params"], device="cpu",
                                   ctx=ctx)
    batch = case["batch"]
    out = dict(param_bytes=sum(p.numel() * p.element_size()
                               for p in net.parameters()),
               shapes={n: tuple(p.shape) for n, p in net.named_parameters()})
    with torch.no_grad():
        out["logits"] = net(batch["tokens"])[0]
    with blocks.routing_stats() as stats:
        loss, metrics, grads = loss_and_grads(net, batch)
    out.update(loss=float(loss), aux=float(metrics["aux"]), grads=grads,
               stats=[{k: (v.clone() if isinstance(v, torch.Tensor) else v)
                       for k, v in r.items()} for r in stats])
    if "steps" in case:
        logits, cache = net.prefill(batch["tokens"])
        out["prefill"], out["cache"] = logits, cache
        out["decode"] = []
        for tok in case["steps"]:
            logits, cache = net.decode(cache, tok)
            out["decode"].append(logits)
        out["cache_after"] = cache
    return out


def moe_pairs(case, world):
    """One MoE layer on the case's tokens: this rank's blocks of the
    weights, the output after the psum (and the gather)."""
    ctx = world.ctx(case["shape"], case["fsdp"])
    cfg = case["cfg"]
    specs = blocks.moe_spec(cfg, ctx)
    p = {n: NamedSharding(ctx.mesh, spec_pspec(specs[n], ctx)).local(
        torch.from_numpy(a)).clone() for n, a in case["p"].items()}
    with blocks.routing_stats() as stats:
        out, aux = blocks.moe_apply(types.SimpleNamespace(**p),
                                    torch.from_numpy(case["x"]), cfg, ctx)
    return dict(out=out, aux=float(aux),
                dropped=[(r["data_shard"], r["experts"], int(r["dropped"]))
                         for r in stats])


def train(case, world):
    """An AdamW step a batch (with ``compress_grads`` and ``microbatches``
    as the case asks) on the whole batches; the losses, grad norms and
    each step's collective bytes by kind."""
    ctx = world.ctx(case["shape"], case["fsdp"])
    net = convert.model_from_numpy(case["cfg"], case["params"], device="cpu",
                                   ctx=ctx)
    opt = adamw(lr=case["lr"])
    state = opt[0](net)
    if case["compress"]:
        state = (state, zeros_like_tree(net))
    step = make_train_step(net, opt, compress_grads=case["compress"],
                           microbatches=case["microbatches"])
    losses, norms, wire = [], [], []
    for batch in case["batches"]:
        coll.reset_bytes()
        net, state, metrics = step(net, state, batch)
        wire.append(dict(coll.WIRE))
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
    return dict(losses=losses, norms=norms, wire=wire)


def checkpoint(case, world):
    """A (2, 2) world trains 2 steps and checkpoints each; a (1, 4) world
    restores the last one into a model of other weights."""
    cfg = case["cfg"]
    out = {}
    for shape, seed, steps in (((2, 2), 0, 2), ((1, 4), 1, 2)):
        ctx = world.ctx(shape, fsdp=shape == (2, 2))
        net = Model(cfg, ctx, device="cpu",
                    generator=torch.Generator().manual_seed(seed))
        opt = adamw()
        loop = TrainLoop(TrainLoopConfig(total_steps=steps, ckpt_every=1,
                                         ckpt_dir=case["dir"], log_every=1),
                         make_train_step(net, opt), net, opt[0](net),
                         shardings=net.param_shardings())
        if shape == (2, 2):
            loop.run(iter(case["batches"]))
        out[shape] = dict(start=loop.start_step,
                          params={n: _np(p) for n, p in
                                  net.named_parameters()},
                          mu={n: _np(t) for n, t in
                              loop.opt_state.mu.items()})
    return out


def refusals(case, world):
    """What a rank mesh refuses, each as (exception type, message)."""
    ctx = world.ctx((1, 4))
    out = {}
    for fam, cfg in case["cfgs"].items():
        try:
            Model(cfg, ctx, device="cpu")
            out[fam] = None
        except Exception as e:   # noqa: BLE001  (the test reads the type)
            out[fam] = (type(e).__name__, str(e))
    net = Model(case["dense"], ctx, device="cpu")
    try:
        adafactor()[0](net)
        out["adafactor"] = None
    except Exception as e:   # noqa: BLE001
        out["adafactor"] = (type(e).__name__, str(e))
    return out


CASES = dict(collectives=collectives, psum_tree=psum_tree, model=model,
             moe_pairs=moe_pairs, train=train, checkpoint=checkpoint,
             refusals=refusals)


def run(rank: int, size: int, store: str, inputs: str, out: str) -> None:
    torch.set_num_threads(1)
    cases = torch.load(inputs, weights_only=False)
    world = _World(rank, size, store)
    results = {}
    for name, case in cases.items():
        try:
            results[name] = CASES[case["kind"]](case, world)
        except Exception:   # noqa: BLE001  (recorded for the test)
            results[name] = {"error": traceback.format_exc()}
            break
    torch.save(results, os.path.join(out, f"rank{rank}.pt"))
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()
    sys.stdout.flush()
