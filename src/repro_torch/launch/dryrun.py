"""The LM dry run on the production meshes (``src/repro/launch/dryrun.py``):
every (configuration × shape × mesh) cell's layout, built on the ``meta``
device.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-1.5b \\
        --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all \\
        [--both-meshes] [--multi-pod] [--out DIR]

The reference lowers and compiles each cell for 256 or 512 devices and
reads its memory and cost from the compiled program; the port has no SPMD
compiler, so it builds each cell's arguments with their placements
(:mod:`repro_torch.launch.specs`) and prices the step itself
(:func:`repro_torch.distributed.plan_cost.price_lm_step`: the operations
the port runs at each device's shard shapes and the collectives the
partition implies).  Per cell: ``status`` (``ok``, ``skip`` for
``long_500k`` on a pure full-attention configuration, ``error`` for a
layout that does not divide), ``note``, ``chips``, ``n_params``,
``n_active_params``, ``model_flops`` (6 or 2 · active parameters ·
tokens); ``memory.argument_size_in_bytes``, the fullest device's bytes of
the step's arguments (parameters, optimizer state, batch and source for a
training step; parameters, tokens and source for a prefill; parameters,
cache and tokens for a decode step) from each leaf's local shard shape,
and ``memory.temp_size_in_bytes``, the port's priced working set beyond
them; ``roofline``, the priced step's
:meth:`~repro_torch.distributed.roofline.Roofline.summary` (per-device
FLOPs, bytes and wire bytes by collective, the compute, memory,
collective and launch times, ``step_s`` and the bottleneck) on the
hardware :func:`~repro_torch.distributed.roofline.detect_hw` picks for the
configuration's compute dtype (the card's preset on the card, the CPU's
without one, ``REPRO_HW`` to force one); ``useful_flops_frac`` = model
FLOPs / (priced FLOPs · chips).  ``fits`` says whether the arguments and
the temporaries together fit the card's memory
(``torch.cuda.get_device_properties(0).total_memory``), and is ``null``
without a card.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import traceback
from typing import Optional, Sequence

import torch

from repro_torch import configs
from repro_torch.distributed import plan_cost
from repro_torch.distributed import roofline as rl
from repro_torch.distributed.context import MeshCtx
from repro_torch.launch import specs as specmod
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.model import Model
from repro_torch.optim import adafactor, adamw

__all__ = ["FSDP_THRESHOLD", "build_cell", "cell_args", "cell_cost",
           "run_cell", "main"]

FSDP_THRESHOLD = 2e9  # parameters; above this weights split over data too
ADAFACTOR_THRESHOLD = 3e11   # and the optimizer is Adafactor


def build_cell(arch: str, shape: str, multi_pod: bool):
    """(cfg, the shape's meta, mesh, ctx, model) of a cell, the model on
    the ``meta`` device: FSDP above :data:`FSDP_THRESHOLD` parameters."""
    cfg = configs.get(arch)
    meta = configs.SHAPES[shape]
    mesh = make_production_mesh(multi_pod=multi_pod, devices="meta")
    ctx = MeshCtx.from_mesh(mesh, fsdp=cfg.n_params() > FSDP_THRESHOLD)
    return cfg, meta, mesh, ctx, Model(cfg, ctx)


def _train_plan(cfg, microbatches: Optional[int] = None):
    """(optimizer name, microbatches) of a training cell: the 1 T MoE
    trains with Adafactor in two microbatches."""
    big = cfg.n_params() > ADAFACTOR_THRESHOLD
    return ("adafactor" if big else "adamw"), microbatches or (2 if big
                                                               else 1)


def cell_args(arch: str, shape: str, *, multi_pod: bool = False,
              microbatches: Optional[int] = None):
    """(the step's arguments as trees of :class:`~repro_torch.launch.specs.
    Placed`, chips, note) of a cell; ``ValueError`` for a layout that does
    not divide."""
    return _args(build_cell(arch, shape, multi_pod), microbatches)


def _args(cell, microbatches: Optional[int] = None):
    """:func:`cell_args` of a built cell (:func:`build_cell`)."""
    cfg, meta, mesh, ctx, model = cell
    seq, batch, kind = meta["seq_len"], meta["global_batch"], meta["kind"]
    params = specmod.param_specs_sharded(model)
    if kind == "train":
        name, mb = _train_plan(cfg, microbatches)
        big = name == "adafactor"
        opt = adafactor() if big else adamw()
        args = (params, specmod.opt_state_specs(opt[0], model),
                specmod.batch_specs(cfg, ctx, batch, seq, with_labels=True),
                specmod.extra_specs(cfg, ctx, batch, seq))
        note = (f"train mb={mb} opt={'adafactor' if big else 'adamw'} "
                f"fsdp={ctx.fsdp}")
    elif kind == "prefill":
        args = (params, specmod.batch_specs(cfg, ctx, batch, seq,
                                            with_labels=False)["tokens"],
                specmod.extra_specs(cfg, ctx, batch, seq))
        note = f"prefill fsdp={ctx.fsdp}"
    else:
        extra_len = 0
        if cfg.family == "audio":
            extra_len = seq // cfg.enc_seq_ratio
        elif cfg.family == "vlm":
            extra_len = cfg.n_image_tokens
        tok = specmod.Placed(
            torch.empty((batch, 1), dtype=torch.int32, device="meta"),
            ctx.sharding(ctx.dp_axes if batch % ctx.dp_size == 0 else None,
                         None))
        args = (params, specmod.cache_specs(model, batch, seq, extra_len),
                tok)
        note = f"decode cache={seq} fsdp={ctx.fsdp}"
    return args, mesh.size, note


def argument_bytes(args) -> int:
    """The step's argument bytes on the fullest device: each leaf's local
    shard, summed (the layouts split every leaf evenly, so every device
    holds the same)."""
    return sum(leaf.local_nbytes for leaf in specmod.placed_leaves(args))


def cell_cost(arch: str, shape: str, *, multi_pod: bool = False
              ) -> plan_cost.PlanCost:
    """The priced step of a cell, per device
    (:func:`~repro_torch.distributed.plan_cost.price_lm_step`)."""
    return _cost(build_cell(arch, shape, multi_pod))


def _cost(cell) -> plan_cost.PlanCost:
    """:func:`cell_cost` of a built cell, priced on its abstract model."""
    cfg, meta, _, ctx, model = cell
    opt, mb = _train_plan(cfg)
    return plan_cost.price_lm_step(cfg, ctx, meta["kind"],
                                   meta["global_batch"], meta["seq_len"],
                                   microbatches=mb, optimizer=opt,
                                   model=model)


def card_memory() -> Optional[int]:
    """The card's memory in bytes, or ``None`` without a card."""
    if not torch.cuda.is_available():
        return None
    return torch.cuda.get_device_properties(0).total_memory


def run_cell(arch: str, shape: str, *, multi_pod: bool = False,
             verbose: bool = True) -> dict:
    cell = f"{arch}×{shape}×{'2x16x16' if multi_pod else '16x16'}"
    meta = configs.SHAPES[shape]
    cfg = configs.get(arch)
    if shape == "long_500k" and not cfg.subquadratic:
        result = {"cell": cell, "status": "skip",
                  "reason": "pure full-attention arch"}
    else:
        try:
            built = build_cell(arch, shape, multi_pod)
            args, chips, note = _args(built)
            arg_bytes = argument_bytes(args)
            cost = _cost(built)
            roof = rl.roofline(cost, chips,
                               rl.detect_hw(cfg.activation_dtype))
            total = card_memory()
            n_act = cfg.n_active_params()
            tokens = meta["global_batch"] * (meta["seq_len"]
                                             if meta["kind"] != "decode"
                                             else 1)
            mult = 6 if meta["kind"] == "train" else 2
            model_flops = mult * n_act * tokens
            temp = int(cost.temp_bytes)
            result = {
                "cell": cell, "status": "ok", "note": note, "chips": chips,
                "memory": {"argument_size_in_bytes": arg_bytes,
                           "temp_size_in_bytes": temp},
                "fits": (None if total is None
                         else arg_bytes + temp <= total),
                "roofline": roof.summary(),
                "n_params": cfg.n_params(), "n_active_params": n_act,
                "model_flops": model_flops,
                "useful_flops_frac": model_flops / (cost.flops * chips),
            }
        except ValueError as e:     # a layout that does not divide
            result = {"cell": cell, "status": "error",
                      "error": f"{type(e).__name__}: {e}",
                      "trace": traceback.format_exc()[-2000:]}
    if verbose:
        if result["status"] == "ok":
            r = result["roofline"]
            print(f"[ok] {cell}  {note}  args/device="
                  f"{result['memory']['argument_size_in_bytes']:,} B  "
                  f"temp={result['memory']['temp_size_in_bytes']:,} B  "
                  f"fits={result['fits']}  bottleneck={r['bottleneck']}  "
                  f"compute={r['compute_s']:.3e}s mem={r['memory_s']:.3e}s "
                  f"coll={r['collective_s']:.3e}s", flush=True)
        else:
            print(f"[{result['status']}] {cell}  "
                  f"{result.get('reason', result.get('error'))}", flush=True)
    return result


def main(argv: Optional[Sequence[str]] = None) -> list:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    if args.all:
        cells = [(name, shape) for name, shape, _, _ in configs.cells()]
    else:
        if not args.arch or not args.shape:
            ap.error("--arch and --shape required unless --all")
        cells = [(args.arch, args.shape)]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    results = []
    for arch, shape in cells:
        for mp in meshes:
            res = run_cell(arch, shape, multi_pod=mp)
            results.append(res)
            if args.out:
                os.makedirs(args.out, exist_ok=True)
                tag = f"{arch}__{shape}__{'mp' if mp else 'sp'}.json"
                with open(os.path.join(args.out, tag), "w") as f:
                    json.dump(res, f, indent=1)
    n_ok = sum(r["status"] == "ok" for r in results)
    n_skip = sum(r["status"] == "skip" for r in results)
    n_err = len(results) - n_ok - n_skip
    print(f"\n== dry-run: {n_ok} ok, {n_skip} skip, {n_err} error ==")
    if n_err:
        sys.exit(1)
    return results


if __name__ == "__main__":
    main()
