"""The LM dry run on the production meshes (``src/repro/launch/dryrun.py``):
every (configuration × shape × mesh) cell's layout, built on the ``meta``
device.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-1.5b \\
        --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all \\
        [--both-meshes] [--multi-pod] [--out DIR]

The reference lowers and compiles each cell for 256 or 512 devices; the
port has no SPMD compiler, so it builds each cell's arguments with their
placements (:mod:`repro_torch.launch.specs`) and counts what a layout
decides.  Per cell: ``status`` (``ok``, ``skip`` for ``long_500k`` on a
pure full-attention configuration, ``error`` for a layout that does not
divide), ``note``, ``chips``, ``n_params``, ``n_active_params``,
``model_flops`` (6 or 2 · active parameters · tokens) and
``memory.argument_size_in_bytes``: the fullest device's bytes of the step's
arguments (parameters, optimizer state, batch and source for a training
step; parameters, tokens and source for a prefill; parameters, cache and
tokens for a decode step), from each leaf's local shard shape.  ``fits``
says whether those bytes fit the card's memory
(``torch.cuda.get_device_properties(0).total_memory``), and is ``null``
without a card.  What only a compiled program gives stays ``null``
(``temp_size_in_bytes``, ``hlo_flops``, ``wire_bytes``, ``roofline``,
``useful_flops_frac``), and ``note`` says so.
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
from repro_torch.distributed.context import MeshCtx
from repro_torch.launch import specs as specmod
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.model import Model
from repro_torch.optim import adafactor, adamw

__all__ = ["FSDP_THRESHOLD", "build_cell", "cell_args", "run_cell", "main"]

FSDP_THRESHOLD = 2e9  # parameters; above this weights split over data too
ADAFACTOR_THRESHOLD = 3e11   # and the optimizer is Adafactor
UNCOMPILED = ("temp_size_in_bytes", "hlo_flops", "wire_bytes", "roofline",
              "useful_flops_frac")
_NULL_NOTE = ("; null: temp bytes, HLO FLOPs, wire bytes, roofline and "
              "useful FLOPs need a compiled program (the port has no SPMD "
              "compiler)")


def build_cell(arch: str, shape: str, multi_pod: bool):
    """(cfg, the shape's meta, mesh, ctx, model) of a cell, the model on
    the ``meta`` device: FSDP above :data:`FSDP_THRESHOLD` parameters."""
    cfg = configs.get(arch)
    meta = configs.SHAPES[shape]
    mesh = make_production_mesh(multi_pod=multi_pod, devices="meta")
    ctx = MeshCtx.from_mesh(mesh, fsdp=cfg.n_params() > FSDP_THRESHOLD)
    return cfg, meta, mesh, ctx, Model(cfg, ctx)


def cell_args(arch: str, shape: str, *, multi_pod: bool = False,
              microbatches: Optional[int] = None):
    """(the step's arguments as trees of :class:`~repro_torch.launch.specs.
    Placed`, chips, note) of a cell; ``ValueError`` for a layout that does
    not divide."""
    cfg, meta, mesh, ctx, model = build_cell(arch, shape, multi_pod)
    seq, batch, kind = meta["seq_len"], meta["global_batch"], meta["kind"]
    params = specmod.param_specs_sharded(model)
    if kind == "train":
        # the 1 T MoE: Adafactor and two microbatches
        big = cfg.n_params() > ADAFACTOR_THRESHOLD
        opt = adafactor() if big else adamw()
        mb = microbatches or (2 if big else 1)
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
            args, chips, note = cell_args(arch, shape, multi_pod=multi_pod)
            arg_bytes = argument_bytes(args)
            total = card_memory()
            n_act = cfg.n_active_params()
            tokens = meta["global_batch"] * (meta["seq_len"]
                                             if meta["kind"] != "decode"
                                             else 1)
            mult = 6 if meta["kind"] == "train" else 2
            result = {
                "cell": cell, "status": "ok", "note": note + _NULL_NOTE,
                "chips": chips,
                "memory": {"argument_size_in_bytes": arg_bytes,
                           "temp_size_in_bytes": None},
                "fits": None if total is None else arg_bytes <= total,
                "n_params": cfg.n_params(), "n_active_params": n_act,
                "model_flops": mult * n_act * tokens,
                **{k: None for k in UNCOMPILED if k != "temp_size_in_bytes"},
            }
        except ValueError as e:     # a layout that does not divide
            result = {"cell": cell, "status": "error",
                      "error": f"{type(e).__name__}: {e}",
                      "trace": traceback.format_exc()[-2000:]}
    if verbose:
        if result["status"] == "ok":
            print(f"[ok] {cell}  {note}  args/device="
                  f"{result['memory']['argument_size_in_bytes']:,} B  "
                  f"fits={result['fits']}", flush=True)
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
