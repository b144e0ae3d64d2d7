"""Training launcher (``src/repro/launch/train.py``): the mesh, the model
laid out over it with its parameter shardings, the optimizer, the
fault-tolerant loop over the synthetic token stream (and, for the audio
and VLM families, seeded frame or image embeddings: their frontends are
stubs in both packages).

    PYTHONPATH=src python -m repro_torch.launch.train --arch falcon-mamba-7b \\
        --steps 100 --ckpt-dir /path/to/ckpt [--mesh 1x1] [--batch 8 \\
        --seq 128] [--microbatches 1] [--ckpt-every 50] [--reduced] \\
        [--device cpu]

``--mesh`` follows the reference's rule: ``1x1`` is the debug mesh over
the one device (``--device``, the CUDA device unless given); any other
two-dimensional mesh is the (16, 16) production mesh and three dimensions
the (2, 16, 16) one, each over every CUDA device: ``ValueError`` naming
256 or 512 devices where there are fewer, nothing built from repeats.
FSDP above 2e9 parameters; the parameters' shardings go to ``TrainLoop``,
which restores a checkpoint onto them.  The tokens are drawn on the host
(the same draws on every run); a resumed run skips the batches of the
steps it resumes after, so it trains on what an unbroken run would.

Under ``torchrun`` (``WORLD_SIZE`` in the environment) the mesh is built
over the world's ranks, one process a mesh position, each on
``cuda:LOCAL_RANK`` (or ``--device``), holding only its blocks:

    torchrun --nproc-per-node 1 -m repro_torch.launch.train --mesh 1x1 ...

``--mesh`` keeps the same rule, so a world of another size than the
mesh's raises ``ValueError`` naming the ranks it needs (256 for any
``DxM`` but ``1x1``).  Every rank logs alike; rank 0 prints.  Only the
dense, MoE and Mamba families run over ranks, with AdamW.

``--arch`` is any name of ``repro_torch.configs.names()``: the dense
configurations (``smollm-360m``, ``qwen2-1.5b``, ``minicpm-2b``,
``h2o-danube-3-4b``), ``falcon-mamba-7b``, ``recurrentgemma-2b``, the
MoE ``mixtral-8x7b`` and ``kimi-k2-1t-a32b``, ``whisper-base`` and
``llama-3.2-vision-11b``; with ``--reduced --device cpu`` each trains its
CPU-sized variant on the CPU.  Mixtral (93.4 GB of bf16 weights) and
Kimi-K2 (2.08 TB) do not fit one card as published.

The optimizer follows the reference's rule: Adafactor above 3e11
parameters, AdamW below.  So ``falcon-mamba-7b`` at full depth trains with
AdamW, whose float32 moments with the bf16 weights and gradients need about
87 GB: more than one 80 GB card (README); ``llama-3.2-vision-11b`` (10.1 B
parameters) needs about 121 GB so.
"""
from __future__ import annotations

import argparse
import itertools
import math
import os
from typing import Optional, Sequence

import torch

from repro_torch import configs
from repro_torch._device import resolve_device
from repro_torch.data import cross_source, token_stream
from repro_torch.distributed.context import MeshCtx
from repro_torch.distributed.runtime import init_world
from repro_torch.distributed.sharding import param_shardings
from repro_torch.launch.mesh import (make_debug_mesh, make_production_mesh,
                                     production_shape)
from repro_torch.models import Model
from repro_torch.optim import adafactor, adamw
from repro_torch.train import TrainLoop, TrainLoopConfig, make_train_step

__all__ = ["main"]


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", default="falcon-mamba-7b",
                    choices=configs.names())
    ap.add_argument("--mesh", default="1x1",
                    help="1x1 | DxM (the 16x16 production mesh) | "
                    "PxDxM (2x16x16, multi-pod)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--reduced", action="store_true",
                    help="use the CPU-sized reduced config")
    ap.add_argument("--device", default=None,
                    help="the CUDA device unless given (e.g. cpu)")
    args = ap.parse_args(argv)

    dims = [int(x) for x in args.mesh.split("x")]
    rank = 0
    if "WORLD_SIZE" in os.environ:          # a world started by torchrun
        shape, axes = ((1, 1), ("data", "model")) if dims == [1, 1] else \
            production_shape(multi_pod=len(dims) > 2)
        found = int(os.environ["WORLD_SIZE"])
        if found != math.prod(shape):
            raise ValueError(f"--mesh {args.mesh} is the {shape} mesh of "
                             f"{math.prod(shape)} ranks; the world has "
                             f"{found}")
        world = init_world(shape, axes, device=args.device or torch.device(
            "cuda", int(os.environ.get("LOCAL_RANK", "0"))))
        mesh = (make_debug_mesh(world=world) if dims == [1, 1] else
                make_production_mesh(multi_pod=len(dims) > 2, world=world))
        rank = world.rank
    elif dims == [1, 1]:
        mesh = make_debug_mesh(devices=[resolve_device(args.device)])
    else:
        mesh = make_production_mesh(multi_pod=len(dims) > 2)
    dev = mesh.flat[0]
    cfg = configs.get(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    ctx = MeshCtx.from_mesh(mesh, fsdp=cfg.n_params() > 2e9)
    model = Model(cfg, ctx,
                  generator=torch.Generator(device=dev).manual_seed(0))
    opt = adafactor() if cfg.n_params() > 3e11 else adamw()
    step = make_train_step(model, opt, microbatches=args.microbatches)
    loop = TrainLoop(
        TrainLoopConfig(total_steps=args.steps, ckpt_every=args.ckpt_every,
                        ckpt_dir=args.ckpt_dir, log_every=10),
        step, model, opt[0](model),
        shardings=param_shardings(model.param_specs(), ctx))
    # drawn on the host: the card's multinomial gives other tokens on each
    # run from the same seed (scripts/probe_token_stream.py), the host's
    # the same, so a resumed run trains on the unbroken run's batches
    data = ({k: t.to(dev) for k, t in batch.items()} for batch in
            token_stream(torch.Generator().manual_seed(1), cfg.vocab_size,
                         args.batch, args.seq))
    extra = cross_source(cfg, torch.Generator(device=dev).manual_seed(2),
                         args.batch, args.seq)
    out = loop.run(itertools.islice(data, loop.start_step, args.steps + 4),
                   extra)
    if rank == 0:
        for e in out["log"]:
            print(f"step {e['step']:6d}  loss {e['loss']:.4f}  "
                  f"{e['sec_per_step']:.3f}s/step")
        print(f"final step {out['final_step']}  stragglers "
              f"{out['straggler_steps']}")
    return out


if __name__ == "__main__":
    main()
