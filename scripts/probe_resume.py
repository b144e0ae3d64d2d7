#!/usr/bin/env python3
"""Where does a resumed training run leave the unbroken one?

    python3 scripts/probe_resume.py [--arch qwen2-1.5b] [--layers 1]
        [--batch 4] [--seq 2048] [--steps 4] [--every 2]

The launcher's loop (``--mesh 1x1``: the model over a one-device mesh,
``TrainLoop(shardings=)``, AdamW, ``token_stream``) at the
configuration's widths cut to ``--layers`` layers: run A trains
``--steps`` steps with a checkpoint every ``--every``; run B starts from
A's first checkpoint alone and trains to the same step, skipping the
batches A trained on before it.  Each step's loss and a digest of its
tokens are recorded; after B's restore, its parameters and optimizer
state are held against A's at that step (kept on the card), and after
the last step against A's last.  ``--data-device cpu`` draws the tokens
on the host.  One JSON line: per step A's and B's
loss and token digest, whether each is the same, and the leaves that
differ.  Needs one CUDA card (``--device cpu`` runs it on the CPU);
imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import dataclasses
import hashlib
import itertools
import json
import shutil
import sys
import tempfile
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

from repro_torch import configs  # noqa: E402
from repro_torch.checkpoint import CheckpointManager, tree_leaves  # noqa
from repro_torch.data import token_stream  # noqa: E402
from repro_torch.distributed.context import MeshCtx  # noqa: E402
from repro_torch.distributed.sharding import param_shardings  # noqa: E402
from repro_torch.launch.mesh import make_debug_mesh  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.train import TrainLoop, TrainLoopConfig  # noqa: E402
from repro_torch.train import make_train_step  # noqa: E402


def digest(t: torch.Tensor) -> str:
    return hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()[:12]


def state_of(model, opt_state) -> list:
    return ([t.detach().clone() for t in model.parameters()]
            + [t.clone() for t in tree_leaves(opt_state)])


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--layers", type=int, default=1)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=2048)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--every", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--data-device", default=None,
                    help="draw the tokens on this device's generator "
                    "(default: the model's), each batch moved to the model")
    args = ap.parse_args()
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    cfg = dataclasses.replace(configs.get(args.arch), n_layers=args.layers)
    ctx = MeshCtx.from_mesh(make_debug_mesh(devices=[dev]))

    def run(ckpt_dir, keep=None):
        model = Model(cfg, ctx,
                      generator=torch.Generator(device=dev).manual_seed(0))
        opt = adamw()
        step_fn = make_train_step(model, opt)
        rec = []

        def recorded(params, state, batch, extra=None):
            out = step_fn(params, state, batch, extra)
            rec.append(dict(loss=float(out[2]["loss"]),
                            tokens=digest(batch["tokens"])))
            if keep is not None:
                keep.append(state_of(params, out[1]))
            return out

        loop = TrainLoop(TrainLoopConfig(total_steps=args.steps,
                                         ckpt_every=args.every,
                                         ckpt_dir=ckpt_dir, log_every=1),
                         recorded, model, opt[0](model),
                         shardings=param_shardings(model.param_specs(), ctx))
        restored = state_of(model, loop.opt_state)
        gen = torch.Generator(device=args.data_device or dev).manual_seed(1)
        data = ({k: t.to(dev) for k, t in b.items()} for b in token_stream(
            gen, cfg.vocab_size, args.batch, args.seq))
        loop.run(itertools.islice(data, loop.start_step, args.steps + 4))
        return loop, rec, restored, state_of(model, loop.opt_state)

    def differ(a, b):
        return [i for i, (x, y) in enumerate(zip(a, b))
                if not torch.equal(x, y)]

    with tempfile.TemporaryDirectory() as d:
        states_a = []
        loop_a, rec_a, _, last_a = run(f"{d}/a", states_a)
        mgr = CheckpointManager(f"{d}/a")
        shutil.move(mgr.step_dir(args.every),
                    CheckpointManager(f"{d}/b").step_dir(args.every))
        shutil.rmtree(f"{d}/a")
        loop_b, rec_b, restored_b, last_b = run(f"{d}/b")
    steps = [dict(step=args.every + 1 + i, a=rec_a[args.every + i], b=r)
             for i, r in enumerate(rec_b)]
    print(json.dumps(dict(
        arch=args.arch, layers=args.layers, batch=args.batch, seq=args.seq,
        start_b=loop_b.start_step, steps=steps,
        losses_a=[r["loss"] for r in rec_a],
        restored_differ=differ(states_a[args.every - 1], restored_b),
        last_differ=differ(last_a, last_b),
        same_tokens=all(s["a"]["tokens"] == s["b"]["tokens"]
                        for s in steps),
        same_losses=all(s["a"]["loss"] == s["b"]["loss"] for s in steps))),
        flush=True)


if __name__ == "__main__":
    main()
