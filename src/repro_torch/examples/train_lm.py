"""End-to-end LM training (``examples/train_lm.py``): synthetic tokens →
model → AdamW → the fault-tolerant loop (checkpoints, auto-resume,
straggler accounting).

The default preset is the configuration's reduced variant; ``--preset
100m`` keeps its width and trims depth and vocabulary (float32, no remat).

    PYTHONPATH=src python -m repro_torch.examples.train_lm --steps 50
    PYTHONPATH=src python -m repro_torch.examples.train_lm --preset 100m \\
        --steps 300 [--ckpt-dir DIR] [--compress-grads] [--device cpu]

The tokens are drawn on the host, as the launcher draws them
(``repro_torch.launch.train``), so a resumed run trains on the batches of
an unbroken one.
"""
from __future__ import annotations

import argparse
import dataclasses
import itertools
from typing import Optional, Sequence

import torch

from repro_torch import configs
from repro_torch._device import resolve_device
from repro_torch.data import token_stream
from repro_torch.models import Model
from repro_torch.optim import adamw
from repro_torch.optim._tree import zeros_like_tree
from repro_torch.train import TrainLoop, TrainLoopConfig, make_train_step


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.examples.train_lm")
    ap.add_argument("--arch", default="smollm-360m", choices=configs.names())
    ap.add_argument("--preset", default="tiny", choices=["tiny", "100m"])
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--device", default=None,
                    help="the CUDA device unless given (e.g. cpu)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = configs.get(args.arch)
    if args.preset == "tiny":
        cfg = cfg.reduced()
    else:  # ~100M: keep width, trim depth+vocab of the reference config
        cfg = dataclasses.replace(
            cfg, n_layers=min(cfg.n_layers, 12), vocab_size=32768,
            dtype="float32", param_dtype="float32", remat=False)
    print(f"arch={cfg.name} params≈{cfg.n_params()/1e6:.2f}M "
          f"(preset={args.preset})")

    model = Model(cfg, device=dev,
                  generator=torch.Generator(device=dev).manual_seed(0))
    opt = adamw(lr=3e-4)
    opt_state = opt[0](model)
    if args.compress_grads:
        opt_state = (opt_state, zeros_like_tree(model))
    step = make_train_step(model, opt, compress_grads=args.compress_grads)

    loop = TrainLoop(
        TrainLoopConfig(total_steps=args.steps, ckpt_every=25,
                        ckpt_dir=args.ckpt_dir, log_every=5),
        step, model, opt_state)
    data = ({k: t.to(dev) for k, t in batch.items()} for batch in
            token_stream(torch.Generator().manual_seed(1), cfg.vocab_size,
                         args.batch, args.seq))
    out = loop.run(itertools.islice(data, loop.start_step, args.steps + 5))
    for entry in out["log"]:
        print(f"step {entry['step']:5d}  loss {entry['loss']:.4f}  "
              f"{entry['sec_per_step']:.2f}s/step")
    print(f"done at step {out['final_step']}; "
          f"straggler steps: {out['straggler_steps']}")
    return out


if __name__ == "__main__":
    main()
