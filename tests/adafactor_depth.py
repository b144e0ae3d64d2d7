"""Adafactor at depth: the JAX package and the port trained side by side on
the CPU, from the same numpy parameters and batches.

    PYTHONPATH=src python tests/adafactor_depth.py [--layers 64] [--steps 5]
        [--lr 1e-3] [--batch 4] [--seq 128] [--dtype float32] [--seed 0]
        [--remat] [--d-model 64] [--vocab 512]

``falcon-mamba-7b`` reduced in width (``ModelConfig.reduced()``: d_model
64, d_inner 128, N 8, vocabulary 512) with ``--layers`` layers,
``--dtype`` parameters and, with ``--remat``, rematerialised layers (as the
published config trains); ``--d-model`` and ``--vocab`` widen it (d_inner
follows d_model).  JAX initialises the weights (``init(PRNGKey(
seed))``); the port takes them through ``convert.model_from_numpy``.  The
batches are numpy draws from ``token_stream``'s unigram distribution
(``-log1p(arange(V))`` logits).  Each package runs ``--steps`` steps of its
own ``make_train_step`` with ``adafactor(lr=--lr)`` (no warmup, as the
launcher's) and prints one JSON line per step (``step``, ``jax_loss``,
``port_loss``, ``jax_grad_norm``, ``port_grad_norm``), then one summary
line: whether each package's loss rose from step 1 to the last.

It lives beside the tests, not in ``scripts/``, because it imports the JAX
package; it is not a test (pytest collects ``test_*.py`` only).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os

import numpy as np

os.environ.setdefault("JAX_PLATFORMS", "cpu")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro.optim import adafactor as jadafactor  # noqa: E402
from repro.train.steps import make_train_step as jmake_train_step  # noqa
from repro_torch import configs, convert  # noqa: E402
from repro_torch.optim import adafactor  # noqa: E402
from repro_torch.train import make_train_step  # noqa: E402

ARCH = "falcon-mamba-7b"


def batches(vocab: int, batch: int, seq: int, steps: int, seed: int):
    """``token_stream``'s unigram draws, from numpy."""
    logits = -np.log1p(np.arange(vocab, dtype=np.float64))
    probs = np.exp(logits - logits.max())
    probs /= probs.sum()
    rng = np.random.default_rng(seed + 1)
    for _ in range(steps):
        tokens = rng.choice(vocab, size=(batch, seq + 1), p=probs)
        yield {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=64)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--remat", action="store_true")
    ap.add_argument("--d-model", type=int, default=64)
    ap.add_argument("--vocab", type=int, default=512)
    args = ap.parse_args(argv)
    over = dict(n_layers=args.layers, dtype=args.dtype, remat=args.remat,
                d_model=args.d_model, vocab_size=args.vocab)
    jcfg = dataclasses.replace(jconfigs.get(ARCH).reduced(), **over)
    tcfg = dataclasses.replace(configs.get(ARCH).reduced(), **over)
    jm = JModel(jcfg)
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(args.seed)))

    jopt = jadafactor(lr=args.lr)
    jstep = jax.jit(jmake_train_step(jm, jopt))
    jp = jax.tree.map(jnp.asarray, params)
    jstate = jopt[0](jp)

    model = convert.model_from_numpy(tcfg, params, device="cpu")
    topt = adafactor(lr=args.lr)
    tstep = make_train_step(model, topt)
    tstate = topt[0](model)

    rows = []
    for k, b in enumerate(batches(jcfg.vocab_size, args.batch, args.seq,
                                  args.steps, args.seed)):
        jp, jstate, jm_ = jstep(jp, jstate, jax.tree.map(jnp.asarray, b))
        tb = {key: torch.from_numpy(v) for key, v in b.items()}
        _, tstate, tm = tstep(model, tstate, tb)
        row = dict(step=k + 1, jax_loss=float(jm_["loss"]),
                   port_loss=float(tm["loss"]),
                   jax_grad_norm=float(jm_["grad_norm"]),
                   port_grad_norm=float(tm["grad_norm"]))
        rows.append(row)
        print(json.dumps(row), flush=True)
    print(json.dumps(dict(
        layers=args.layers, d_model=args.d_model, vocab=args.vocab,
        dtype=args.dtype, remat=args.remat, lr=args.lr,
        batch=args.batch, seq=args.seq, steps=args.steps,
        jax_rises=rows[-1]["jax_loss"] > rows[0]["jax_loss"],
        port_rises=rows[-1]["port_loss"] > rows[0]["port_loss"],
        max_loss_gap=max(abs(r["jax_loss"] - r["port_loss"]) for r in rows))),
        flush=True)
    return rows


if __name__ == "__main__":
    main()
