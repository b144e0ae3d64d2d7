"""Linear-probe selection on an LM's features with piCholesky-accelerated
ridge CV (``examples/lm_probe.py``): the logits of any configuration of
the zoo (its reduced variant) as features, and the probe's regularization
chosen by k-fold CV with g = 4 factorizations instead of 31.

    PYTHONPATH=src python -m repro_torch.examples.lm_probe \\
        [--arch smollm-360m] [--n-seq 16] [--device cpu]

The weights, tokens, source and the probe's target come from
``torch.Generator`` draws; :func:`run` takes them instead.
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

import torch

from repro_torch import configs
from repro_torch._device import resolve_device
from repro_torch.core import cv
from repro_torch.data import cross_source
from repro_torch.models import Model

SEQ = 32          # tokens per sequence
N_FEATURES = 96   # logit columns kept as features


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.examples.lm_probe")
    ap.add_argument("--arch", default="smollm-360m", choices=configs.names())
    ap.add_argument("--n-seq", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="the CUDA device unless given (e.g. cpu)")
    return ap


def run(args: argparse.Namespace, *, model: Optional[Model] = None,
        tokens=None, extra: Optional[dict] = None, theta_true=None,
        noise=None) -> dict:
    """The example for parsed ``args``; ``model`` (of the reduced
    configuration), ``tokens`` (n_seq, 32), ``extra`` (the source),
    ``theta_true`` (97,) and ``noise`` (n_seq · 32,) replace the drawn
    ones.  Returns both results."""
    dev = resolve_device(args.device)
    cfg = configs.get(args.arch).reduced()
    if model is None:
        model = Model(cfg, device=dev,
                      generator=torch.Generator(device=dev).manual_seed(0))
    gen = torch.Generator(device=dev).manual_seed(1)
    if tokens is None:
        tokens = torch.randint(0, cfg.vocab_size, (args.n_seq, SEQ),
                               generator=gen, device=dev)
    tokens = torch.as_tensor(tokens, device=dev)
    if extra is None:
        extra = cross_source(cfg, gen, tokens.shape[0], SEQ)

    # features: the logits' first 96 columns (a stand-in for pooled hidden
    # states) and an intercept
    with torch.no_grad():
        logits, _ = model(tokens, extra)
    feats = logits.reshape(-1, cfg.vocab_size)[:, :N_FEATURES].double()
    feats = torch.cat([feats, feats.new_ones((feats.shape[0], 1))], dim=1)

    # a synthetic probe target over those features
    if theta_true is None:
        theta_true = torch.randn(
            N_FEATURES + 1, dtype=torch.float64, device=dev,
            generator=torch.Generator(device=dev).manual_seed(2))
    if noise is None:
        noise = torch.randn(
            feats.shape[0], dtype=torch.float64, device=dev,
            generator=torch.Generator(device=dev).manual_seed(3))
    theta_true = torch.as_tensor(theta_true, dtype=torch.float64, device=dev)
    noise = torch.as_tensor(noise, dtype=torch.float64, device=dev)
    y = feats @ theta_true + 0.5 * noise

    folds = cv.make_folds(feats, y, 4, device=dev)
    lams = torch.logspace(-4, 1, 31, dtype=torch.float64, device=dev)
    r_exact = cv.cv_exact_cholesky(folds, lams, device=dev)
    r_pi = cv.cv_picholesky(folds, lams, g=4, block=32, device=dev)
    print(f"arch={args.arch}  features={tuple(feats.shape)}")
    print(f"exact   CV: λ*={r_exact.best_lam:.4g} err={r_exact.best_error:.4f}"
          f"  ({r_exact.n_exact_chol} factorizations)")
    print(f"piChol  CV: λ*={r_pi.best_lam:.4g} err={r_pi.best_error:.4f}"
          f"  ({r_pi.n_exact_chol} factorizations)")
    return {"exact": r_exact, "picholesky": r_pi,
            "features": tuple(feats.shape)}


def main(argv: Optional[Sequence[str]] = None) -> dict:
    return run(parser().parse_args(argv))


if __name__ == "__main__":
    main()
