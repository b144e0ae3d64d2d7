"""Does a (fold, λ)'s hold-out score depend on what it is batched with?

Scores the same θ (k, q, h) against the same rows (k, n_f, h) with
``folds.holdout_nrmse``'s arithmetic in several variants of its two
reductions (the predictions x·θ and the means over the rows), first as
one batch, then split every way the engine splits them: λ chunks of c =
1, 2, 3, 8 columns, and contiguous groups of folds, as views into the
batch and as fresh copies (a mesh's fold group on its own device).  Prints
one JSON line per (shape, variant) with the count of splits whose scores
differ from the whole batch's in any bit.  Needs a CUDA device:

    PYTHONPATH=src python scripts/probe_holdout_batch.py
"""
import json
import sys

import numpy as np
import torch

SHAPES = [(5, 37, 64), (5, 819, 1024), (5, 819, 1023), (4, 80, 64),
          (6, 33, 17), (10, 100, 256), (3, 1000, 512)]
Q = 32


def predict_batched(theta, x):
    """One batched GEMM over the folds (λs as columns, at least two)."""
    c = theta.shape[-2]
    t = theta if c > 1 else torch.cat([theta, torch.zeros_like(theta)], -2)
    return (x @ t.mT).mT[..., :c, :].contiguous()


def predict_per_fold(theta, x):
    """One 2-D GEMM a fold (λs as columns, at least two)."""
    return torch.stack([predict_batched(theta[f], x[f])
                        for f in range(x.shape[0])])


def mean_gemv(a):
    return (a @ a.new_ones(a.shape[-1])) / a.shape[-1]


def mean_per_fold(a):
    return torch.stack([mean_gemv(a[f]) for f in range(a.shape[0])])


def _pad2(a, dim):
    """``a`` with a zero slice appended along ``dim`` when it has one."""
    if a.shape[dim] > 1:
        return a
    return torch.cat([a, torch.zeros_like(a)], dim)


def predict_batched2(theta, x):
    """One batched GEMM over the folds, at least two folds and two λ
    columns (zero padding)."""
    k, c = theta.shape[0], theta.shape[-2]
    t, xx = _pad2(_pad2(theta, -2), 0), _pad2(x, 0)
    return (xx @ t.mT).mT[:k, :c].contiguous()


def mean_batched2(a):
    """Means over the last axis of (k, c, n) by one batched GEMM with a
    (2, n) ones matrix, at least two folds and two columns."""
    k, c, n = a.shape
    at = _pad2(_pad2(a, 1), 0).mT                      # (k', n, c')
    ones = a.new_ones(at.shape[0], 2, n)
    return (ones @ at)[:k, 0, :c] / n


def scores(theta, x, y, predict, mean):
    y = y[:, None]                                     # (k, 1, n_f)
    pred = predict(theta, x)                           # (k, c, n_f)
    mse = mean((pred - y) ** 2)
    dev = y - mean(y)[..., None]
    denom = torch.sqrt(mean(dev * dev)) + 1e-30
    return torch.sqrt(mse) / denom


def splits(k):
    for length in range(1, k + 1):
        for start in range(0, k - length + 1):
            yield start, length


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    gen = np.random.default_rng(0)
    variants = {"batched+gemv": (predict_batched, mean_gemv),
                "per_fold+gemv": (predict_per_fold, mean_gemv),
                "batched+per_fold_mean": (predict_batched, mean_per_fold),
                "per_fold+per_fold_mean": (predict_per_fold, mean_per_fold),
                "batched2+batched2_mean": (predict_batched2, mean_batched2)}
    for k, n_f, h in SHAPES:
        theta = torch.from_numpy(gen.standard_normal((k, Q, h))).to(dev)
        x = torch.from_numpy(gen.standard_normal((k, n_f, h))).to(dev)
        y = torch.from_numpy(gen.standard_normal((k, n_f))).to(dev)
        for name, (predict, mean) in variants.items():
            full = scores(theta, x, y, predict, mean)
            bad = dict(lam=[], fold_view=[], fold_copy=[])
            for c in (1, 2, 3, 8, 16):
                for s in range(0, Q, c):
                    got = scores(theta[:, s:s + c], x, y, predict, mean)
                    if not torch.equal(got, full[:, s:s + c]):
                        bad["lam"].append([c, s])
            for start, length in splits(k):
                sl = slice(start, start + length)
                got = scores(theta[sl], x[sl], y[sl], predict, mean)
                if not torch.equal(got, full[sl]):
                    bad["fold_view"].append([start, length])
                got = scores(theta[sl].clone(), x[sl].clone(), y[sl].clone(),
                             predict, mean)
                if not torch.equal(got, full[sl]):
                    bad["fold_copy"].append([start, length])
            print(json.dumps(dict(k=k, n_f=n_f, h=h, variant=name,
                                  mismatches={t: len(v)
                                              for t, v in bad.items()},
                                  first={t: v[:4] for t, v in bad.items()})),
                  flush=True)
    print(torch.cuda.get_device_name(0), torch.__version__,
          torch.version.cuda)
    return 0


if __name__ == "__main__":
    sys.exit(main())
