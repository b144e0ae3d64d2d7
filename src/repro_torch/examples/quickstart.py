"""Quickstart: piCholesky in 30 lines (``examples/quickstart.py``).

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

On the card the anchors go through the blocked Cholesky and ``pack_tril``,
the interpolated factors through ``interp_factors`` and the solves through
the dense trsm; with ``--device cpu`` through their plain versions.
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

import torch

from repro_torch._device import resolve_device
from repro_torch.core import picholesky, solvers
from repro_torch.core.backends import resolve_backend

H, N = 512, 2048


def run(device=None, *, x: Optional[torch.Tensor] = None,
        noise: Optional[torch.Tensor] = None) -> dict:
    """The example on ``device``; ``x`` (N, H) and ``noise`` (N,) are the
    design and the draw behind the gradient (default: drawn from a
    ``torch.Generator`` seeded 0)."""
    dev = resolve_device(device)
    bk = resolve_backend("auto", device=dev)
    # An SPD Hessian (e.g. XᵀX from ridge regression)
    gen = torch.Generator(device=dev).manual_seed(0)
    if x is None:
        x = torch.randn(N, H, generator=gen, dtype=torch.float64, device=dev)
    if noise is None:
        noise = torch.randn(N, generator=gen, dtype=torch.float64,
                            device=dev)
    x = torch.as_tensor(x, dtype=torch.float64, device=dev)
    noise = torch.as_tensor(noise, dtype=torch.float64, device=dev)
    hessian = x.T @ x
    grad = x.T @ noise

    # Fit the interpolant from g=5 exact factorizations…
    sample = picholesky.choose_sample_lambdas(1e-3, 1.0, g=5, device=dev)
    model = picholesky.fit(hessian, sample, degree=2, backend=bk)

    # …then sweep 31 λ values at O(r d²) each instead of O(d³)
    lams = torch.logspace(-3, 0, 31, dtype=torch.float64, device=dev)
    factors = model.eval_factor(lams, backend=bk)           # (31, h, h)
    thetas = solvers.solve_from_factor(
        factors, grad.expand(len(lams), -1), backend=bk)

    # accuracy vs exact
    exact = solvers.solve_cholesky_sweep(hessian, grad, lams, backend=bk)
    rel = torch.linalg.norm(thetas - exact, dim=1) / torch.linalg.norm(
        exact, dim=1)
    print(f"swept {len(lams)} λ values with {len(sample)} factorizations")
    print(f"max relative solution error vs exact: {float(rel.max()):.2e}")
    return {"n_lams": len(lams), "n_factorizations": len(sample),
            "max_rel_err": float(rel.max())}


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.examples.quickstart")
    ap.add_argument("--device", default=None,
                    help="the CUDA device unless given (e.g. cpu)")
    return run(ap.parse_args(argv).device)


if __name__ == "__main__":
    main()
