"""End-to-end run of the paper's experiment pipeline (§6) on synthetic
polynomial-kernel features (``examples/ridge_cv.py``): all six algorithms,
hold-out curves, selected λ and factorization counts; then the same sweep
through :class:`~repro_torch.core.engine.CVEngine`, optionally over a
folds × λ mesh of every card (``--mesh``), tuned (``--tune``), replayed
from a factor cache, searched (``--search``), sketched (``--search``) and
under a precision policy.

    PYTHONPATH=src python -m repro_torch.examples.ridge_cv [--h 512] \\
        [--n 1500] [--mesh] [--tune] [--search] [--sketch] \\
        [--precision P] [--device cpu]

The data, the r-SVD's test matrix and the sketches come from
``torch.Generator`` draws; :func:`run` takes a design and labels instead.
The port's tuner prices launch plans and lowers nothing, so ``--tune``
prints how many candidate plans it priced.
"""
from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core import cv, engine, factor_cache
from repro_torch.data import make_low_rank_dataset, make_regression_dataset
from repro_torch.distributed import sharding

PRECISIONS = ["native", "fp32", "bf16_store", "bf16_refined", "fp64"]


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.examples.ridge_cv")
    ap.add_argument("--h", type=int, default=384)
    ap.add_argument("--n", type=int, default=1200)
    ap.add_argument("--folds", type=int, default=5)
    ap.add_argument("--mesh", action="store_true",
                    help="shard the engine sweep over every card")
    ap.add_argument("--tune", action="store_true",
                    help="roofline-guided autotune demo: price a "
                         "block/λ-chunk/mesh lattice from its launch plans "
                         "(zero executions) and run the sweep at the "
                         "predicted-fastest config")
    ap.add_argument("--precision", default="fp32", choices=PRECISIONS,
                    help="precision policy for the mixed-precision demo "
                         "section (compared against fp32)")
    ap.add_argument("--search", action="store_true",
                    help="adaptive λ-refinement demo, LOO interpolant "
                         "selection and bound-guided anchor advice")
    ap.add_argument("--sketch", action="store_true",
                    help="sketched-anchor + low-rank demo")
    ap.add_argument("--device", default=None,
                    help="the CUDA device unless given (e.g. cpu)")
    return ap


def _timed(fn):
    t0 = time.perf_counter()
    r = fn()
    return r, time.perf_counter() - t0


def _row(name: str, dt: float, r) -> None:
    print(f"{name:8s} {dt:8.2f} {r.best_error:12.4f} "
          f"{r.best_lam:11.4g} {r.n_exact_chol:6d}")


def _devices(dev: torch.device) -> list:
    """The devices ``--mesh`` spreads over: every card, or the CPU."""
    if dev.type != "cuda":
        return [dev]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def run(args: argparse.Namespace, *, x: Optional[torch.Tensor] = None,
        y: Optional[torch.Tensor] = None) -> dict:
    """The example for parsed ``args``; ``x`` (n, h) and ``y`` (n,) replace
    the drawn dataset.  Returns each printed section's numbers."""
    dev = resolve_device(args.device)
    if x is None:
        x, y = make_regression_dataset(args.n, args.h, dtype=torch.float64,
                                       device=dev)
    x = torch.as_tensor(x, dtype=torch.float64, device=dev)
    y = torch.as_tensor(y, dtype=torch.float64, device=dev)
    h = x.shape[1]
    folds = cv.make_folds(x, y, args.folds, device=dev)
    lams = torch.logspace(-3, 2, 31, dtype=torch.float64, device=dev)
    omega = torch.randn(h, h // 4 + 10, dtype=torch.float64, device=dev,
                        generator=torch.Generator(device=dev).manual_seed(1))
    out: dict = {"algos": {}}

    algos = {
        "Chol": lambda: cv.cv_exact_cholesky(folds, lams, device=dev),
        "PIChol": lambda: cv.cv_picholesky(folds, lams, g=4, device=dev),
        "MChol": lambda: cv.cv_multilevel_cholesky(folds, c=0.0, s=1.5,
                                                   s0=0.05, device=dev),
        "SVD": lambda: cv.cv_svd(folds, lams, mode="full", device=dev),
        "t-SVD": lambda: cv.cv_svd(folds, lams, mode="truncated",
                                   k_trunc=h // 4, device=dev),
        "r-SVD": lambda: cv.cv_svd(folds, lams, mode="randomized",
                                   k_trunc=h // 4, omega=omega, device=dev),
    }
    print(f"{'algo':8s} {'time(s)':>8s} {'min holdout':>12s} "
          f"{'selected λ':>11s} {'#chol':>6s}")
    for name, fn in algos.items():
        r, dt = _timed(fn)
        _row(name, dt, r)
        out["algos"][name] = r

    # ---- the same sweep through the unified engine; the second run is the
    # timed one
    devices = _devices(dev)
    mesh = None
    if args.mesh:
        if len(devices) == 1:
            print("\n--mesh: only one device visible; the sweep runs "
                  "unsharded (a folds × λ mesh needs several cards)")
        else:
            mesh = sharding.cv_mesh(devices, *sharding.cv_axis_sizes(
                args.folds, len(devices)))
    print(f"\nCVEngine (backend=auto, mesh={'auto' if args.mesh else None}, "
          f"{len(devices)} device(s)):")
    strategies = {
        "exact": engine.make_strategy("exact"),
        "pichol": engine.PiCholeskyStrategy(g=4),
        "warm": engine.PiCholeskyWarmstart(g_first=4, g_rest=2),
        "svd": engine.SVDStrategy(mode="full"),
        "pinrmse": engine.PinrmseStrategy(g=4),
    }
    out["engine"] = {}
    for name, strat in strategies.items():
        eng = engine.CVEngine(strat, mesh=mesh, device=dev)
        eng.run(folds, lams)                      # warm
        r, dt = _timed(lambda: eng.run(folds, lams))
        _row(name, dt, r)
        out["engine"][name] = r

    # ---- autotuning: every (block × λ-chunk × mesh) candidate is priced
    # from its launch plan (nothing executes), then the sweep runs at the
    # predicted-fastest one; a second tuned run is a TuningCache hit
    if args.tune:
        from repro_torch.distributed import autotune

        tfolds = cv.make_folds(x.float(), y.float(), args.folds, device=dev)
        tlams = lams.float()
        tcache = autotune.TuningCache()
        tuned = engine.CVEngine(engine.PiCholeskyStrategy(g=4), mesh=mesh,
                                tune="auto", tune_cache=tcache, device=dev)
        base = engine.CVEngine(engine.PiCholeskyStrategy(g=4), mesh=mesh,
                               device=dev)
        r, t_first = _timed(lambda: tuned.run(tfolds, tlams))
        cfg = r.extras["engine"]["tune"]
        base.run(tfolds, tlams)                   # warm the default
        _, t_tuned = _timed(lambda: tuned.run(tfolds, tlams))
        _, t_default = _timed(lambda: base.run(tfolds, tlams))
        print(f"\nAutotune (lattice priced from launch plans, "
              f"{tcache.lowerings} plans priced, 0 executions):")
        print(f"  chosen: block={cfg['block']} lam_chunk={cfg['lam_chunk']} "
              f"mesh={cfg['mesh_shape']} predicted={cfg['predicted_s']:.3e}s "
              f"[{cfg['source']}]")
        print(f"  first tuned run (incl. tuning) {t_first:8.2f}s, "
              f"warm tuned {t_tuned:8.4f}s vs default {t_default:8.4f}s")
        print(f"  tuning cache: {tcache.stats}")
        out["tune"] = dict(cfg, stats=tcache.stats, best_lam=r.best_lam)

    # ---- warm-replay factor cache: the first sweep fits and caches Θ per
    # fold; a later sweep over a grid with the same λ range replays it
    cache = factor_cache.FactorCache()
    print("\nFactorCache warm replay (PiCholesky, g=4):")
    out["cache"] = {}
    for tag, grid, reuse in [
            ("cold 31", lams, False),             # write-only
            ("warm 31", lams, "exact"),
            ("warm 101", torch.logspace(-3, 2, 101, dtype=torch.float64,
                                        device=dev), "exact")]:
        eng = engine.CVEngine(engine.PiCholeskyStrategy(g=4), cache=cache,
                              reuse=reuse, device=dev)
        eng.run(folds, grid)                      # warm
        r, dt = _timed(lambda: eng.run(folds, grid))
        status = r.extras["engine"]["cache"]["status"]
        print(f"{tag:8s} {dt:8.2f} {r.best_error:12.4f} "
              f"{r.best_lam:11.4g} {r.n_exact_chol:6d}  [{status}]")
        out["cache"][tag] = (r.best_lam, status)

    # ---- adaptive λ-search, LOO interpolant selection, anchor advice
    if args.search:
        dense = torch.logspace(-3, 2, 96, dtype=torch.float64, device=dev)
        scache = factor_cache.FactorCache()
        eng = engine.CVEngine(engine.PiCholeskyStrategy(g=4), cache=scache,
                              cache_anchors=True, lam_chunk=8, device=dev)
        eng.run(folds, dense)
        r_dense, t_dense = _timed(lambda: eng.run(folds, dense))
        eng.search(folds, dense)                  # warm the wave shape
        r_s, t_search = _timed(lambda: eng.search(folds, dense))
        info = r_s.extras["engine"]["search"]
        sel = eng.select_interpolant(folds, dense)
        gap = abs(float(np.log10(r_s.best_lam))
                  - float(np.log10(r_dense.best_lam)))
        print(f"\nAdaptive λ-search (dense q={dense.numel()} vs "
              f"wave={info['wave']}, tol={info['tol_decades']} decades):")
        print(f"  dense   {t_dense:8.2f}s λ*={r_dense.best_lam:9.4g}  "
              f"{dense.numel()} evaluations")
        print(f"  search  {t_search:8.2f}s λ*={r_s.best_lam:9.4g}  "
              f"{info['lams_evaluated']} evaluations "
              f"({info['evals_vs_grid']:.2f}x) in {info['waves']} waves, "
              f"stopped on {info['stopped_on']}, gap {gap:.3f} decades")
        print(f"  interpolant: {sel['basis']}/r{sel['degree']} by LOO "
              f"(anchor targets: {sel['anchor_status']})")
        adv = eng.advise_anchor(folds, dense, probe_dim=24)
        lo, hi = adv["intervals"][adv["worst"]]
        print(f"  anchor advice (probe d={adv['probe_dim']}): weakest "
              f"interval [{lo:.3g}, {hi:.3g}] → next anchor "
              f"≈ {adv['proposal']:.4g}")
        out["search"] = dict(dense_lam=r_dense.best_lam,
                             search_lam=r_s.best_lam, gap=gap,
                             evaluated=info["lams_evaluated"],
                             basis=sel["basis"], degree=sel["degree"],
                             proposal=adv["proposal"])

    # ---- sketched anchors (n ≫ h) and low-rank ACV (n ≪ h)
    if args.sketch:
        from repro_torch.core import sketch as sk

        n_tall = max(args.n, 16 * h)
        xt, yt = make_regression_dataset(n_tall, h, seed=2,
                                         dtype=torch.float64, noise=8.0,
                                         device=dev)
        tfolds = cv.make_folds(xt, yt, args.folds, device=dev)
        r_dense = engine.CVEngine(engine.PiCholeskyStrategy(g=4),
                                  device=dev).run(tfolds, lams)
        ed = np.asarray(r_dense.errors)
        print(f"\nSketched anchors (countsketch, n={n_tall} ≫ h={h}, "
              f"dense λ*={r_dense.best_lam:.4g}):")
        print(f"{'m':>6s} {'time(s)':>8s} {'max curve diff':>15s} "
              f"{'regret on dense':>16s} {'selected λ':>11s}")
        out["sketch"] = {"dense_lam": r_dense.best_lam}
        for m in (1024, 4096):
            plan = sk.SketchPlan(method="countsketch", m=m, seed=0,
                                 ihs_iters=2)
            eng = engine.CVEngine(engine.PiCholeskyStrategy(g=4),
                                  sketch=plan, device=dev)
            eng.run(tfolds, lams)
            r, dt = _timed(lambda: eng.run(tfolds, lams))
            es = np.asarray(r.errors)
            regret = ed[int(np.argmin(es))] - ed.min()
            print(f"{m:6d} {dt:8.2f} {np.max(np.abs(es - ed)):15.3e} "
                  f"{regret:16.3e} {r.best_lam:11.4g}")
            out["sketch"][m] = r.best_lam

        h_wide, n_small, rank = 4 * h, h // 4, h // 16
        xl, yl = make_low_rank_dataset(n_small, h_wide, rank, seed=3,
                                       dtype=torch.float64, device=dev)
        lfolds = cv.make_folds(xl, yl, args.folds, device=dev)
        print(f"\nLow-rank ACV (h={h_wide} ≫ n={n_small}, planted "
              f"rank {rank}):")
        for name in ("exact", "low_rank"):
            eng = engine.CVEngine(name, device=dev)
            eng.run(lfolds, lams)
            r, dt = _timed(lambda: eng.run(lfolds, lams))
            print(f"{name:9s} {dt:8.2f} {r.best_error:12.4f} "
                  f"{r.best_lam:11.4g} {r.n_exact_chol:6d} chol")
            out["sketch"][name] = r.best_lam

    # ---- precision policies: fp32 against --precision, with the bytes of
    # each policy's cached state
    print(f"\nPrecision policies (fp32 baseline vs --precision="
          f"{args.precision}):")
    folds32 = cv.make_folds(x.float(), y.float(), args.folds, device=dev)
    print(f"{'policy':14s} {'time(s)':>8s} {'min holdout':>12s} "
          f"{'selected λ':>11s} {'state bytes':>12s}")
    out["precision"] = {}
    for pol in dict.fromkeys(["fp32", args.precision]):
        pcache = factor_cache.FactorCache()
        eng = engine.CVEngine(engine.PiCholeskyStrategy(g=4), precision=pol,
                              cache=pcache, reuse=False, device=dev)
        eng.run(folds32, lams.float())            # warm + cache write
        r, dt = _timed(lambda: eng.run(folds32, lams.float()))
        entry = next(iter(pcache.entries.values()))
        print(f"{pol:14s} {dt:8.2f} {r.best_error:12.4f} "
              f"{r.best_lam:11.4g} {entry.nbytes:12d}")
        out["precision"][pol] = (r.best_lam, entry.nbytes)
    return out


def main(argv: Optional[Sequence[str]] = None) -> dict:
    return run(parser().parse_args(argv))


if __name__ == "__main__":
    main()
