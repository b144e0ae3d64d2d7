"""Multi-tenant CV sweep serving (``examples/serve_cv.py``): a seeded Zipf
traffic mix of ridge-CV problems served through the admission-batched
:class:`~repro_torch.serving.CVSweepServer`, with latency, throughput and
the shared cache's hit rate.

    PYTHONPATH=src python -m repro_torch.examples.serve_cv --requests 24 \\
        --tenants 4 [--device cpu]
"""
from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence

import numpy as np

from repro_torch._device import resolve_device
from repro_torch.core.engine import PiCholeskyStrategy
from repro_torch.serving import (CVSweepServer, ServerConfig, TrafficConfig,
                                 make_traffic)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.examples.serve_cv")
    ap.add_argument("--requests", type=int, default=24)
    ap.add_argument("--tenants", type=int, default=4)
    ap.add_argument("--problems", type=int, default=6)
    ap.add_argument("--h", type=int, default=48)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--zipf-a", type=float, default=1.2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cache-mb", type=float, default=None,
                    help="byte budget of the shared cache (default: none)")
    ap.add_argument("--device", default=None,
                    help="the CUDA device unless given (e.g. cpu)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = TrafficConfig(n_requests=args.requests, n_tenants=args.tenants,
                        n_problems=args.problems, h=args.h, n=8 * args.h,
                        zipf_a=args.zipf_a, seed=args.seed)
    srv = CVSweepServer(
        PiCholeskyStrategy(g=4, block=16),
        config=ServerConfig(
            max_batch=args.max_batch,
            cache_bytes=(None if args.cache_mb is None
                         else int(args.cache_mb * 2**20))),
        device=dev)

    t0 = time.perf_counter()
    for req in make_traffic(cfg, device=dev):
        srv.submit(req)
    resps = srv.drain()
    wall = time.perf_counter() - t0

    lat = np.array([r.latency_s for r in resps])
    st = srv.stats
    print(f"requests={len(resps)} tenants={args.tenants} "
          f"problems={args.problems} h={args.h}")
    print(f"p50 {np.percentile(lat, 50)*1e3:.0f} ms   "
          f"p99 {np.percentile(lat, 99)*1e3:.0f} ms   "
          f"{len(resps)/wall:.1f} req/s   "
          f"{st['dispatches']} dispatches (mean batch "
          f"{st['batch_mean']:.1f})")
    print(f"cache: hit_rate={srv.cache.hit_rate():.2f} "
          f"entries={st['cache']['entries']} "
          f"evictions={st['cache']['evictions']}")
    out = {"requests": len(resps), "hit_rate": srv.cache.hit_rate(),
           "tenants": {}}
    for tenant in sorted(st["tenants"]):
        own = srv.take_responses(tenant)
        lams = [f"{r.result.best_lam:.3g}" for r in own[:4]]
        print(f"  {tenant}: {len(own)} served, hit_rate="
              f"{srv.cache.hit_rate(tenant):.2f}, λ* {lams}")
        out["tenants"][tenant] = [r.result.best_lam for r in own]
    return out


if __name__ == "__main__":
    main()
