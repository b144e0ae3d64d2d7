"""CV as a service (``src/repro/serving``): a request queue admits
compatible problems into one stacked ``fold_state`` call
(:meth:`~repro_torch.core.engine.CVEngine.run_batch`) and serves
overlapping Hessians from one shared
:class:`~repro_torch.core.factor_cache.FactorCache`, with per-tenant stat
partitions and result isolation; :mod:`~repro_torch.serving.traffic` makes
the seeded Zipf-mix workload."""
from .server import CVSweepServer, ServerConfig, SweepRequest, SweepResponse
from .traffic import TrafficConfig, make_traffic

__all__ = [
    "CVSweepServer", "ServerConfig", "SweepRequest", "SweepResponse",
    "TrafficConfig", "make_traffic",
]
