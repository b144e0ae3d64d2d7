"""The CV half of the JAX package's ``distributed/``: the folds × λ mesh
(:mod:`.sharding`), ``MeshCtx`` (:mod:`.context`), the roofline with the
card's presets (:mod:`.roofline`), the launch-plan cost (:mod:`.plan_cost`,
the port's counterpart of ``hlo_cost``) and the autotuner
(:mod:`.autotune`); and of the LM half, the int8 error-feedback gradient
compression (:mod:`.compression`)."""
from .context import MeshCtx  # noqa: F401
from . import autotune, compression, dtype_bytes, plan_cost, roofline, \
    sharding  # noqa

__all__ = ["MeshCtx", "autotune", "compression", "dtype_bytes", "plan_cost",
           "roofline", "sharding"]
