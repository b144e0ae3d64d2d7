"""The JAX package's ``distributed/``: meshes and placements
(:mod:`.sharding`: the LM's named mesh, parameter partition specs and
their divisibility check; the folds × λ mesh), ``MeshCtx``
(:mod:`.context`), the roofline with the card's presets (:mod:`.roofline`),
the launch-plan cost (:mod:`.plan_cost`, the port's counterpart of
``hlo_cost``), the autotuner (:mod:`.autotune`), the int8
error-feedback gradient compression with its all-reduce
(:mod:`.compression`), and the world of ranks (:mod:`.runtime`: one
process a mesh position) with its collectives over named axes
(:mod:`.collectives`)."""
from .context import MeshCtx  # noqa: F401
from . import autotune, collectives, compression, dtype_bytes, plan_cost, \
    roofline, runtime, sharding  # noqa

__all__ = ["MeshCtx", "autotune", "collectives", "compression",
           "dtype_bytes", "plan_cost", "roofline", "runtime", "sharding"]
