"""PrecisionPolicy — the factor pipeline's one mixed-precision contract.

The same four dtype roles and presets as the JAX package, on torch dtypes:

``store``    what fitted state (Θ, packed anchors) is kept in;
``compute``  the dtype fed to the substitution / Horner products;
``accum``    what products accumulate in, solutions come back in and
             factorizations run in (never 16-bit);
``fit``      the polynomial fit and the λ values (floored at float32).

``None`` for a role means *inherit the input's dtype*.  Both backends run
every preset.  Under ``bf16_store`` and ``bf16_refined`` the ``cuda``
backend runs the mixed-precision variants of the blocked Cholesky, the
dense trsm, ``interp_solve`` and the packed trsm: bf16 operands on the
tensor cores, fp32 sums and state, Θ and packed factors read in bf16;
``interp_factors`` evaluates a bf16 Θ in bf16.

The environment variable ``REPRO_TEST_PRECISION`` overrides the default
policy, as in the reference.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional, Union

import torch

__all__ = ["PrecisionPolicy", "PRESETS", "resolve_precision",
           "default_accum_dtype", "as_dtype", "PrecisionLike", "tree_astype"]

_NAMES = {
    "float16": torch.float16, "bfloat16": torch.bfloat16,
    "float32": torch.float32, "float64": torch.float64,
}


def as_dtype(d) -> torch.dtype:
    """A torch dtype from a dtype or its name (``'float64'``)."""
    if isinstance(d, torch.dtype):
        return d
    try:
        return _NAMES[str(d)]
    except KeyError:
        raise ValueError(f"unknown dtype {d!r}; have {sorted(_NAMES)}") \
            from None


def default_accum_dtype(compute_dtype) -> torch.dtype:
    """float32 when the compute dtype is 16-bit, the compute dtype itself
    otherwise — never accumulate a substitution in 16 bits."""
    cd = as_dtype(compute_dtype)
    return torch.float32 if cd.itemsize < 4 else cd


@dataclasses.dataclass(frozen=True)
class PrecisionPolicy:
    """Dtype roles of the factor pipeline (see module doc).  Fields hold
    dtype *names* (or ``None`` = inherit) so the policy stays hashable."""

    name: str = "native"
    store: Optional[str] = None
    compute: Optional[str] = None
    accum: Optional[str] = None
    fit: Optional[str] = None
    refine_iters: int = 0

    def __post_init__(self):
        for role in ("store", "compute", "accum", "fit"):
            v = getattr(self, role)
            if v is not None:
                as_dtype(v)
        if self.refine_iters < 0:
            raise ValueError(
                f"refine_iters must be >= 0, got {self.refine_iters}")

    def store_dtype(self, input_dtype) -> torch.dtype:
        return as_dtype(self.store) if self.store else as_dtype(input_dtype)

    def compute_dtype(self, input_dtype) -> torch.dtype:
        return as_dtype(self.compute) if self.compute \
            else as_dtype(input_dtype)

    def accum_dtype(self, input_dtype) -> torch.dtype:
        if self.accum:
            return as_dtype(self.accum)
        return default_accum_dtype(self.compute_dtype(input_dtype))

    def fit_dtype(self, input_dtype) -> torch.dtype:
        if self.fit:
            return as_dtype(self.fit)
        return torch.promote_types(as_dtype(input_dtype), torch.float32)

    @property
    def is_native(self) -> bool:
        return (self.store is None and self.compute is None
                and self.accum is None and self.fit is None
                and self.refine_iters == 0)

    def bytes_ratio(self, input_dtype) -> float:
        """Storage shrink factor vs the input dtype (2.0 for bf16 ÷ fp32)."""
        return (as_dtype(input_dtype).itemsize
                / self.store_dtype(input_dtype).itemsize)

    def descriptor(self) -> str:
        """Canonical content string for cache fingerprints: derived from
        the dtype roles, never the preset name."""
        if self.is_native:
            return "native"
        return (f"store={self.store or 'inherit'},"
                f"compute={self.compute or 'inherit'},"
                f"accum={self.accum or 'auto'},"
                f"fit={self.fit or 'auto'},"
                f"refine={self.refine_iters}")


PRESETS = {
    "native": PrecisionPolicy(),
    "fp32": PrecisionPolicy(name="fp32", store="float32", compute="float32",
                            accum="float32", fit="float32"),
    "bf16_store": PrecisionPolicy(name="bf16_store", store="bfloat16",
                                  compute="bfloat16", accum="float32",
                                  fit="float32"),
    "bf16_refined": PrecisionPolicy(name="bf16_refined", store="bfloat16",
                                    compute="bfloat16", accum="float32",
                                    fit="float32", refine_iters=1),
    "fp64": PrecisionPolicy(name="fp64", store="float64", compute="float64",
                            accum="float64", fit="float64"),
}

PrecisionLike = Union[None, str, PrecisionPolicy]


def resolve_precision(policy: PrecisionLike = None) -> PrecisionPolicy:
    """Map a ``precision=`` argument to a :class:`PrecisionPolicy`;
    ``None`` is ``REPRO_TEST_PRECISION`` when set, else ``native``."""
    if policy is None:
        policy = os.environ.get("REPRO_TEST_PRECISION", "native")
    if isinstance(policy, PrecisionPolicy):
        return policy
    try:
        return PRESETS[policy]
    except KeyError:
        raise ValueError(f"unknown precision policy {policy!r}; "
                         f"have {sorted(PRESETS)}") from None


def map_tensors(fn, tree):
    """``fn`` applied to every tensor of a nested tuple, list or dict and to
    every tensor field of a dataclass (rebuilt with ``dataclasses.replace``,
    so static fields survive); anything else is returned as it is."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, (tuple, list)):
        out = [map_tensors(fn, t) for t in tree]
        return type(tree)(out) if not hasattr(tree, "_fields") \
            else type(tree)(*out)
    if isinstance(tree, dict):
        return type(tree)((k, map_tensors(fn, v)) for k, v in tree.items())
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: map_tensors(fn, getattr(tree, f.name))
            for f in dataclasses.fields(tree) if f.init})
    return tree


def tree_astype(tree, dtype):
    """Cast every floating tensor of ``tree`` to ``dtype``
    (``src/repro/core/precision.py:199``): nested tuples, lists and dicts,
    and the tensor fields of the port's dataclasses (``PackedFactor``,
    ``PiCholesky``).  Static fields and integer tensors are kept."""
    dt = as_dtype(dtype)
    return map_tensors(
        lambda t: t.to(dt) if t.is_floating_point() else t, tree)
