"""Parameter specs and their initialisation on a ``torch.Generator``.

A model describes its parameters as a nested tree (dicts and lists) of
:class:`Spec` (shape + logical axes + initializer), as the JAX package's
``models/params.py`` does.  Interpreters: :func:`init_params` materialises
the tree on a device, :func:`abstract_params` on the ``meta`` device (no
storage: the dry run), and :func:`repro_torch.distributed.sharding.
param_shardings` gives each leaf its placement.  The numbers differ from
``jax.random``'s for the same seed: parity with the JAX package comes from
carrying its weights across (:func:`repro_torch.convert.model_from_numpy`).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Iterator, Optional, Tuple

import torch

__all__ = ["Spec", "init_params", "abstract_params", "flatten"]


@dataclasses.dataclass(frozen=True)
class Spec:
    """``axes``: one logical axis per dimension (``"model"``, ``"fsdp"``
    or ``None``; all ``None`` when not given), as the reference's
    ``Spec.axes`` (``params.py:22-30``)."""
    shape: Tuple[int, ...]
    axes: Optional[Tuple[Optional[str], ...]] = None
    init: str = "normal"     # normal | zeros | ones | mamba_a | dt_bias
                             # | rglru_a
    scale: float = 0.02

    def __post_init__(self):
        if self.axes is None:
            object.__setattr__(self, "axes", (None,) * len(self.shape))
        if len(self.axes) != len(self.shape):
            raise ValueError(f"axes {self.axes} for shape {self.shape}")


def _init_leaf(spec: Spec, generator: torch.Generator, dtype: torch.dtype,
              device) -> torch.Tensor:
    """One parameter, drawn in float32 on ``device`` and cast to ``dtype``."""
    f32 = torch.float32
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=dtype, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=dtype, device=device)
    if spec.init == "mamba_a":
        # Mamba-1 A init: A = -(1..N) over every channel, stored as log.
        n = spec.shape[-1]
        a = torch.arange(1, n + 1, dtype=f32, device=device)
        return torch.log(a).expand(spec.shape).to(dtype).contiguous()
    if spec.init == "dt_bias":
        # softplus⁻¹ of dt log-uniform in [1e-3, 1e-1]
        u = torch.empty(spec.shape, dtype=f32, device=device).uniform_(
            math.log(1e-3), math.log(1e-1), generator=generator)
        dt = torch.exp(u)
        return (dt + torch.log(-torch.expm1(-dt))).to(dtype)
    if spec.init == "rglru_a":
        # the RG-LRU's λ, so that its decay exp(-8·softplus(λ)) at r = 1
        # is u² with u ~ U(0.9, 0.999) (``params.py:53-57``)
        u = torch.empty(spec.shape, dtype=f32, device=device).uniform_(
            0.9, 0.999, generator=generator)
        return torch.log(torch.expm1(-torch.log(u * u) / 8.0)).to(dtype)
    if spec.init != "normal":
        raise ValueError(f"unknown init {spec.init!r}")
    return (spec.scale * torch.randn(spec.shape, generator=generator,
                                     dtype=f32, device=device)).to(dtype)


def flatten(tree: Any, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """(dotted name, leaf) pairs of a tree of dicts and lists, in order;
    the names are those of ``nn.Module.named_parameters``."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        yield prefix, tree
        return
    for key, sub in items:
        yield from flatten(sub, f"{prefix}.{key}" if prefix else str(key))


def init_params(tree: Any, generator: torch.Generator, dtype: torch.dtype,
                device) -> Dict[str, torch.Tensor]:
    """Every :class:`Spec` of ``tree`` materialised on ``device``, keyed by
    its dotted name, drawn from ``generator`` in the tree's order."""
    return {name: _init_leaf(spec, generator, dtype, device)
            for name, spec in flatten(tree)}


def abstract_params(tree: Any, dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """Every :class:`Spec` of ``tree`` as a tensor of its shape and
    ``dtype`` on the ``meta`` device, keyed by its dotted name (the
    reference's ``abstract_params``, ``params.py:68``)."""
    return {name: torch.empty(spec.shape, dtype=dtype, device="meta")
            for name, spec in flatten(tree)}
