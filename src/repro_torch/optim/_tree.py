"""The reference's parameter tree over the port's per-layer parameters.

The JAX package keeps each layer leaf stacked along a leading layer axis
(``groups.mamba.wx`` (L, d, di); the hybrid's ``tail`` and the audio
encoder's ``enc_groups`` alike); the port
keeps one module per layer (``groups.<i>.mamba.wx`` (d, di)).  The optimizers work on the reference's
leaves, so that a rule that depends on a leaf's shape (Adafactor's factored
second moment, its update clipping) sees what the reference sees: a
:class:`Leaf` is one reference leaf, the port's tensors of it in layer
order.  Optimizer states keep the reference's layout, keyed by its dotted
names, with the layer axis first.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Mapping, Tuple

import torch
import torch.nn as nn

__all__ = ["Leaf", "named_tensors", "leaves", "zeros_like_tree"]

_LAYER = re.compile(r"^(groups|tail|enc_groups)\.(\d+)\.(.+)$")


@dataclasses.dataclass
class Leaf:
    """One leaf of the reference's tree: ``parts`` are the port's names and
    tensors of it, in layer order; ``stacked`` when the reference holds them
    as one tensor with a leading layer axis."""
    name: str
    parts: List[Tuple[str, torch.Tensor]]
    stacked: bool

    @property
    def shape(self) -> Tuple[int, ...]:
        """The reference leaf's shape."""
        inner = tuple(self.parts[0][1].shape)
        return (len(self.parts), *inner) if self.stacked else inner


def named_tensors(params) -> Dict[str, torch.Tensor]:
    """A model's parameters by dotted name, or a mapping of them as given."""
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    if isinstance(params, Mapping):
        return dict(params)
    raise TypeError(f"parameters must be a module or a mapping of tensors, "
                    f"got {type(params).__name__}")


def leaves(named: Mapping[str, torch.Tensor]) -> List[Leaf]:
    """The reference's leaves over ``named`` (the port's dotted names), in
    the order of their first tensor."""
    out: Dict[str, Leaf] = {}
    layers: Dict[str, Dict[int, Tuple[str, torch.Tensor]]] = {}
    for name, t in named.items():
        m = _LAYER.match(name)
        if m is None:
            out[name] = Leaf(name, [(name, t)], False)
            continue
        key = f"{m.group(1)}.{m.group(3)}"
        if key not in out:
            out[key] = Leaf(key, [], True)
            layers[key] = {}
        layers[key][int(m.group(2))] = (name, t)
    for key, by_layer in layers.items():
        if sorted(by_layer) != list(range(len(by_layer))):
            raise ValueError(f"{key}: layers {sorted(by_layer)} are not "
                             f"0..{len(by_layer) - 1}")
        out[key].parts = [by_layer[i] for i in range(len(by_layer))]
    return list(out.values())


def zeros_like_tree(params, dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """Zeros of every parameter's shape, by the port's names (the
    error-feedback residual of ``compress_grads``)."""
    return {n: torch.zeros(t.shape, dtype=dtype, device=t.device)
            for n, t in named_tensors(params).items()}
