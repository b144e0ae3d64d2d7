"""Fault-tolerant checkpointing of tensor trees (``src/repro/checkpoint``)."""
from .manager import CheckpointManager, tree_flatten, tree_leaves, \
    tree_unflatten

__all__ = ["CheckpointManager", "tree_flatten", "tree_leaves",
           "tree_unflatten"]
