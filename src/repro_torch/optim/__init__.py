"""Optimizers of the port.  So far the piCholesky-damped Gauss–Newton head;
the LM-side optimizers come with the LM path (``ROADMAP.md`` queue 1
item 10)."""
from .gauss_newton import GNState, damped_gauss_newton_head

__all__ = ["GNState", "damped_gauss_newton_head"]
