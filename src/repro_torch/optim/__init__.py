"""Optimizers of the port: the piCholesky-damped Gauss–Newton head, and
the LM's AdamW and Adafactor (``(init, update)`` pairs over the
reference's parameter tree)."""
from .adafactor import AdafactorState, adafactor
from .adamw import AdamWState, adamw
from .gauss_newton import GNState, damped_gauss_newton_head

__all__ = ["AdamWState", "AdafactorState", "GNState", "adafactor", "adamw",
           "damped_gauss_newton_head"]
