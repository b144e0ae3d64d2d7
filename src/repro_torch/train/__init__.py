"""Training: the step builders and the fault-tolerant loop
(``src/repro/train``)."""
from .loop import TrainLoop, TrainLoopConfig
from .steps import make_serve_steps, make_train_step

__all__ = ["TrainLoop", "TrainLoopConfig", "make_train_step",
           "make_serve_steps"]
