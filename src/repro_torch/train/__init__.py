# The training path (counterpart of repro.train): the eager train step with
# microbatching and the fault-tolerant loop.
from .loop import SimulatedPreemption, TrainLoopConfig, train
from .step import make_loss_fn, make_train_step

__all__ = [
    "make_train_step",
    "make_loss_fn",
    "train",
    "TrainLoopConfig",
    "SimulatedPreemption",
]
