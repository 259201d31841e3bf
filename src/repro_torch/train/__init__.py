"""The training step."""
from . import trainer
from .trainer import (TrainState, init_state, loss_fn,
                      make_sharded_train_step, make_train_step)

__all__ = ["trainer", "TrainState", "init_state", "loss_fn",
           "make_sharded_train_step", "make_train_step"]
