"""Training: the train state, the fused AdamW, the train/eval steps and
the host loop (`train.loop.train_loop`)."""

from .state import TrainState, create_train_state, make_lr_schedule
from .train_step import (make_eval_loss_fn, make_scan_train_step,
                         make_train_step)

__all__ = [
    "TrainState",
    "create_train_state",
    "make_lr_schedule",
    "make_train_step",
    "make_scan_train_step",
    "make_eval_loss_fn",
]
