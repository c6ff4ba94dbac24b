"""Training: the InfoNCE loop (SGD with momentum and weight decay, the
staircase StepLR, early stop, exact resume) and avtex's checkpoint
files."""

from .checkpoint import restore_checkpoint, save_checkpoint
from .loop import (TrainConfigError, TrainState, create_state,
                   make_lr_schedule, make_train_step, train_video)

__all__ = ["TrainConfigError", "TrainState", "create_state",
           "make_lr_schedule", "make_train_step", "restore_checkpoint",
           "save_checkpoint", "train_video"]
