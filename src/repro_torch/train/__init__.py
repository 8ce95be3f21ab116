"""Training: optimizers, the train step and Trainer, checkpoints.

The port of ``repro/train`` without ``compress.py`` (int8 gradient
compression) and ``distill.py``, which come with a later slice.
"""
from .checkpoint import CheckpointManager
from .loop import (Trainer, TrainState, init_train_state, make_train_step,
                   trainable)
from .optim import (Optimizer, adamw, clip_by_global_norm, global_norm,
                    make_optimizer, make_schedule, sgd_momentum)

__all__ = [
    "CheckpointManager", "Trainer", "TrainState", "init_train_state",
    "make_train_step", "trainable", "Optimizer", "adamw", "sgd_momentum",
    "clip_by_global_norm", "global_norm", "make_optimizer", "make_schedule",
]
