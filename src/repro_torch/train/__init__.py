"""Training: optimizers, the train step and Trainer, checkpoints.

The port of ``repro/train`` without ``distill.py`` and the error-feedback
half of ``compress.py`` (int8 gradient compression), which come with a
later slice; ``compress.py``'s int8 Q/DQ, which the weight-only int8
storage uses, is ported.
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
