"""Training: optimizers, the train step and Trainer, checkpoints (and
reading the reference's own snapshots), distillation, gradient
compression.

The port of ``repro/train``.  ``compress.py`` holds the int8 Q/DQ that
the weight-only int8 storage uses and the error-feedback gradient
compression of ``TrainConfig.grad_compression == "int8"`` (one card: the
reference's cross-device psum waits for the port's distribution).
"""
from .checkpoint import CheckpointManager, read_reference_snapshot
from .compress import compress_decompress, init_error_feedback
from .distill import classifier_loss, distillation_loss, kd_loss
from .loop import (Trainer, TrainState, init_train_state, lm_loss_fn,
                   make_train_step, trainable)
from .optim import (Optimizer, adamw, clip_by_global_norm, global_norm,
                    make_optimizer, make_schedule, sgd_momentum)

__all__ = [
    "CheckpointManager", "Trainer", "TrainState", "init_train_state",
    "make_train_step", "lm_loss_fn", "trainable", "Optimizer", "adamw",
    "sgd_momentum", "clip_by_global_norm", "global_norm", "make_optimizer",
    "make_schedule", "kd_loss", "distillation_loss", "classifier_loss",
    "compress_decompress", "init_error_feedback", "read_reference_snapshot",
]
