"""Knowledge distillation (the paper's section 6: sparse students are
guided by a dense teacher through KD, Hinton et al.).

The port of ``repro/train/distill.py``; both losses are computed in
float32 whatever the logits' dtype.  ``classifier_loss`` is the loss of
the paper's protocol (``examples/cifar_vgg_rbgp4.py``) in the form
``Trainer(loss_fn=...)`` takes: cross-entropy on the labels, mixed with KD
from a frozen teacher where one is given.
"""
from __future__ import annotations

import torch

__all__ = ["kd_loss", "distillation_loss", "classifier_loss"]


def kd_loss(student_logits: torch.Tensor, teacher_logits: torch.Tensor,
            temperature: float = 4.0) -> torch.Tensor:
    """KL(teacher || student) at temperature T, scaled by T^2."""
    t = temperature
    sp = torch.log_softmax(student_logits.float() / t, dim=-1)
    tlogp = torch.log_softmax(teacher_logits.float() / t, dim=-1)
    tp = torch.softmax(teacher_logits.float() / t, dim=-1)
    return torch.mean(torch.sum(tp * (tlogp - sp), dim=-1)) * t * t


def distillation_loss(student_logits: torch.Tensor,
                      teacher_logits: torch.Tensor,
                      hard_loss: torch.Tensor, alpha: float,
                      temperature: float = 4.0) -> torch.Tensor:
    """(1 - alpha) * hard + alpha * KD, the standard mixing."""
    if alpha <= 0.0:
        return hard_loss
    soft = kd_loss(student_logits, teacher_logits, temperature)
    return (1.0 - alpha) * hard_loss + alpha * soft


def classifier_loss(teacher=None, alpha: float = 0.0,
                    temperature: float = 4.0):
    """loss_fn(model, batch) -> (loss, {"acc"}) on ``{"images", "labels"}``
    batches: the mean cross-entropy of the model's logits (batch-statistics
    forward, ``train=True``), mixed with ``kd_loss`` against ``teacher``'s
    logits at ``alpha`` (the teacher runs without a gradient)."""
    from repro_torch.models.lm import lm_loss

    def loss_fn(model, batch):
        logits = model(batch["images"], train=True)
        loss = lm_loss(logits, batch["labels"])
        if teacher is not None and alpha > 0:
            with torch.no_grad():
                t_logits = teacher(batch["images"], train=True)
            loss = distillation_loss(logits, t_logits, loss, alpha,
                                     temperature)
        acc = (logits.argmax(-1) == batch["labels"]).float().mean()
        return loss, {"acc": acc}

    return loss_fn
