"""Optimizers (SGD + momentum, the paper's, and AdamW) and LR schedules.

The port of ``repro/train/optim.py``, with the reference's update math
(not ``torch.optim``, whose weight decay and bias correction differ).
Parameters, gradients and optimizer state are dicts of float32 tensors
keyed by the model's parameter names.  Unlike the reference, which is
functional, ``update`` writes the new values and state in place (one
copy of each instead of two) and returns them.  Schedules are computed in
float32, as the reference's.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import numpy as np
import torch

from repro_torch.configs.base import TrainConfig

__all__ = ["Optimizer", "make_optimizer", "make_schedule", "global_norm",
           "clip_by_global_norm", "sgd_momentum", "adamw"]


def global_norm(tree: dict) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32."""
    return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for g in tree.values()))


def clip_by_global_norm(tree: dict, max_norm: float, norm=None):
    """Scales the gradients in place so their global norm (``norm`` where
    given, else ``global_norm(tree)``) is at most ``max_norm`` (``+1e-9``
    in the denominator, as the reference); returns (tree, norm before
    clipping)."""
    if norm is None:
        norm = global_norm(tree)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    for g in tree.values():
        g.mul_(scale.to(g.dtype))
    return tree, norm


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[dict], dict]
    update: Callable[[dict, dict, dict, float], tuple[dict, dict]]
    # update(grads, state, params, lr) -> (params, state), both in place


def sgd_momentum(momentum: float, weight_decay: float) -> Optimizer:
    def init(params):
        return {"m": {n: torch.zeros_like(p, dtype=torch.float32)
                      for n, p in params.items()}}

    def update(grads, state, params, lr):
        for name, p in params.items():
            g32 = grads[name].float()
            if weight_decay:
                g32 = g32 + weight_decay * p
            m = state["m"][name]
            m.mul_(momentum).add_(g32)
            p.sub_(lr * m)
        return params, state

    return Optimizer(init, update)


def adamw(b1: float, b2: float, eps: float, weight_decay: float) -> Optimizer:
    def init(params):
        z = lambda p: torch.zeros_like(p, dtype=torch.float32)
        return {"m": {n: z(p) for n, p in params.items()},
                "v": {n: z(p) for n, p in params.items()},
                "t": 0}

    def update(grads, state, params, lr):
        t = state["t"] + 1
        bc1 = float(np.float32(1.0) - np.float32(b1) ** np.float32(t))
        bc2 = float(np.float32(1.0) - np.float32(b2) ** np.float32(t))
        for name, p in params.items():
            g32 = grads[name].float()
            m, v = state["m"][name], state["v"][name]
            m.mul_(b1).add_((1 - b1) * g32)
            v.mul_(b2).add_((1 - b2) * g32 * g32)
            step = (m / bc1) / (torch.sqrt(v / bc2) + eps)
            if weight_decay:
                step = step + weight_decay * p
            p.sub_(lr * step)
        state["t"] = t
        return params, state

    return Optimizer(init, update)


def make_optimizer(cfg: TrainConfig) -> Optimizer:
    if cfg.optimizer == "sgdm":
        return sgd_momentum(cfg.momentum, cfg.weight_decay)
    if cfg.optimizer == "adamw":
        return adamw(cfg.adam_b1, cfg.adam_b2, cfg.adam_eps, cfg.weight_decay)
    raise ValueError(f"unknown optimizer {cfg.optimizer!r}")


def make_schedule(cfg: TrainConfig) -> Callable[[int], float]:
    """step -> lr.  'cosine' with warmup, the paper's 'step', or
    'constant'; float32 arithmetic throughout."""
    f32 = np.float32
    base = f32(cfg.lr)

    if cfg.schedule == "cosine":
        def sched(step: int) -> float:
            s = f32(step)
            warm = np.minimum(s / f32(max(cfg.warmup_steps, 1)), f32(1.0))
            frac = np.clip((s - f32(cfg.warmup_steps))
                           / f32(max(cfg.total_steps - cfg.warmup_steps, 1)),
                           f32(0.0), f32(1.0))
            return float(base * warm * f32(0.5)
                         * (f32(1.0) + np.cos(f32(math.pi) * frac)))
        return sched

    if cfg.schedule == "step":
        # the paper: multiply by gamma at given boundaries (in steps)
        bounds = np.asarray(cfg.lr_step_epochs, np.float32)

        def sched(step: int) -> float:
            n_hit = int(np.sum(f32(step) >= bounds))
            return float(base * f32(cfg.lr_step_gamma) ** n_hit)
        return sched

    if cfg.schedule == "constant":
        return lambda step: float(base)
    raise ValueError(f"unknown schedule {cfg.schedule!r}")
