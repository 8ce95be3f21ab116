"""Train loop: microbatch accumulation, clipping, schedule, checkpoints.

The port of ``repro/train/loop.py``.  ``make_train_step`` builds one step
over a ``TrainState``; ``Trainer`` wraps it with data, checkpointing,
auto-resume and step-time straggler monitoring.  The loss is the language
model's own (``model.loss``) unless a ``loss_fn(model, batch) -> (loss,
metrics)`` is given, the reference's interface, which drives the vision
models (with knowledge distillation where the loss asks for it).

Parameters and precision.  The reference keeps float32 parameters and
casts them to the compute dtype at every call, so its gradient is the
compute-dtype gradient widened to float32, and its update is applied to
the float32 values.  Here the model's tensors hold the compute-dtype copy
(what serving reads, cast once), and ``TrainState.params`` holds the
float32 master values.  A step runs forward and backward on the model,
widens each gradient to float32, updates the master values and writes
them back to the model, rounded to the compute dtype.  With float32
compute the master value *is* the model's tensor (no second copy).  With
bfloat16 compute the master values start from the model's values, which
are the bfloat16-rounded draw: that differs from the reference's float32
init only in the low bits of a random draw.

Trainable are all floating-point parameters of the model (embedding,
head, norm scales, compact ``w_data``, dense and masked ``w``, biases), as
the reference's ``split_trainable``; weight decay applies to all of them.
The masks of masked storage are integer buffers, never trained.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.configs.base import TrainConfig
from repro_torch.device import synchronize
from .checkpoint import CheckpointManager
from .optim import clip_by_global_norm, make_optimizer, make_schedule

__all__ = ["TrainState", "trainable", "init_train_state", "make_train_step",
           "lm_loss_fn", "Trainer"]


@dataclasses.dataclass
class TrainState:
    params: dict        # name -> float32 master value
    opt_state: dict     # optimizer state (float32 tensors, ints)
    step: int = 0


def trainable(model: torch.nn.Module) -> dict[str, torch.nn.Parameter]:
    """name -> parameter, for every floating-point parameter."""
    return {n: p for n, p in model.named_parameters()
            if p.is_floating_point()}


def init_train_state(model: torch.nn.Module, tcfg: TrainConfig) -> TrainState:
    """Switches gradients on for every trainable tensor and takes the
    float32 master values (the tensor itself when it is float32)."""
    params = {}
    for name, p in trainable(model).items():
        p.requires_grad_(True)
        params[name] = (p.detach() if p.dtype == torch.float32
                        else p.detach().float())
    return TrainState(params=params,
                      opt_state=make_optimizer(tcfg).init(params))


LossFn = Callable[[torch.nn.Module, dict], tuple]


def lm_loss_fn(model: torch.nn.Module, batch: dict) -> tuple:
    """The language model's training loss and its ``ce``/``aux`` metrics."""
    loss, (ce, aux) = model.loss(batch, train=True)
    return loss, {"ce": ce, "aux": aux}


def make_train_step(model: torch.nn.Module, tcfg: TrainConfig,
                    loss_fn: Optional[LossFn] = None):
    """step(state, batch) -> (state, metrics) on ``loss_fn(model, batch)
    -> (loss, metrics)``, by default the model's LM loss.

    With ``tcfg.microbatches > 1`` the batch carries a leading microbatch
    axis (n_micro, per_micro, ...); the float32 gradients are summed over
    the microbatches and divided by their number, as the reference's scan.
    """
    opt = make_optimizer(tcfg)
    sched = make_schedule(tcfg)
    live = trainable(model)
    loss_fn = loss_fn or lm_loss_fn

    def grads_of(batch):
        for p in live.values():
            p.grad = None
        loss, metrics = loss_fn(model, batch)
        metrics = {k: torch.as_tensor(v).detach() for k, v in metrics.items()}
        loss.backward()
        # widen each gradient and release its compute-dtype copy at once,
        # so the two are never held for the whole model together
        grads = {}
        for n, p in live.items():
            grads[n] = (p.grad.float() if p.grad is not None
                        else torch.zeros_like(p, dtype=torch.float32))
            p.grad = None
        return loss.detach().float(), metrics, grads

    def step_fn(state: TrainState, batch: dict):
        if tcfg.microbatches > 1:
            n = tcfg.microbatches
            grads = {name: torch.zeros_like(p, dtype=torch.float32)
                     for name, p in live.items()}
            loss = 0.0
            for i in range(n):
                mb_loss, metrics, g = grads_of({k: v[i]
                                                for k, v in batch.items()})
                for name in grads:
                    grads[name].add_(g[name])
                loss = loss + mb_loss
            for g in grads.values():
                g.div_(n)
            loss = loss / n
        else:
            loss, metrics, grads = grads_of(batch)

        if tcfg.grad_clip:
            grads, gnorm = clip_by_global_norm(grads, tcfg.grad_clip)
        else:
            gnorm = torch.zeros(())
        lr = sched(state.step)
        opt.update(grads, state.opt_state, state.params, lr)
        with torch.no_grad():
            for name, p in live.items():
                master = state.params[name]
                if master.data_ptr() != p.data_ptr():
                    p.copy_(master)
        state.step += 1
        return state, {"loss": loss, "grad_norm": gnorm, "lr": lr, **metrics}

    return step_fn


class Trainer:
    """Drives the step function: data, checkpoints, resume, stragglers."""

    def __init__(self, model: torch.nn.Module, tcfg: TrainConfig, data_iter,
                 *, checkpoint: bool = True,
                 plan_fingerprint: Optional[str] = None,
                 loss_fn: Optional[LossFn] = None):
        self.model = model
        self.device = next(model.parameters()).device
        self.tcfg = tcfg
        self.data = iter(data_iter)
        self.state = init_train_state(model, tcfg)
        self.step_fn = make_train_step(model, tcfg, loss_fn)
        # the sparsity-plan stamp: saved beside the weights, checked on
        # restore
        self.ckpt = (CheckpointManager(tcfg.checkpoint_dir,
                                       plan_fingerprint=plan_fingerprint)
                     if checkpoint else None)
        # hook(step, metrics) after every step
        self.hooks: list = []
        self.history: list[dict] = []
        # straggler watchdog: EMA of step time; steps > 3x EMA are flagged
        self._ema: Optional[float] = None
        self.straggler_events: list[tuple[int, float]] = []

    def _tree(self) -> dict:
        return {"params": self.state.params,
                "opt_state": self.state.opt_state}

    # -- resume ------------------------------------------------------------
    def try_resume(self) -> Optional[int]:
        if self.ckpt is None:
            return None
        flat, meta = self.ckpt.restore(self._tree())
        if flat is None:
            return None
        opt = self.state.opt_state
        with torch.no_grad():
            for key, arr in flat.items():
                head, _, name = key.partition("/")
                if head == "params":
                    self.state.params[name].copy_(torch.from_numpy(arr))
                elif name in opt and not isinstance(opt[name], dict):
                    opt[name] = int(arr)  # a step count
                else:
                    group, _, leaf = name.partition("/")
                    opt[group][leaf].copy_(torch.from_numpy(arr))
            for name, p in trainable(self.model).items():
                master = self.state.params[name]
                if master.data_ptr() != p.data_ptr():
                    p.copy_(master)
        self.state.step = int(meta["step"])
        return self.state.step

    # -- main loop -----------------------------------------------------------
    def _to_device(self, batch: dict) -> dict:
        return {k: torch.as_tensor(np.asarray(v)).to(self.device)
                for k, v in batch.items()}

    def _shape_batch(self, batch: dict) -> dict:
        n = self.tcfg.microbatches
        if n <= 1:
            return batch
        out = {}
        for k, x in batch.items():
            b = x.shape[0]
            if b % n:
                raise ValueError(f"batch {b} not divisible by {n} "
                                 f"microbatches")
            out[k] = x.reshape(n, b // n, *x.shape[1:])
        return out

    def run(self, n_steps: int,
            fail_at_step: Optional[int] = None) -> list[dict]:
        """fail_at_step: raise a simulated node failure (tests, drills)."""
        start = self.state.step
        try:
            for i in range(start, start + n_steps):
                if fail_at_step is not None and i == fail_at_step:
                    raise RuntimeError(f"simulated node failure at step {i}")
                batch = self._shape_batch(self._to_device(next(self.data)))
                synchronize(self.device)
                t0 = time.perf_counter()
                self.state, metrics = self.step_fn(self.state, batch)
                metrics = {k: float(v) for k, v in metrics.items()}
                synchronize(self.device)
                dt = time.perf_counter() - t0
                if self._ema is None:
                    self._ema = dt
                else:
                    if dt > 3.0 * self._ema and i > start + 2:
                        self.straggler_events.append((i, dt))
                    self._ema = 0.9 * self._ema + 0.1 * dt
                metrics.update(step=i, step_time_s=dt)
                self.history.append(metrics)
                for h in self.hooks:
                    h(i, metrics)
                if self.ckpt is not None and \
                        (i + 1) % self.tcfg.checkpoint_every == 0:
                    self.save(i + 1)
            if self.ckpt is not None:
                self.save(self.state.step)
        finally:
            # drain pending async writes even when unwinding on a failure:
            # the latest durable snapshot must be on disk before a restart
            # reads it
            if self.ckpt is not None:
                self.ckpt.wait()
        return self.history

    def save(self, step: int):
        """Snapshot the state; the file is written by the async writer."""
        self.ckpt.save(step, self._tree(), extra={"step": step},
                       blocking=False)
