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

A sharded model (``parallel.shard_module(model, mesh)`` before
``make_train_step``) trains its rank's shares: each rank feeds its data
rank's rows of the global batch, the collectives' backwards give every
rank the gradient of its shares (``parallel/comm.py``), and the step then
takes each gradient's mean over the data axes (pod and data).  A weight
the spec cuts over the data axes (FSDP) is held, with its master and
momentum, as this rank's share; its gradient arrives summed over the data
ranks by ``gather_on_use``'s backward (a reduce-scatter in rank order)
and is divided; every other gradient is summed in rank order
(``gather_sum``) and divided.  The global norm sums every cut tensor's
squares over the ranks that hold its other shares (data, then model),
so every rank clips by the unsharded norm and the tensors held whole
stay equal on every rank.  The update is elementwise and runs on the
shares as they are.  int8 gradient compression is not sharded.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.configs.base import TrainConfig
from repro_torch.device import synchronize
from .checkpoint import CheckpointManager, read_reference_snapshot
from .compress import compress_decompress, init_error_feedback
from .optim import clip_by_global_norm, make_optimizer, make_schedule

__all__ = ["TrainState", "trainable", "init_train_state", "make_train_step",
           "lm_loss_fn", "Trainer"]


@dataclasses.dataclass
class TrainState:
    params: dict        # name -> float32 master value
    opt_state: dict     # optimizer state (float32 tensors, ints)
    step: int = 0
    ef_error: Optional[dict] = None  # int8 compression's error feedback


def trainable(model: torch.nn.Module) -> dict[str, torch.nn.Parameter]:
    """name -> parameter, for every floating-point parameter."""
    return {n: p for n, p in model.named_parameters()
            if p.is_floating_point()}


def init_train_state(model: torch.nn.Module, tcfg: TrainConfig) -> TrainState:
    """Switches gradients on for every trainable tensor and takes the
    float32 master values (the tensor itself when it is float32)."""
    if tcfg.grad_compression not in ("none", "int8"):
        raise ValueError(f"grad_compression {tcfg.grad_compression!r} not "
                         f"in ('none', 'int8')")
    params = {}
    for name, p in trainable(model).items():
        p.requires_grad_(True)
        params[name] = (p.detach() if p.dtype == torch.float32
                        else p.detach().float())
    state = TrainState(params=params,
                       opt_state=make_optimizer(tcfg).init(params))
    if tcfg.grad_compression == "int8":
        state.ef_error = init_error_feedback(params)
    return state


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
    With ``tcfg.grad_compression == "int8"`` the gradients then take the
    error-feedback Q/DQ round trip (``compress_decompress``, the residual
    in ``state.ef_error``) before clipping, where the reference's step
    applies it.
    """
    opt = make_optimizer(tcfg)
    sched = make_schedule(tcfg)
    live = trainable(model)
    loss_fn = loss_fn or lm_loss_fn
    sharded = _Sharded.of(model, live, tcfg)

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

        if sharded is not None:
            grads = sharded.data_mean(grads)
        if tcfg.grad_compression == "int8":
            grads, state.ef_error = compress_decompress(grads,
                                                        state.ef_error)
        if tcfg.grad_clip:
            norm = sharded.global_norm(grads) if sharded is not None \
                else None
            grads, gnorm = clip_by_global_norm(grads, tcfg.grad_clip, norm)
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


@dataclasses.dataclass
class _Sharded:
    """A sharded model's step: its data axes (pod and data, flattened),
    its model axis and the names of the trainable tensors the spec splits
    over "model" (``split``) and over the data axes (``fsdp``)."""

    dp: object
    model_axis: object
    split: list
    fsdp: list

    @classmethod
    def of(cls, model, live: dict, tcfg: TrainConfig):
        mesh = getattr(model, "mesh", None)
        if mesh is None:
            return None
        from repro_torch.parallel.comm import MeshAxis

        if tcfg.grad_compression != "none":
            raise NotImplementedError(
                "int8 gradient compression of a sharded model")
        split = [n for n, p in model.placements.items()
                 if p.model_split and n in live]
        fsdp = [n for n, p in model.placements.items()
                if p.data_split and n in live]
        return cls(model.data_axis, MeshAxis.of(mesh, "model"), split, fsdp)

    def data_mean(self, grads: dict) -> dict:
        """Each gradient's mean over the data ranks: an FSDP share's
        arrives summed (in rank order), the others are added in rank
        order here."""
        from repro_torch.parallel.comm import gather_sum

        summed = set(self.fsdp)
        return {n: (g if n in summed else gather_sum(g, self.dp)
                    ).div_(self.dp.size) for n, g in grads.items()}

    def global_norm(self, grads: dict) -> torch.Tensor:
        """The unsharded model's global norm: the FSDP shares' sums of
        squares summed over the data ranks, then the model-split tensors'
        over the model ranks (each in rank order), then every tensor's in
        the tree's order (the order ``optim.global_norm`` adds them
        in)."""
        from repro_torch.parallel.comm import gather_sum

        sq = {n: torch.sum(torch.square(g.float()))
              for n, g in grads.items()}
        for names, axis in ((self.fsdp, self.dp),
                            (self.split, self.model_axis)):
            if names:
                tot = gather_sum(torch.stack([sq[n] for n in names]), axis)
                sq.update(zip(names, tot))
        return torch.sqrt(sum(sq.values()))


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
        tree = {"params": self.state.params,
                "opt_state": self.state.opt_state}
        if self.state.ef_error is not None:
            tree["ef_error"] = self.state.ef_error
        return tree

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
                elif head == "ef_error":
                    self.state.ef_error[name].copy_(torch.from_numpy(arr))
                elif name in opt and not isinstance(opt[name], dict):
                    opt[name] = int(arr)  # a step count
                else:
                    group, _, leaf = name.partition("/")
                    opt[group][leaf].copy_(torch.from_numpy(arr))
            self._write_back()
        self.state.step = int(meta["step"])
        return self.state.step

    def _write_back(self) -> None:
        """The master values into the model's tensors."""
        with torch.no_grad():
            for name, p in trainable(self.model).items():
                master = self.state.params[name]
                if master.data_ptr() != p.data_ptr():
                    p.copy_(master)

    def load_reference_snapshot(self, path: str) -> int:
        """Resume from a snapshot the reference's ``Trainer`` wrote
        (``save_pytree`` of its ``{"params", "opt_state"}``): the master
        values, the optimizer's moments (and adamw's step count) and the
        step of its ``.meta``.  Names are mapped through the bridge
        (``flatten_reference_tree``); a missing, unexpected or misshapen
        leaf raises, and so does a snapshot stamped under another plan
        than this trainer's.  The reference does not save the
        error-feedback residual, so it restarts at zero, as the
        reference's own resume does.  Returns the step."""
        from repro_torch.bridge import flatten_reference_tree

        tree, meta = read_reference_snapshot(path)
        meta = meta or {}
        saved_fp = meta.get("plan_fingerprint")
        fp = self.ckpt.plan_fingerprint if self.ckpt is not None else None
        if fp is not None and saved_fp is not None and saved_fp != fp:
            raise RuntimeError(f"snapshot {path} was written under sparsity "
                               f"plan {saved_fp}, this trainer's is {fp}")

        def load(into: dict, flat: dict, what: str) -> None:
            missing = sorted(set(into) - set(flat))
            unexpected = sorted(set(flat) - set(into))
            if missing or unexpected:
                raise ValueError(f"{what}: names differ from the port's: "
                                 f"missing {missing}, unexpected "
                                 f"{unexpected}")
            for name, arr in flat.items():
                if tuple(arr.shape) != tuple(into[name].shape):
                    raise ValueError(f"{what} {name}: shape {arr.shape} != "
                                     f"{tuple(into[name].shape)}")
                into[name].copy_(torch.from_numpy(
                    np.asarray(arr, np.float32)))

        opt, saved = self.state.opt_state, tree.get("opt_state", {})
        with torch.no_grad():
            load(self.state.params,
                 flatten_reference_tree(self.model, tree["params"]),
                 "params")
            for group, moments in opt.items():
                if isinstance(moments, dict):
                    load(moments,
                         flatten_reference_tree(self.model, saved[group]),
                         f"opt_state/{group}")
                else:
                    opt[group] = int(np.asarray(saved[group]))
        self._write_back()
        self.state.step = int(meta.get("step", 0))
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
