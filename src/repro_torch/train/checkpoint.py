"""Checkpointing: atomic .npz snapshots, async writer, auto-resume.

The port of ``repro/train/checkpoint.py`` for the port's own training
state (nested dicts of tensors and ints, flattened to ``a/b/c`` keys):

  * ``save`` writes to a temp file, then ``os.replace``s it, so a crash
    mid-write never corrupts the latest checkpoint; the small json
    ``.meta`` beside it is written the same way;
  * ``save(..., blocking=False)`` hands the host copy to a writer thread,
    so the train loop does not stall on disk (the device-to-host copy
    still happens in ``save``: the snapshot is consistent);
  * ``latest_step`` / ``restore`` implement auto-resume after a restart;
  * a retention policy keeps the newest ``keep`` checkpoints;
  * ``plan_fingerprint`` (``SparsityPlan.fingerprint()``) is stamped into
    every snapshot's metadata, and ``restore`` refuses a snapshot stamped
    under another plan: masks are rebuilt from the plan, so the same
    values under another plan are another network (an RBGP4 checkpoint
    restored into a chain model would scramble its values silently).
    Snapshots or managers without a stamp skip the check.  The plan's
    ``quant`` enters the fingerprint, so a weight-only int8 snapshot
    (``launch/train.py --quant int8``) and a full-precision one refuse
    each other; int8 leaves keep their dtype through the ``.npz``.

``read_reference_snapshot`` reads a snapshot that the reference's
``save_pytree`` wrote (its ``Trainer``'s ``{"params", "opt_state"}``):
the keys are ``path_str`` over the pytree, dict keys, attribute names and
sequence indices joined by ``/``, with ``__none__/`` leaves for the
absent ones.  It rebuilds the nested tree (numpy only, no JAX), which
``Trainer.load_reference_snapshot`` maps through the bridge's
``flatten_reference_tree`` onto the port's names.
"""
from __future__ import annotations

import json
import os
import queue
import re
import threading
from typing import Any, Optional

import numpy as np
import torch

__all__ = ["CheckpointManager", "save_tree", "load_tree", "flatten_tree",
           "read_reference_snapshot"]


def flatten_tree(tree, prefix: str = "") -> dict[str, Any]:
    """{"a/b/c": leaf} for a tree of nested dicts; leaves are tensors,
    arrays or numbers."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flatten_tree(v, f"{prefix}/{k}" if prefix else str(k)))
        return out
    return {prefix: tree}


def _to_host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save_tree(path: str, host_tree: dict, extra: Optional[dict] = None):
    """Atomic write of a flattened host snapshot (+ json metadata)."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **host_tree)
    os.replace(tmp, path)
    if extra is not None:
        mtmp = path + ".meta.tmp"
        with open(mtmp, "w") as f:
            json.dump(extra, f)
        os.replace(mtmp, path + ".meta")


def load_tree(path: str, like: dict) -> dict[str, np.ndarray]:
    """{"a/b/c": array} for every leaf of ``like``; a missing leaf or a
    shape that differs raises."""
    with np.load(path, allow_pickle=False) as data:
        out = {}
        for key, leaf in flatten_tree(like).items():
            if key not in data:
                raise KeyError(f"checkpoint {path} misses leaf {key!r}")
            arr = data[key]
            want = tuple(np.shape(leaf))
            if tuple(arr.shape) != want:
                raise ValueError(f"{key}: shape {arr.shape} != {want}")
            out[key] = arr
    return out


def _lists(node):
    """Dicts keyed '0', '1', ... back to lists (sequence indices in a
    ``path_str`` key), recursively."""
    if not isinstance(node, dict):
        return node
    node = {k: _lists(v) for k, v in node.items()}
    if node and all(k.isdigit() for k in node) and \
            sorted(int(k) for k in node) == list(range(len(node))):
        return [node[str(i)] for i in range(len(node))]
    return node


def read_reference_snapshot(path: str) -> tuple[dict, Optional[dict]]:
    """(tree, meta) of a snapshot written by the reference's
    ``repro.train.checkpoint.save_pytree``: the nested tree rebuilt from
    its ``/``-joined keys (absent ``__none__/`` leaves left out, sequence
    indices as lists) and the json ``.meta`` beside it (None without
    one)."""
    tree: dict = {}
    with np.load(path, allow_pickle=False) as data:
        for key in data.files:
            if key.startswith("__none__/"):
                continue
            parts = key.split("/")
            node = tree
            for part in parts[:-1]:
                node = node.setdefault(part, {})
            node[parts[-1]] = data[key]
    meta = None
    if os.path.exists(path + ".meta"):
        with open(path + ".meta") as f:
            meta = json.load(f)
    return _lists(tree), meta


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3,
                 plan_fingerprint: Optional[str] = None):
        self.dir = directory
        self.keep = keep
        self.plan_fingerprint = plan_fingerprint
        os.makedirs(directory, exist_ok=True)
        self._q: queue.Queue = queue.Queue()
        self._worker: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # -- paths ------------------------------------------------------------
    def path(self, step: int) -> str:
        return os.path.join(self.dir, f"ckpt_{step:08d}.npz")

    def steps(self) -> list[int]:
        out = []
        for fn in os.listdir(self.dir):
            m = re.fullmatch(r"ckpt_(\d+)\.npz", fn)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    # -- save/restore -------------------------------------------------------
    def _write(self, step: int, host_tree: dict, extra: dict):
        save_tree(self.path(step), host_tree, extra)
        self._gc()

    def _gc(self):
        for s in self.steps()[: -self.keep]:
            for suffix in (".npz", ".npz.meta"):
                p = os.path.join(self.dir, f"ckpt_{s:08d}{suffix}")
                if os.path.exists(p):
                    os.remove(p)

    def save(self, step: int, tree: dict, extra: Optional[dict] = None,
             blocking: bool = True) -> None:
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("async checkpoint writer failed") from err
        # device -> host copy happens here (consistent snapshot)
        host_tree = {k: _to_host(v) for k, v in flatten_tree(tree).items()}
        extra = dict(extra or {}, step=step)
        if self.plan_fingerprint is not None:
            extra.setdefault("plan_fingerprint", self.plan_fingerprint)
        if blocking:
            self._write(step, host_tree, extra)
            return
        self._ensure_worker()
        self._q.put((step, host_tree, extra))

    def _ensure_worker(self):
        if self._worker is not None and self._worker.is_alive():
            return

        def run():
            while True:
                item = self._q.get()
                if item is None:
                    return
                try:
                    self._write(*item)
                except BaseException as e:  # surfaced on the next save()
                    self._error = e

        self._worker = threading.Thread(target=run, daemon=True)
        self._worker.start()

    def wait(self):
        """Drain the async writer (call before exit)."""
        if self._worker is not None and self._worker.is_alive():
            self._q.put(None)
            self._worker.join()
            self._worker = None

    def restore(self, like: dict, step: Optional[int] = None):
        """(flat {"a/b/c": array} for the leaves of ``like``, meta), or
        (None, None) when there is no checkpoint."""
        step = step if step is not None else self.latest_step()
        if step is None:
            return None, None
        meta_path = self.path(step) + ".meta"
        meta = None
        if os.path.exists(meta_path):
            with open(meta_path) as f:
                meta = json.load(f)
        saved_fp = (meta or {}).get("plan_fingerprint")
        if (self.plan_fingerprint is not None and saved_fp is not None
                and saved_fp != self.plan_fingerprint):
            raise RuntimeError(
                f"checkpoint {self.path(step)} was written under sparsity "
                f"plan {saved_fp} but the current plan is "
                f"{self.plan_fingerprint}: masks are rebuilt from the plan, "
                f"so these weights do not mean the same network. Restore "
                f"with the original plan (--plan), or point "
                f"--checkpoint-dir at a fresh directory.")
        return load_tree(self.path(step), like), (meta or {"step": step})
