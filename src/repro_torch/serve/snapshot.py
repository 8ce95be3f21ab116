"""Crash-consistent engine snapshots: save/restore of serving state.

The port of ``repro/serve/snapshot.py``.  A snapshot holds everything on
the host an engine needs to finish its in-flight work: the request table
(prompts, generated prefixes, lifecycle states, retry and backoff
counters, deadlines), the engine clock, the rid counter and the stats,
and deliberately no KV pages.  Live requests restore as QUEUED with their
prefix and come back through the re-prefill path preemption uses, so an
engine rebuilt from a snapshot finishes every in-flight request with the
same greedy tokens.  The write is atomic (``train.checkpoint.save_tree``:
a temp file, then ``os.replace``), so a crash mid-write never corrupts
the previous snapshot.

The serving plan's ``fingerprint()`` is stamped into the metadata, and
:func:`restore_engine` refuses to rebuild under another plan: the engine's
outputs are a function of the plan's masks.  Snapshots or restores without
a stamp skip the check.
"""
from __future__ import annotations

import json
import os
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.train.checkpoint import save_tree

from .lifecycle import LIVE_STATES, QUEUED, TERMINAL_STATES, RequestError
from .sampling import SamplingParams

__all__ = ["SNAPSHOT_VERSION", "save_engine", "restore_engine"]

SNAPSHOT_VERSION = 1


def _req_key(rid: int) -> str:
    return f"req_{rid:08d}"


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def save_engine(engine, path: str) -> dict:
    """Write a crash-consistent snapshot of ``engine`` to ``path`` (.npz +
    .meta json).  Call between ``step()``s: the snapshot captures the
    engine at a step boundary.  Returns the metadata dict."""
    tree: dict[str, np.ndarray] = {}
    records = {}
    for rid, req in engine.requests.items():
        gen = (np.asarray(req.generated, np.int32).reshape(
                   (len(req.generated),) + req.prompt.shape[1:])
               if req.generated
               else np.zeros((0,) + req.prompt.shape[1:], np.int32))
        tree[f"{_req_key(rid)}/prompt"] = req.prompt
        tree[f"{_req_key(rid)}/generated"] = gen
        err = None
        if req.error is not None:
            err = {"reason": req.error.reason, "message": str(req.error)}
        records[str(rid)] = {
            "state": req.state,
            "arrival_step": req.arrival_step,
            "priority": req.priority,
            "deadline_step": req.deadline_step,
            "max_new_tokens": req.max_new_tokens,
            "preemptions": req.preemptions,
            "restarts": req.restarts,
            "not_before": req.not_before,
            "sampling": {"temperature": req.sampling.temperature,
                         "top_k": req.sampling.top_k,
                         "seed": req.sampling.seed},
            "error": err,
        }
    meta = {
        "snapshot_version": SNAPSHOT_VERSION,
        "kind": engine.kind,
        "clock": engine._clock,
        "next_rid": engine._next_rid,
        "plan_fingerprint": getattr(engine, "plan_fingerprint", None),
        "cache_dtype": _dtype_name(engine.cache_dtype),
        "init_kw": dict(engine._init_kw),
        "requests": records,
        "stats": {k: v for k, v in engine.stats.items()},
    }
    save_tree(path, tree, extra=meta)
    engine._obs.instant("snapshot", step=engine._clock,
                        requests=len(records))
    return meta


def restore_engine(path: str, model, *, plan=None,
                   plan_fingerprint: Optional[str] = None,
                   engine_cls=None, **overrides) -> Any:
    """Rebuild an engine from a snapshot written by :func:`save_engine`.

    Live requests re-enter as QUEUED with their generated prefix and
    resume through the re-prefill path; terminal requests restore with
    their tokens and final states.  ``plan`` (its ``fingerprint()``) or an
    explicit ``plan_fingerprint`` is checked against the snapshot's stamp,
    and a mismatch is refused, as ``CheckpointManager.restore`` refuses
    one.  ``engine_cls`` overrides the engine class (by default the kind
    recorded in the snapshot, through ``make_engine``); ``overrides``
    replace recorded constructor arguments.
    """
    meta_path = path + ".meta"
    if not os.path.exists(meta_path):
        raise FileNotFoundError(
            f"snapshot {path} has no metadata ({meta_path}); it was not "
            f"written by serve.snapshot.save_engine")
    with open(meta_path) as f:
        meta = json.load(f)
    version = meta.get("snapshot_version")
    if version != SNAPSHOT_VERSION:
        raise ValueError(
            f"snapshot {path} has version {version}; this build reads "
            f"version {SNAPSHOT_VERSION}")

    current_fp = plan_fingerprint
    if current_fp is None and plan is not None:
        current_fp = plan.fingerprint()
    saved_fp = meta.get("plan_fingerprint")
    if (current_fp is not None and saved_fp is not None
            and current_fp != saved_fp):
        raise RuntimeError(
            f"snapshot {path} was written under sparsity plan {saved_fp} "
            f"but the current plan is {current_fp}: the engine's outputs "
            f"are a function of the plan's masks, so these requests would "
            f"not resume the same generation.  Restore with the original "
            f"plan, or start a fresh engine."
        )

    from .engine import Request, make_engine

    kw = dict(meta["init_kw"])
    kw["cache_dtype"] = getattr(torch, meta["cache_dtype"])
    if plan is not None:
        kw["plan"] = plan
    kw.update(overrides)
    if engine_cls is not None:
        engine = engine_cls(model, **kw)
    else:
        engine = make_engine(meta["kind"], model, **kw)

    with np.load(path, allow_pickle=False) as data:
        for rid_s, rec in sorted(meta["requests"].items(),
                                 key=lambda kv: int(kv[0])):
            rid = int(rid_s)
            prompt = data[f"{_req_key(rid)}/prompt"]
            gen = data[f"{_req_key(rid)}/generated"]
            state = rec["state"]
            err = rec.get("error")
            req = Request(
                rid=rid, prompt=prompt,
                max_new_tokens=int(rec["max_new_tokens"]),
                sampling=SamplingParams(**rec["sampling"]),
                arrival_step=int(rec["arrival_step"]),
                priority=int(rec["priority"]),
                deadline_step=rec["deadline_step"],
                generated=list(gen),
                preemptions=int(rec["preemptions"]),
                restarts=int(rec["restarts"]),
                not_before=int(rec["not_before"]),
                error=(RequestError(err["reason"], err["message"], rid=rid)
                       if err else None),
            )
            if state in TERMINAL_STATES:
                req.state = state
                engine.requests[rid] = req
                engine.finished[rid] = req
            elif state in LIVE_STATES:
                # mid-flight at the crash: QUEUED with its prefix; the
                # scheduler re-admits it and the engine re-prefills
                # prompt ++ prefix (the path preemption uses)
                req.state = QUEUED
                engine.requests[rid] = req
                engine.scheduler.submit(req)
            else:
                raise ValueError(f"snapshot request {rid}: unknown state "
                                 f"{state!r}")
    engine._clock = int(meta["clock"])
    engine._next_rid = int(meta["next_rid"])
    engine.stats.update(meta.get("stats", {}))
    return engine
