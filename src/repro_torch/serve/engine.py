"""Serving engine: continuous batching over a paged KV cache.

The port of ``repro/serve/engine.py`` for the main serving path:

  * :class:`ContinuousEngine` — ``submit()`` enqueues, ``step()`` admits
    and prefills newly admitted requests (one reference prefill each, at
    the exact prompt length, then a scatter of the cache into pages) and
    runs one batched decode step over all live rows through per-request
    block tables; ``drain()`` runs to completion.
  * :func:`run_sequential` — one request at a time through ``prefill`` /
    ``decode_step`` with a contiguous cache: the semantic oracle the engine
    must reproduce token for token under greedy sampling.

Every projection of both goes through ``rbgp4mm_rhs`` (the CUDA kernel on
the card).  ``stats["prefill_time_s"]`` and ``stats["decode_time_s"]`` are
fenced with ``torch.cuda.synchronize()`` on the card, so they measure the
work and not its dispatch.  Given ``plan=``, the engine grows its
admission budget by the weight bytes the plan frees (plan-aware
admission, ``scheduler.plan_aware_live_tokens``).  The static engine,
chunked prefill, preemption, prefix sharing, faults, snapshots and the
observability recorder come with later slices.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.device import synchronize

from .cache import PagedKVCache, blocks_for_tokens
from .lifecycle import (DECODING, FINISHED, PREFILLING, QUEUED,
                        RequestError, transition)
from .sampling import SamplingParams, sample_token
from .scheduler import FCFSScheduler, plan_aware_live_tokens

__all__ = ["Request", "ServingEngine", "ContinuousEngine", "run_sequential",
           "make_engine"]


@dataclasses.dataclass(eq=False)   # identity equality: ndarray fields
class Request:
    rid: int
    prompt: np.ndarray               # (S,) int32
    max_new_tokens: int
    sampling: SamplingParams = dataclasses.field(default_factory=SamplingParams)
    arrival_step: int = 0
    generated: list = dataclasses.field(default_factory=list)
    blocks: list = dataclasses.field(default_factory=list)
    slot: Optional[int] = None
    reserved_blocks: int = 0
    state: str = QUEUED

    @property
    def prompt_len(self) -> int:
        return self.prompt.shape[0]

    @property
    def done(self) -> bool:
        return len(self.generated) >= self.max_new_tokens

    @property
    def input_pos(self) -> int:
        """Position of the next decode input (the last sampled token)."""
        return self.prompt_len + len(self.generated) - 1

    @property
    def tokens(self) -> np.ndarray:
        return np.stack(self.generated) if self.generated else \
            np.zeros((0,), np.int32)


class ServingEngine:
    """submit()/step()/drain() surface."""

    kind = "base"

    def __init__(self, model, *, cache_dtype=torch.float32):
        self.model = model
        self.cfg = model.cfg
        self.device = model.device
        self.cache_dtype = cache_dtype
        self.requests: dict[int, Request] = {}
        self.finished: dict[int, Request] = {}
        self._next_rid = 0
        self._clock = 0
        self.stats = {
            "steps": 0, "prefill_calls": 0, "decode_steps": 0,
            "prompt_tokens": 0, "generated_tokens": 0,
            "prefill_time_s": 0.0, "decode_time_s": 0.0,
            "rejected": 0, "finished": 0,
        }

    def submit(self, prompt, max_new_tokens: int,
               sampling: Optional[SamplingParams] = None,
               arrival_step: int = 0) -> int:
        """Enqueue a request; returns its rid.  Rejections raise
        :class:`RequestError` with a ``reason`` code."""
        prompt = np.asarray(prompt, np.int32)
        if prompt.ndim != 1 or prompt.shape[0] < 1:
            self.stats["rejected"] += 1
            raise RequestError("bad_prompt", f"prompt shape {prompt.shape}")
        if max_new_tokens < 1:
            self.stats["rejected"] += 1
            raise RequestError("bad_max_new_tokens",
                               f"max_new_tokens={max_new_tokens}")
        rid = self._next_rid
        req = Request(rid=rid, prompt=prompt, max_new_tokens=max_new_tokens,
                      sampling=sampling or SamplingParams(),
                      arrival_step=arrival_step)
        try:
            self._enqueue(req)
        except RequestError:
            self.stats["rejected"] += 1
            raise
        self._next_rid += 1
        self.requests[rid] = req
        return rid

    def step(self) -> list[Request]:
        raise NotImplementedError

    @property
    def idle(self) -> bool:
        raise NotImplementedError

    def drain(self, max_steps: int = 100_000) -> dict[int, np.ndarray]:
        """Run steps until every submitted request completed."""
        steps = 0
        while not self.idle:
            self.step()
            steps += 1
            if steps > max_steps:
                raise RuntimeError(f"engine did not drain in {max_steps} steps")
        return {rid: r.tokens for rid, r in sorted(self.finished.items())}

    def _enqueue(self, req: Request) -> None:
        raise NotImplementedError

    @contextlib.contextmanager
    def _timed(self, key: str):
        """Add the fenced wall time of the block to ``stats[key]``."""
        synchronize(self.device)
        t0 = time.perf_counter()
        yield
        synchronize(self.device)
        self.stats[key] += time.perf_counter() - t0

    def _sample(self, req: Request, logits_row: np.ndarray) -> None:
        tok = sample_token(logits_row, req.sampling, request_salt=req.rid,
                           step=len(req.generated))
        req.generated.append(tok)
        self.stats["generated_tokens"] += 1

    def _mark_finished(self, req: Request) -> None:
        self.finished[req.rid] = req
        if req.state == FINISHED:
            self.stats["finished"] += 1

    def _transition(self, req: Request, to: str) -> None:
        transition(req, to, clock=self._clock)


def _host_logits(logits: torch.Tensor) -> np.ndarray:
    """Logits as a float32 host array (bf16 -> f32 is exact)."""
    return logits.float().cpu().numpy()


class ContinuousEngine(ServingEngine):
    """Continuous batching with a paged KV cache.

    page_size:        tokens per cache block.
    max_slots:        decode-batch rows (concurrent requests).
    n_blocks:         physical pool blocks incl. the reserved trash block;
                      0 = enough for max_slots full-length requests.
    max_live_tokens:  admission budget over sum(prompt + max_new) of the
                      running set; 0 = bounded only by pool capacity.
    max_request_len:  longest admissible prompt + max_new (sets the block
                      table width, and with it the slots a decode row
                      attends over).
    plan:             optional ``SparsityPlan`` of the served weights.  With
                      a non-zero ``max_live_tokens`` the admission budget
                      grows by the weight bytes the plan frees
                      (``scheduler.plan_aware_live_tokens``, the bytes
                      sized by the served values' floating dtype); the
                      pool's capacity still caps admission.
    """

    kind = "continuous"

    def __init__(self, model, *, page_size: int = 8, max_slots: int = 8,
                 n_blocks: int = 0, max_live_tokens: int = 0,
                 max_request_len: int = 0, cache_dtype=torch.float32,
                 plan=None):
        super().__init__(model, cache_dtype=cache_dtype)
        self.page = page_size
        self.max_slots = max_slots
        self.max_request_len = max_request_len or self.cfg.max_seq_len
        self.max_blocks = blocks_for_tokens(self.max_request_len, page_size)
        if n_blocks <= 0:
            n_blocks = 1 + max_slots * self.max_blocks
        self.kv = PagedKVCache(model, n_blocks, page_size, cache_dtype)
        self.base_live_tokens = max_live_tokens
        self.plan = plan
        self.plan_fingerprint = (plan.fingerprint() if plan is not None
                                 else None)
        if plan is not None and max_live_tokens > 0:
            from repro_torch.sparsity import model_matmul_shapes

            # the freed bytes are weight residency: size them by the
            # served values' dtype, not the KV cache's
            wdt = next((p.dtype for p in model.parameters()
                        if p.is_floating_point()), torch.float32)
            max_live_tokens = plan_aware_live_tokens(
                max_live_tokens, plan=plan,
                shapes=model_matmul_shapes(self.cfg),
                kv_bytes_per_token=self.kv_bytes_per_token(),
                value_bytes=wdt.itemsize)
        self.plan_live_tokens = max_live_tokens
        self.scheduler = FCFSScheduler(
            page_size=page_size, max_slots=max_slots,
            max_live_tokens=max_live_tokens,
            n_blocks_capacity=self.kv.allocator.n_total,
        )
        self.stats.update(block_steps=0, allocated_block_steps=0,
                          live_token_steps=0, peak_allocated_blocks=0,
                          decode_row_steps=0)

    def kv_bytes_per_token(self) -> float:
        """Cache bytes of one token over every layer's page pools."""
        total = sum(t.numel() * t.element_size()
                    for pool in self.kv.pools for t in pool.values())
        return total / max(self.kv.allocator.n_total * self.page, 1)

    @property
    def gather_tokens(self) -> int:
        """KV slots a decode row attends over (block-table width x page)."""
        return self.max_blocks * self.page

    @property
    def idle(self) -> bool:
        return self.scheduler.idle

    def _enqueue(self, req: Request) -> None:
        if req.prompt_len + req.max_new_tokens > self.max_request_len:
            raise RequestError(
                "too_long",
                f"request {req.rid}: prompt {req.prompt_len} + max_new "
                f"{req.max_new_tokens} exceeds max_request_len="
                f"{self.max_request_len}",
                rid=req.rid,
            )
        self.scheduler.submit(req)

    def step(self) -> list[Request]:
        """One engine tick: admit + prefill, then one batched decode."""
        finished: list[Request] = []
        batch = self.scheduler.admit()
        for req in batch:
            self._transition(req, PREFILLING)
        for req in batch:
            self._prefill_request(req)
            if req.done:
                self._finish(req, finished)
        self._decode_batch(finished)
        self.stats["steps"] += 1
        na = self.kv.allocator.n_allocated
        self.stats["allocated_block_steps"] += na
        self.stats["block_steps"] += self.kv.allocator.n_total
        self.stats["live_token_steps"] += sum(
            r.input_pos + 1 for r in self.scheduler.running.values())
        self.stats["peak_allocated_blocks"] = max(
            self.stats["peak_allocated_blocks"], na)
        self._clock += 1
        return finished

    def _prefill_request(self, req: Request) -> None:
        """Reference prefill at the exact prompt length, then page it."""
        L = req.prompt_len
        req.blocks = self.kv.allocator.alloc(self.kv.blocks_for(L))
        cache = self.model.init_cache(1, L, self.cache_dtype,
                                      full_length=True)
        with self._timed("prefill_time_s"):
            logits, cache = self.model.prefill(req.prompt[None], cache)
            logits = _host_logits(logits)
        self.kv.write_prefill(cache, req.blocks)
        self._sample(req, logits[0])
        self._transition(req, DECODING)
        self.stats["prefill_calls"] += 1
        self.stats["prompt_tokens"] += L

    def _decode_batch(self, finished: list[Request]) -> int:
        # sorted by rid: a deterministic row layout
        active = sorted(
            (r for r in self.scheduler.running.values() if not r.done),
            key=lambda r: r.rid)
        if not active:
            return 0
        for r in active:
            need = self.kv.blocks_for(r.input_pos + 1)
            if need > len(r.blocks):
                # worst-case reservation: this allocation cannot fail
                r.blocks += self.kv.allocator.alloc(need - len(r.blocks))
        B = self.max_slots
        tokens = np.zeros((B, 1), np.int32)
        positions = np.zeros((B,), np.int32)
        bt_rows: list[Optional[list[int]]] = [None] * B
        for r in active:
            tokens[r.slot, 0] = r.generated[-1]
            positions[r.slot] = r.input_pos
            bt_rows[r.slot] = r.blocks
        bt = self.kv.block_table(bt_rows, self.max_blocks)
        with self._timed("decode_time_s"):
            logits, self.kv.pools = self.model.decode_step_paged(
                tokens, self.kv.pools, bt, positions)
            logits = _host_logits(logits)
        self.stats["decode_steps"] += 1
        self.stats["decode_row_steps"] += len(active)
        for r in active:
            self._sample(r, logits[r.slot])
            if r.done:
                self._finish(r, finished)
        return len(active)

    def _finish(self, req: Request, finished: list[Request]) -> None:
        """Evict: release every block, reset their position marks."""
        self.kv.reset_blocks(self.kv.allocator.release(req.blocks))
        req.blocks = []
        self.scheduler.finish(req)
        self._transition(req, FINISHED)
        self._mark_finished(req)
        finished.append(req)


def run_sequential(model, requests, *, cache_len: Optional[int] = None,
                   cache_dtype=torch.float32) -> dict[int, np.ndarray]:
    """Reference path: one request at a time, contiguous cache, B = 1.

    ``requests``: dicts {"prompt", "max_new_tokens", optional "sampling",
    "rid"} (what ``RequestStream.requests()`` emits).  ``cache_len``: cache
    slots per request (default prompt + max_new); parity checks pass the
    engine's ``gather_tokens`` so both paths reduce attention over equally
    long masked key sets.
    """
    out: dict[int, np.ndarray] = {}
    for i, req in enumerate(requests):
        prompt = np.asarray(req["prompt"], np.int32)
        S = prompt.shape[0]
        gen = req["max_new_tokens"]
        sp = req.get("sampling") or SamplingParams()
        rid = req.get("rid", i)
        cache = model.init_cache(1, cache_len or (S + gen), cache_dtype)
        logits, cache = model.prefill(prompt[None], cache)
        toks = [sample_token(_host_logits(logits)[0], sp, request_salt=rid,
                             step=0)]
        for step_i in range(1, gen):
            nxt = np.asarray(toks[-1], np.int32).reshape(1, 1)
            logits, cache = model.decode_step(nxt, cache, S + step_i - 1)
            toks.append(sample_token(_host_logits(logits)[0], sp,
                                     request_salt=rid, step=step_i))
        out[rid] = np.stack(toks)
    return out


def make_engine(kind: str, model, **kw) -> ServingEngine:
    if kind == "continuous":
        return ContinuousEngine(model, **kw)
    if kind in ("static", "sharded", "disagg"):
        raise NotImplementedError(f"engine {kind!r} is not yet ported")
    raise ValueError(f"unknown engine kind {kind!r}")
