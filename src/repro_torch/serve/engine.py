"""Serving engines: continuous batching over paged KV, plus baselines.

The port of ``repro/serve/engine.py``:

  * :class:`ContinuousEngine` — ``submit()`` enqueues, ``step()`` admits
    and prefills newly admitted requests (single-shot at the exact
    prefill length, or ``prefill_chunk``-token chunks, one per step) and
    runs one batched decode step over all live rows through per-request
    block tables; ``drain()`` runs to completion.
  * :class:`StaticEngine` — the fixed-batch baseline: FCFS requests are
    grouped by equal prompt length, each group prefills once and decodes
    in lockstep until its longest generation ends.
  * :func:`run_sequential` — one request at a time through ``prefill`` /
    ``decode_step`` with a contiguous cache: the semantic oracle both
    engines must reproduce token for token under greedy sampling.

Every projection goes through the kernels (``rbgp4mm_rhs`` and its stacked
and chain siblings on the card).  ``stats["prefill_time_s"]`` and
``stats["decode_time_s"]`` are fenced with ``torch.cuda.synchronize()`` on
the card under any recorder, the null one included (``repro_torch.obs``),
so they measure the work and not its launch.

Robustness, as the reference's: every request carries a lifecycle state;
admission can oversubscribe the pool (``reserve="prompt"``), and decode
growth that does not fit preempts the lowest-priority live request (pages
freed, prompt + generated prefix kept, re-prefilled on re-admission, so a
greedy stream resumes where it stopped; sampling keys are per (request,
step)).  Deadlines, ``cancel(rid)``, bounded retries with exponential
backoff, a no-progress watchdog, deterministic fault injection, prefix
sharing with copy-on-write and crash-consistent snapshots complete it.
Given ``plan=``, the engine grows its admission budget by the weight bytes
the plan frees (``scheduler.plan_aware_live_tokens``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.device import synchronize
from repro_torch.obs import NULL_RECORDER, EngineStats

from .cache import PagedKVCache, blocks_for_tokens, pack_prefill_pages
from .chunked import (ChunkedPrefillState, chunk_cache_len, mask_cache_rows,
                      run_one_chunk, slice_cache)
from .faults import FaultInjector, FaultSchedule
from .lifecycle import (CANCELLED, DECODING, EXPIRED, FAILED, FINISHED,
                        PREFILLING, QUEUED, TERMINAL_STATES,
                        EngineStallError, RequestError, transition)
from .prefix import PrefixIndex
from .sampling import SamplingParams, sample_token
from .scheduler import FCFSScheduler, plan_aware_live_tokens

__all__ = ["Request", "ServingEngine", "ContinuousEngine", "StaticEngine",
           "run_sequential", "make_engine"]


@dataclasses.dataclass(eq=False)   # identity equality: ndarray fields
class Request:
    rid: int
    prompt: np.ndarray               # (S,) int32
    max_new_tokens: int
    sampling: SamplingParams = dataclasses.field(default_factory=SamplingParams)
    arrival_step: int = 0
    priority: int = 0                # higher = evicted later under pressure
    deadline_step: Optional[int] = None   # absolute engine-clock deadline
    # runtime state
    generated: list = dataclasses.field(default_factory=list)
    blocks: list = dataclasses.field(default_factory=list)
    n_shared: int = 0                # leading blocks[:n_shared] are shared
    cow_src: Optional[int] = None    # pinned copy-on-write source block
    slot: Optional[int] = None
    reserved_blocks: int = 0
    state: str = QUEUED              # lifecycle.py state machine
    not_before: int = 0              # re-admission backoff (engine clock)
    preemptions: int = 0             # pool-pressure evictions survived
    restarts: int = 0                # fault kills survived (prefix discarded)
    error: Optional[RequestError] = None   # set on FAILED / EXPIRED

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
    def prefill_len(self) -> int:
        """Tokens a (re-)prefill must feed: the prompt plus any generated
        prefix a preemption kept (``prompt_len`` for a fresh request)."""
        return self.prompt_len + len(self.generated)

    @property
    def prefill_tokens(self) -> np.ndarray:
        """(prefill_len,) prompt ++ generated prefix, the resume
        re-prefill's input: it puts the cache in the state the
        uninterrupted run had after ``len(generated)`` tokens, so the next
        sample (keyed per (request, step)) continues the stream."""
        if not self.generated:
            return self.prompt
        gen = np.asarray(self.generated, np.int32).reshape(
            (len(self.generated),) + self.prompt.shape[1:])
        return np.concatenate([self.prompt, gen], axis=0)

    @property
    def tokens(self) -> np.ndarray:
        return np.stack(self.generated) if self.generated else \
            np.zeros((0,), np.int32)


def _host_logits(logits: torch.Tensor) -> np.ndarray:
    """Logits as a float32 host array (bf16 -> f32 is exact)."""
    return logits.float().cpu().numpy()


class ServingEngine:
    """submit()/step()/drain() surface shared by both engines."""

    kind = "base"

    def __init__(self, model, *, cache_dtype=torch.float32, recorder=None):
        self.model = model
        self.cfg = model.cfg
        self.device = model.device
        self.cache_dtype = cache_dtype
        self.requests: dict[int, Request] = {}
        self.finished: dict[int, Request] = {}
        self._next_rid = 0
        self._clock = 0                 # engine step clock (deadline basis)
        # NULL_RECORDER unless the caller attaches a repro_torch.obs
        # Recorder; ``stats`` is a dict either way, mirrored into the
        # recorder's registry when there is one
        self._obs = recorder if recorder is not None else NULL_RECORDER
        self.stats = EngineStats(self._obs.registry, {
            "steps": 0, "prefill_calls": 0, "decode_steps": 0,
            "prompt_tokens": 0, "generated_tokens": 0, "wasted_row_steps": 0,
            "prefill_time_s": 0.0, "decode_time_s": 0.0,
            # robustness counters (lifecycle / preemption / faults)
            "rejected": 0, "cancelled": 0, "expired": 0, "failed": 0,
            "finished": 0,
            "preemptions": 0, "fault_kills": 0, "resumed_prefills": 0,
            "fault_events": 0, "fault_paused_steps": 0,
        })

    # -- API -----------------------------------------------------------------------
    def submit(self, prompt, max_new_tokens: int,
               sampling: Optional[SamplingParams] = None,
               arrival_step: int = 0, *,
               deadline_steps: Optional[int] = None,
               priority: int = 0) -> int:
        """Enqueue a request; returns its rid.

        ``deadline_steps``: the request EXPIREs (releasing every page) once
        the engine clock reaches ``max(clock, arrival_step) +
        deadline_steps``.  ``priority``: higher values are preempted later
        (ties: youngest first, see ``_pick_victim``).  Rejections raise
        :class:`RequestError` with a ``reason`` code.
        """
        prompt = np.asarray(prompt, np.int32)
        if prompt.ndim != 1 or prompt.shape[0] < 1:
            self.stats["rejected"] += 1
            raise RequestError("bad_prompt", f"prompt shape {prompt.shape}")
        if max_new_tokens < 1:
            self.stats["rejected"] += 1
            raise RequestError("bad_max_new_tokens",
                               f"max_new_tokens={max_new_tokens}")
        if deadline_steps is not None and deadline_steps < 1:
            self.stats["rejected"] += 1
            raise RequestError("bad_deadline",
                               f"deadline_steps={deadline_steps}")
        rid = self._next_rid
        deadline = None if deadline_steps is None else \
            max(self._clock, arrival_step) + deadline_steps
        req = Request(rid=rid, prompt=prompt, max_new_tokens=max_new_tokens,
                      sampling=sampling or SamplingParams(),
                      arrival_step=arrival_step, priority=priority,
                      deadline_step=deadline)
        try:
            self._enqueue(req)
        except RequestError:
            self.stats["rejected"] += 1
            raise
        self._next_rid += 1
        self.requests[rid] = req
        self._obs.on_submit(req, self._clock)
        return rid

    def cancel(self, rid: int) -> bool:
        """Withdraw a live request: frees its pages and slot at once and
        moves it to CANCELLED (its partial ``tokens`` stay readable).
        Returns False if the rid is unknown or already terminal."""
        req = self.requests.get(rid)
        if req is None or req.state in TERMINAL_STATES:
            return False
        self._terminate(req, CANCELLED)
        self.stats["cancelled"] += 1
        return True

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

    # -- shared helpers --------------------------------------------------------------
    def _enqueue(self, req: Request) -> None:
        raise NotImplementedError

    def _terminate(self, req: Request, state: str,
                   error: Optional[RequestError] = None) -> None:
        raise NotImplementedError

    def _timed(self, name: str, key: str, **args):
        """The recorder's timed section for ``stats[key]``, entered after
        the card finished its queued work (so the section times only its
        own); the caller fences inside with ``tm.fence``."""
        synchronize(self.device)
        return self._obs.timed(name, self.stats, key, **args)

    def _next_input(self, req: Request) -> np.ndarray:
        """(1,) last sampled token, as the next decode input."""
        return np.asarray(req.generated[-1], np.int32).reshape(
            (1,) + req.prompt.shape[1:])

    def _sample(self, req: Request, logits_row: np.ndarray) -> None:
        tok = sample_token(logits_row, req.sampling, request_salt=req.rid,
                           step=len(req.generated))
        req.generated.append(tok)
        self.stats["generated_tokens"] += 1
        self._obs.on_token(req, self._clock)

    def _mark_finished(self, req: Request) -> None:
        self.finished[req.rid] = req
        if req.state == FINISHED:
            self.stats["finished"] += 1

    def _transition(self, req: Request, to: str) -> None:
        """Lifecycle edge + span hook at the current engine clock."""
        transition(req, to, obs=self._obs, clock=self._clock)


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
    prefill_chunk:    0 = single-shot prefill.  > 0 = admitted prompts are
                      fed in ``prefill_chunk``-token pieces, at most ONE
                      piece per engine step, interleaved with the batched
                      decode (``serve/chunked.py``).
    plan:             optional ``SparsityPlan`` of the served weights.  With
                      a non-zero ``max_live_tokens`` the admission budget
                      grows by the weight bytes the plan frees
                      (``scheduler.plan_aware_live_tokens``, the bytes
                      sized by the served values' floating dtype); the
                      pool's capacity still caps admission.
    reserve:          "worst_case" (default) reserves ``blocks_for(prompt +
                      max_new)`` so growth never fails; "prompt" reserves
                      only the prefill's blocks, and growth that does not
                      fit preempts the lowest-priority live request.
    max_retries:      preemptions + fault restarts a request survives
                      before it is FAILED (``retries_exhausted``).
    preempt_backoff:  base of the exponential re-admission backoff (steps).
    max_idle_steps:   watchdog fuse: consecutive no-progress steps with
                      work pending before ``EngineStallError`` (with live
                      rids, pool occupancy and queue diagnostics).
    faults:           optional :class:`FaultSchedule` (or prepared
                      :class:`FaultInjector`) applied at each step.
    prefix_cache:     prefix sharing (``serve/prefix.py``): a radix index
                      over finished prompts' full pages lets a new request
                      reuse every resident page its prompt head matches;
                      prefill recomputes only the suffix, the partial tail
                      page is copied on write, and cold cached prefixes
                      are LRU-evicted under pool pressure.  Off by default:
                      the index keeps pages allocated after requests end.
    recorder:         a ``repro_torch.obs.Recorder`` (spans, trace,
                      metrics); default the null recorder.
    """

    kind = "continuous"

    def __init__(self, model, *, page_size: int = 8, max_slots: int = 8,
                 n_blocks: int = 0, max_live_tokens: int = 0,
                 max_request_len: int = 0, prefill_chunk: int = 0,
                 cache_dtype=torch.float32, plan=None,
                 reserve: str = "worst_case", max_retries: int = 32,
                 preempt_backoff: int = 1, max_idle_steps: int = 1000,
                 faults=None, prefix_cache: bool = False, recorder=None):
        super().__init__(model, cache_dtype=cache_dtype, recorder=recorder)
        self.page = page_size
        self.max_slots = max_slots
        self.max_request_len = max_request_len or self.cfg.max_seq_len
        self.max_blocks = blocks_for_tokens(self.max_request_len, page_size)
        if n_blocks <= 0:
            n_blocks = 1 + max_slots * self.max_blocks
        self.prefill_chunk = prefill_chunk
        if prefill_chunk > 0:
            self.chunk_cache = chunk_cache_len(
                self.max_request_len, page_size, prefill_chunk)
        self.max_retries = max_retries
        self.preempt_backoff = max(preempt_backoff, 0)
        self.max_idle_steps = max_idle_steps
        self._idle_streak = 0
        if isinstance(faults, FaultSchedule):
            faults = FaultInjector(faults)
        self._injector: Optional[FaultInjector] = faults
        self._prefilling: dict[int, ChunkedPrefillState] = {}
        self.step_trace: list[dict] = []
        # (clock, rid, "preempt"|"restart"): the deterministic eviction log
        self.preempt_log: list[tuple[int, int, str]] = []
        self.kv = PagedKVCache(model, n_blocks, page_size, cache_dtype)
        self.base_live_tokens = max_live_tokens
        self.plan = plan
        self.plan_fingerprint = (plan.fingerprint() if plan is not None
                                 else None)
        self.prefix = PrefixIndex(page_size) if prefix_cache else None
        # what snapshot.restore_engine needs to rebuild this engine (the
        # radix index restores empty: snapshots carry no KV pages)
        self._init_kw = dict(
            page_size=page_size, max_slots=max_slots, n_blocks=n_blocks,
            max_live_tokens=max_live_tokens,
            max_request_len=self.max_request_len,
            prefill_chunk=prefill_chunk, reserve=reserve,
            max_retries=max_retries, preempt_backoff=preempt_backoff,
            max_idle_steps=max_idle_steps, prefix_cache=prefix_cache,
        )
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
            reserve=reserve,
            prefix_probe=self._prefix_probe if prefix_cache else None,
            pinned_external=(self._prefix_pinned_external
                             if prefix_cache else None),
        )
        self.stats.update(block_steps=0, allocated_block_steps=0,
                          live_token_steps=0, peak_allocated_blocks=0,
                          prefill_chunks=0, decode_row_steps=0,
                          prefix_hits=0, prefix_hit_tokens=0,
                          prefix_misses=0, prefix_evictions=0,
                          prefix_cow_copies=0, shared_prefills=0)

    # -- prefix sharing ----------------------------------------------------------------
    def _release_blocks(self, blocks: list) -> None:
        """Drop this engine's reference on ``blocks``; blocks whose last
        reader left go back to the free list with their position marks
        reset, blocks other readers hold keep their data."""
        freed = self.kv.allocator.release(blocks)
        self.kv.reset_blocks(freed)

    def _release_request_blocks(self, req: Request) -> None:
        """Release everything ``req`` holds: its block list (shared prefix
        + private pages) and, mid-prefill, its pinned COW source."""
        if req.cow_src is not None:
            self._release_blocks([req.cow_src])
            req.cow_src = None
        if req.blocks:
            self._release_blocks(req.blocks)
            req.blocks = []
        req.n_shared = 0

    def _prefix_probe(self, req: Request) -> tuple:
        """Scheduler admission probe: (reservation discount, new pins).

        The discount counts the read-only shared blocks (the COW source
        still costs a private block).  ``new_pins`` is the set of matched
        block ids held by the index alone, which the claim would stop from
        being evictable, so admission charges them against capacity.
        Read-only: ``plan(..., None)`` stamps no LRU clock, takes no
        reference.
        """
        plan = self.prefix.plan(req.prefill_tokens, None)
        matched = set(plan.blocks)
        if plan.cow_src is not None:
            matched.add(plan.cow_src)
        alloc = self.kv.allocator
        new_pins = frozenset(b for b in matched if alloc.refcount(b) == 1)
        return len(plan.blocks), new_pins

    def _prefix_pinned_external(self) -> int:
        """Index blocks with live readers that no running request's private
        reservation covers (charged against capacity by the scheduler, once
        per admit pass)."""
        priv: set = set()
        for r in self.scheduler.running.values():
            priv.update(r.blocks[r.n_shared:])
        alloc = self.kv.allocator
        return sum(1 for b in self.prefix.blocks()
                   if alloc.refcount(b) > 1 and b not in priv)

    def _claim_prefix(self, req: Request) -> None:
        """Pin the request's resident prefix right after admission, before
        any prefill (and with it any eviction pressure) runs this step."""
        plan = self.prefix.plan(req.prefill_tokens, self._clock)
        if plan.hit_pages == 0:
            self.stats["prefix_misses"] += 1
            return
        alloc = self.kv.allocator
        alloc.share(plan.blocks)
        req.blocks = list(plan.blocks)
        req.n_shared = len(plan.blocks)
        if plan.cow_src is not None:
            alloc.share([plan.cow_src])
            req.cow_src = plan.cow_src
        self.stats["prefix_hits"] += plan.hit_pages
        self.stats["prefix_hit_tokens"] += plan.hit_tokens
        self._obs.annotate(req.rid, prefix_hit_tokens=plan.hit_tokens,
                           prefix_hit_pages=plan.hit_pages)

    def _insert_prefix(self, req: Request) -> None:
        """Index the request's full prompt pages after its prefill scatter
        (never the partial tail page, never generated pages: decode writes
        land past every indexed page).  Pages already indexed keep their
        original block."""
        new = self.prefix.insert(req.prefill_tokens, req.blocks,
                                 req.prompt_len, self._clock)
        if new:
            self.kv.allocator.share(new)

    def _gather_prefix(self, req: Request, cache: list):
        """Fill the temp prefill cache from the claimed blocks (shared
        pages + the pinned COW source), as copies, then drop the COW pin:
        from here the request writes only private blocks.  Returns (cache,
        suffix_start, span), ``span`` the gathered slot count."""
        if req.cow_src is not None:
            suffix_start = req.prefill_len - 1
            gather = req.blocks[:req.n_shared] + [req.cow_src]
        else:
            suffix_start = req.n_shared * self.page
            gather = req.blocks[:req.n_shared]
        span = len(gather) * self.page
        cache = self.kv.read_pages(cache, gather)
        if req.cow_src is not None:
            self._release_blocks([req.cow_src])
            req.cow_src = None
            self.stats["prefix_cow_copies"] += 1
            self._obs.instant("prefix_cow", rid=req.rid, step=self._clock)
        self.stats["shared_prefills"] += 1
        return cache, suffix_start, span

    @property
    def gather_tokens(self) -> int:
        """KV slots a decode row attends over (block-table width x page)."""
        return self.max_blocks * self.page

    def snapshot(self, path: str) -> dict:
        """Crash-consistent snapshot (``serve/snapshot.py``): host state
        only, written atomically; call between steps."""
        from .snapshot import save_engine

        return save_engine(self, path)

    def kv_bytes_per_token(self) -> float:
        """Cache bytes of one token over every layer's page pools."""
        total = sum(t.numel() * t.element_size()
                    for pool in self.kv.pools for t in pool.values())
        return total / max(self.kv.allocator.n_total * self.page, 1)

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

    # -- steps -----------------------------------------------------------------------
    def step(self) -> list[Request]:
        """One engine tick: faults, expiry, admit+prefill, batched decode."""
        finished: list[Request] = []
        t_step = self._obs.now()
        paused = False
        if self._injector is not None:
            paused = self._injector.begin_step(self, self._clock)
        self._expire(finished)
        admitted = chunks = decoded = 0
        if not paused:
            batch = self.scheduler.admit(self._clock)
            for req in batch:
                # claim the whole batch before any prefill runs: an earlier
                # admittee's allocation pressure cannot evict a later one's
                # pinned prefix
                admitted += 1
                self._transition(req, PREFILLING)
                if self.prefix is not None:
                    self._claim_prefix(req)
            for req in batch:
                if req.slot is None:
                    continue   # preempted by an earlier admittee's prefill
                if self.prefill_chunk > 0:
                    self._begin_chunked(req)
                else:
                    self._prefill_request(req)
                    if req.slot is not None and req.done:
                        self._finish(req, finished)
            chunks = self._run_prefill_chunk(finished)
            decoded = self._decode_batch(finished)
        self.step_trace.append({"admitted": admitted,
                                "prefill_chunks": chunks,
                                "decode_rows": decoded})
        self.stats["steps"] += 1
        na = self.kv.allocator.n_allocated
        self.stats["allocated_block_steps"] += na
        self.stats["block_steps"] += self.kv.allocator.n_total
        self.stats["live_token_steps"] += sum(
            r.input_pos + 1 for r in self.scheduler.running.values())
        self.stats["peak_allocated_blocks"] = max(
            self.stats["peak_allocated_blocks"], na)
        if self._obs.enabled:
            reg = self._obs.registry
            for k, v in self.scheduler.occupancy().items():
                reg.gauge(f"sched_{k}").set(v)
            reg.gauge("pool_allocated_blocks").set(na)
            self._obs.slice("step", t_step, track="step", step=self._clock,
                            admitted=admitted, chunks=chunks,
                            decoded=decoded, finished=len(finished))
        self._watchdog(admitted + chunks + decoded + len(finished), paused)
        self._clock += 1
        return finished

    # -- lifecycle: expiry / cancellation / preemption ---------------------------------
    def _terminate(self, req: Request, state: str,
                   error: Optional[RequestError] = None) -> None:
        """Move a live request to a terminal state, releasing everything."""
        self._prefilling.pop(req.rid, None)
        self._release_request_blocks(req)
        if req.slot is not None:
            self.scheduler.finish(req)
        else:
            self.scheduler.remove(req)
        self._transition(req, state)
        req.error = error
        self._mark_finished(req)

    def _expire(self, finished: list[Request]) -> None:
        for req in list(self.requests.values()):
            if (req.state not in TERMINAL_STATES
                    and req.deadline_step is not None
                    and self._clock >= req.deadline_step):
                self._terminate(req, EXPIRED, RequestError(
                    "deadline",
                    f"request {req.rid} missed deadline_step="
                    f"{req.deadline_step} at engine clock {self._clock}",
                    rid=req.rid,
                ))
                self.stats["expired"] += 1
                finished.append(req)

    def _pick_victim(self) -> Optional[Request]:
        """Deterministic preemption order: lowest priority first, then
        youngest arrival, then highest rid (host state only)."""
        live = list(self.scheduler.running.values())
        if not live:
            return None
        return min(live, key=lambda r: (r.priority, -r.arrival_step, -r.rid))

    def _preempt(self, req: Request, restart: bool = False) -> None:
        """Evict a live request: free its pages, keep the prompt (+ the
        generated prefix unless ``restart``), re-queue it with exponential
        backoff.  Past ``max_retries`` it is FAILED instead."""
        self._prefilling.pop(req.rid, None)
        self._release_request_blocks(req)
        self.scheduler.finish(req)
        self.preempt_log.append(
            (self._clock, req.rid, "restart" if restart else "preempt"))
        self._obs.instant("restart" if restart else "preempt",
                          rid=req.rid, step=self._clock,
                          generated=len(req.generated))
        if restart:
            # fault kill: the generated prefix is lost with the "crash";
            # per-(request, step) sampling keys regenerate it identically
            req.generated = []
            req.restarts += 1
            self.stats["fault_kills"] += 1
        else:
            req.preemptions += 1
            self.stats["preemptions"] += 1
        retries = req.preemptions + req.restarts
        if retries > self.max_retries:
            self._transition(req, FAILED)
            req.error = RequestError(
                "retries_exhausted",
                f"request {req.rid} exceeded max_retries={self.max_retries} "
                f"({req.preemptions} preemptions, {req.restarts} fault "
                f"restarts)",
                rid=req.rid,
            )
            self.stats["failed"] += 1
            self._mark_finished(req)
            return
        self._transition(req, QUEUED)
        req.not_before = self._clock + 1 + \
            self.preempt_backoff * (2 ** min(retries - 1, 6))
        self.scheduler.requeue(req)

    def _fault_kill(self, idx: int) -> None:
        """Injected crash of one live request (victim: sorted live rids
        indexed mod n, deterministic for a schedule and workload)."""
        rids = sorted(r.rid for r in self.scheduler.running.values())
        if not rids:
            return
        self._preempt(self.requests[rids[idx % len(rids)]], restart=True)

    def _ensure_blocks(self, req: Request, n_new: int) -> Optional[list]:
        """Allocate ``n_new`` blocks for ``req``, preempting under pressure.

        Cold cached prefixes are evicted first (LRU, in one tree scan);
        then ``_pick_victim()`` (which may be ``req`` itself) is evicted
        until the allocation fits.  Returns the blocks, or None if ``req``
        was the victim.  While an injected ``alloc_fail`` is armed, every
        allocation fails transiently and ``req`` is preempted.
        """
        if n_new <= 0:
            return []
        if (self._injector is not None
                and not self._injector.alloc_allowed(self._clock)):
            self._preempt(req)
            return None
        alloc = self.kv.allocator
        while not alloc.can_alloc(n_new):
            if self.prefix is not None:
                blks = self.prefix.evict_lru(
                    lambda b: alloc.refcount(b) == 1,
                    n_new - alloc.n_free)
                if blks:
                    self._release_blocks(blks)
                    self.stats["prefix_evictions"] += len(blks)
                    continue
            victim = self._pick_victim()
            if victim is None:
                self._preempt(req)
                return None
            self._preempt(victim)
            if victim is req:
                return None
        return alloc.alloc(n_new)

    def _watchdog(self, progress: int, paused: bool) -> None:
        """Raise EngineStallError after ``max_idle_steps`` consecutive
        no-progress steps with work pending.  Injected pauses and pure
        backoff waits (nothing running, every waiting request's
        ``not_before`` in the future) reset the streak."""
        if progress > 0 or paused or self.idle:
            self._idle_streak = 0
            return
        waiting = list(self.scheduler.waiting)
        if (not self.scheduler.running and waiting and all(
                getattr(r, "not_before", 0) > self._clock for r in waiting)):
            self._idle_streak = 0
            return
        self._idle_streak += 1
        if self._idle_streak < self.max_idle_steps:
            return
        alloc = self.kv.allocator
        diag = {
            "clock": self._clock,
            "live": {r.rid: r.state
                     for r in self.scheduler.running.values()},
            "waiting": [(r.rid, getattr(r, "not_before", 0))
                        for r in waiting],
            "pool": {"n_free": alloc.n_free, "n_allocated": alloc.n_allocated,
                     "n_quarantined": alloc.n_quarantined,
                     "n_total": alloc.n_total},
            "budget": self.scheduler.occupancy(),
        }
        raise EngineStallError(
            f"engine made no progress for {self._idle_streak} consecutive "
            f"steps with work pending ({len(diag['live'])} running, "
            f"{len(waiting)} waiting; pool {alloc.n_free} free / "
            f"{alloc.n_quarantined} quarantined of {alloc.n_total}); "
            f"diagnostics attached",
            diag,
        )

    def _prefill_request(self, req: Request) -> None:
        """Prefill at the exact prefill length, then page it.

        For a fresh request that is the prompt; for a preempted one the
        prompt ++ generated prefix (the next ``_sample`` is keyed at
        ``step=len(generated)``, the step the uninterrupted run is at).
        With a claimed prefix the matched pages are gathered into the temp
        cache and only the suffix runs, through ``prefill_chunk``; the
        scatter then covers only the privately written page span.
        """
        L = req.prefill_len
        nb = self.kv.blocks_for(L)
        got = self._ensure_blocks(req, nb - req.n_shared)
        if got is None:
            return   # req itself was preempted under pool pressure
        req.blocks = req.blocks + got
        fed = L
        if req.n_shared == 0 and req.cow_src is None:
            cache = self.model.init_cache(1, L, self.cache_dtype,
                                          full_length=True)
            with self._timed("prefill", "prefill_time_s", rid=req.rid,
                             tokens=L, step=self._clock) as tm:
                logits, cache = self.model.prefill(
                    req.prefill_tokens[None], cache)
                logits = _host_logits(logits)
                tm.fence(cache)
            self.kv.write_pages(pack_prefill_pages(cache, nb, self.page),
                                req.blocks)
        else:
            cache = self.model.init_cache(1, nb * self.page,
                                          self.cache_dtype, full_length=True)
            cache, start, span = self._gather_prefix(req, cache)
            cache = mask_cache_rows(cache, start, span)
            suffix = np.asarray(req.prefill_tokens)[start:]
            fed = L - start
            with self._timed("prefill", "prefill_time_s", rid=req.rid,
                             tokens=fed, shared=True,
                             step=self._clock) as tm:
                logits, cache = self.model.prefill_chunk(
                    suffix[None], cache, start, fed)
                logits = _host_logits(logits)
                tm.fence(cache)
            self.kv.write_pages(
                pack_prefill_pages(
                    slice_cache(cache, req.n_shared * self.page,
                                nb * self.page),
                    nb - req.n_shared, self.page),
                req.blocks[req.n_shared:])
        if self.prefix is not None:
            self._insert_prefix(req)
        if req.generated:
            self.stats["resumed_prefills"] += 1
        self._sample(req, logits[0])
        self._transition(req, DECODING)
        self.stats["prefill_calls"] += 1
        self.stats["prompt_tokens"] += fed

    # -- chunked prefill ---------------------------------------------------------------
    def _begin_chunked(self, req: Request) -> None:
        """Allocate the request's prefill blocks and its temp prefill cache
        (``chunk_cache`` slots, one length for every request).  A resumed
        request chunks prompt ++ generated prefix."""
        nb = self.kv.blocks_for(req.prefill_len)
        got = self._ensure_blocks(req, nb - req.n_shared)
        if got is None:
            return   # req itself was preempted under pool pressure
        req.blocks = req.blocks + got
        cache = self.model.init_cache(1, self.chunk_cache, self.cache_dtype,
                                      full_length=True)
        pos0 = 0
        if req.n_shared > 0 or req.cow_src is not None:
            cache, start, span = self._gather_prefix(req, cache)
            # chunk starts stay multiples of ``prefill_chunk`` (the
            # chunk_cache_len window argument assumes it), so the resume
            # point rounds down: the re-fed rows recompute over the
            # gathered prefix, and only the private span is scattered
            pos0 = start - start % self.prefill_chunk
            cache = mask_cache_rows(cache, pos0, span)
        self._prefilling[req.rid] = ChunkedPrefillState(
            req=req, cache=cache, chunk=self.prefill_chunk,
            tokens=req.prefill_tokens, pos=pos0)
        if req.generated:
            self.stats["resumed_prefills"] += 1

    def _run_prefill_chunk(self, finished: list[Request]) -> int:
        """Feed at most ONE chunk (of the oldest in-flight prefill) per
        step.  On the final chunk, scatter the temp cache's block span into
        the page pools and sample the first token from the chunk logits."""
        if not self._prefilling:
            return 0
        rid = next(iter(self._prefilling))   # dict preserves FCFS order
        state = self._prefilling[rid]
        with self._timed("prefill_chunk", "prefill_time_s", rid=rid,
                         pos=state.pos, step=self._clock) as tm:
            fed = run_one_chunk(state, self.model.prefill_chunk,
                                fence=tm.fence)
        self.stats["prefill_chunks"] += 1
        self.stats["prompt_tokens"] += fed
        if state.done:
            del self._prefilling[rid]
            req = state.req
            nb = len(req.blocks)
            n_sh = req.n_shared
            self.kv.write_pages(
                pack_prefill_pages(
                    slice_cache(state.cache, n_sh * self.page,
                                nb * self.page),
                    nb - n_sh, self.page),
                req.blocks[n_sh:])
            if self.prefix is not None:
                self._insert_prefix(req)
            self._sample(req, state.logits[0])
            self._transition(req, DECODING)
            self.stats["prefill_calls"] += 1
            if req.done:
                self._finish(req, finished)
        return 1

    def _decode_batch(self, finished: list[Request]) -> int:
        # sorted by rid: a deterministic row layout; rows still mid-prefill
        # have no sampled token yet and are skipped
        active = sorted(
            (r for r in self.scheduler.running.values()
             if not r.done and r.rid not in self._prefilling),
            key=lambda r: r.rid)
        if not active:
            return 0
        for r in active:
            if r.slot is None:
                continue   # preempted while growing an earlier row
            need = self.kv.blocks_for(r.input_pos + 1)
            if need > len(r.blocks):
                got = self._ensure_blocks(r, need - len(r.blocks))
                if got is None:
                    continue   # r itself was the preemption victim
                r.blocks += got
                self.scheduler.grow(r, len(got))
        # growth may have evicted rows (theirs or later ones): re-filter
        active = [r for r in active if r.slot is not None]
        if not active:
            return 0
        B = self.max_slots
        tokens = np.zeros((B, 1), np.int32)
        positions = np.zeros((B,), np.int32)
        bt_rows: list[Optional[list[int]]] = [None] * B
        for r in active:
            tokens[r.slot, 0] = r.generated[-1]
            positions[r.slot] = r.input_pos
            bt_rows[r.slot] = r.blocks
        bt = self.kv.block_table(bt_rows, self.max_blocks)
        with self._timed("decode", "decode_time_s", rows=len(active),
                         step=self._clock) as tm:
            logits, self.kv.pools = self.model.decode_step_paged(
                tokens, self.kv.pools, bt, positions)
            logits = _host_logits(logits)
            tm.fence(self.kv.pools)
        self.stats["decode_steps"] += 1
        self.stats["decode_row_steps"] += len(active)
        for r in active:
            self._sample(r, logits[r.slot])
            if r.done:
                self._finish(r, finished)
        return len(active)

    def _finish(self, req: Request, finished: list[Request]) -> None:
        """Evict: release every block the request held (pages the index or
        another reader still references stay resident)."""
        self._release_request_blocks(req)
        self.scheduler.finish(req)
        self._transition(req, FINISHED)
        self._mark_finished(req)
        finished.append(req)


class StaticEngine(ServingEngine):
    """Fixed-batch baseline: equal-prompt-length groups, lockstep decode."""

    kind = "static"

    def __init__(self, model, *, batch: int = 4, cache_dtype=torch.float32,
                 recorder=None):
        super().__init__(model, cache_dtype=cache_dtype, recorder=recorder)
        self.batch = batch
        self._queue: list[Request] = []
        self.stats.update(cache_slot_steps=0, live_token_steps=0)

    @property
    def idle(self) -> bool:
        return not self._queue

    def _enqueue(self, req: Request) -> None:
        self._queue.append(req)

    def _terminate(self, req: Request, state: str,
                   error: Optional[RequestError] = None) -> None:
        """Static batches run to completion inside one step(), so only
        still-queued requests can be cancelled or expired here."""
        if req in self._queue:
            self._queue.remove(req)
        self._transition(req, state)
        req.error = error
        self._mark_finished(req)

    def step(self) -> list[Request]:
        """Serve one batch to completion (the static-batching granularity).

        The head of the FCFS queue picks the batch; the rest of it is the
        next ``batch - 1`` requests with the same prompt length (ragged
        prompts cannot share a lockstep prefill).
        """
        if not self._queue:
            return []
        S = self._queue[0].prompt_len
        group = [r for r in self._queue if r.prompt_len == S][: self.batch]
        self._queue = [r for r in self._queue if r not in group]
        B = len(group)
        max_gen = max(r.max_new_tokens for r in group)
        cache = self.model.init_cache(B, S + max_gen, self.cache_dtype)
        prompts = np.stack([r.prompt for r in group])
        for r in group:
            self._transition(r, PREFILLING)
        with self._timed("prefill", "prefill_time_s", batch=B, tokens=B * S,
                         step=self._clock) as tm:
            logits, cache = self.model.prefill(prompts, cache)
            logits = _host_logits(logits)
            tm.fence(cache)
        for i, r in enumerate(group):
            self._sample(r, logits[i])
            self._transition(r, DECODING)
        self.stats["prefill_calls"] += 1
        self.stats["prompt_tokens"] += B * S
        for step_i in range(1, max_gen):
            nxt = np.stack([self._next_input(r) for r in group])
            with self._timed("decode", "decode_time_s", rows=B,
                             step=self._clock) as tm:
                logits, cache = self.model.decode_step(nxt, cache,
                                                       S + step_i - 1)
                logits = _host_logits(logits)
                tm.fence(cache)
            self.stats["decode_steps"] += 1
            self.stats["cache_slot_steps"] += B * (S + max_gen)
            self.stats["live_token_steps"] += sum(
                min(r.input_pos + 1, r.prompt_len + r.max_new_tokens)
                for r in group)
            for i, r in enumerate(group):
                if r.done:
                    # lockstep: the row keeps burning the step anyway
                    self.stats["wasted_row_steps"] += 1
                else:
                    self._sample(r, logits[i])
        for r in group:
            self._transition(r, FINISHED)
            self._mark_finished(r)
        self.stats["steps"] += 1
        self._clock += 1
        return group


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
    if kind == "static":
        return StaticEngine(model, **kw)
    if kind in ("sharded", "disagg"):
        raise NotImplementedError(
            f"engine {kind!r} is not yet ported (it needs torch.distributed "
            f"serving, ROADMAP A.8)")
    raise ValueError(
        f"unknown engine kind {kind!r}; have continuous|static|sharded|disagg")
