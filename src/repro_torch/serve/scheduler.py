"""FCFS continuous-batching scheduler: admission, slots, token budget.

The port of ``repro/serve/scheduler.py``.  Admission is strict FCFS among
the requests whose backoff has passed (the head blocks until it fits), and
a request is admitted only if a batch slot is free, the live-token budget
``sum(prompt + max_new)`` allows it, and its blocks can be reserved:

  * ``reserve="worst_case"`` (default) reserves ``ceil((prompt + max_new)
    / page)`` blocks, so lazy allocation during decode never fails;
  * ``reserve="prompt"`` reserves only the prefill's blocks; the pool
    oversubscribes, and decode growth that does not fit preempts the
    lowest-priority live request (``engine._ensure_blocks``), which comes
    back through :meth:`FCFSScheduler.requeue` with a ``not_before``
    backoff stamp.

With prefix sharing, a request's read-only hits are discounted from its
reservation, and the blocks its claim would pin are charged against
capacity (``prefix_probe``, ``pinned_external``).

``plan_aware_live_tokens`` grows an admission budget by the weight bytes a
sparsity plan frees, the reference's formula (the engine applies it when
given ``plan=``).
"""
from __future__ import annotations

from collections import deque

from .cache import blocks_for_tokens as _blocks_for
from .lifecycle import RequestError

__all__ = ["FCFSScheduler", "plan_aware_live_tokens"]


def plan_aware_live_tokens(base_tokens: int, *, plan, shapes: dict,
                           kv_bytes_per_token: float,
                           value_bytes: int = 2) -> int:
    """Grow a live-token budget by the weight bytes a sparsity plan frees.

    ``max_live_tokens`` is sized for one card's memory split between
    resident weights and KV pages, which assumes dense weights.  Under a
    :class:`SparsityPlan` the resident weights shrink, and the freed bytes
    are KV room the admission control may spend on more live tokens:

        budget = base + (dense_weight_bytes - resident_bytes) / kv_per_token

    ``resident_bytes`` prices each layer by what the plan keeps:
    ``nnz * value_bytes`` for full-precision layers (with no quantization
    this is ``(1 - density) * dense_bytes`` freed), and for compact or
    chain rules stamped ``quant='int8'`` one byte a value plus the f32
    per-leaf-block scales (``4 / (G*C)`` bytes a value).  Index tables are
    not priced.

    ``shapes`` is the model's projection table (``model_matmul_shapes``),
    ``kv_bytes_per_token`` the cache bytes of one token over every layer's
    pools (``ContinuousEngine.kv_bytes_per_token``).  The scheduler still
    clamps any budget to the block pool, so this never over-admits.
    """
    dense_bytes = 0.0
    resident = 0.0
    for path, shp in shapes.items():
        m, k = int(shp[0]), int(shp[1])
        c = int(shp[2]) if len(shp) > 2 else 1
        dense_bytes += float(m) * k * c * value_bytes
        spec = plan.resolve(path, m, k)
        inst = plan.pattern_for(path, m, k)
        nnz = float(inst.nnz) * c
        lay = inst.layout if inst.layout is not None else inst.chain_layout
        if (lay is not None and spec.is_sparse
                and getattr(spec, "quant", None) == "int8"
                and spec.storage() in ("compact", "chain")):
            from repro_torch.sparsity.quant import leaf_block_dims

            g_rows, c_cols = leaf_block_dims(lay)
            resident += nnz * (1.0 + 4.0 / (g_rows * c_cols))
        else:
            resident += nnz * value_bytes
    freed = dense_bytes - resident
    return int(base_tokens + freed // max(kv_bytes_per_token, 1.0))


class FCFSScheduler:
    """Requests duck-type ``prompt_len``/``max_new_tokens``; on admission
    the scheduler stamps ``slot`` and ``reserved_blocks`` onto them."""

    def __init__(self, *, page_size: int, max_slots: int,
                 max_live_tokens: int, n_blocks_capacity: int,
                 reserve: str = "worst_case",
                 prefix_probe=None, pinned_external=None):
        if max_slots < 1:
            raise ValueError(f"max_slots={max_slots}")
        if reserve not in ("worst_case", "prompt"):
            raise ValueError(f"reserve={reserve!r} "
                             f"(want 'worst_case' or 'prompt')")
        self.page = page_size
        self.max_slots = max_slots
        self.reserve = reserve
        # capacity_blocks is the *live* admission bound — fault injection
        # shrinks/restores it with the allocator's quarantine; the
        # configured capacity is what validate() rejects against, so a
        # transient capacity drop never turns into a permanent rejection.
        self.capacity_blocks = n_blocks_capacity
        self.capacity_blocks_configured = n_blocks_capacity
        cap_tokens = n_blocks_capacity * page_size
        if reserve == "worst_case":
            self.max_live_tokens = (
                min(max_live_tokens, cap_tokens) if max_live_tokens
                else cap_tokens
            )
        else:
            # prompt mode: the pool is *meant* to oversubscribe (that is
            # what creates preemption pressure), so worst-case token sums
            # are not clamped to pool tokens — the prefill-block
            # reservation in _fits is the physical gate.  An explicit
            # max_live_tokens still bounds admission as usual.
            self.max_live_tokens = max_live_tokens or (1 << 62)
        # prefix-sharing hooks (both None without a prefix cache).
        # ``prefix_probe(req) -> (hits, pin_blocks)``: ``hits`` = resident
        # blocks the request would reuse read-only (discounted from its
        # reservation — this is where admission headroom actually grows),
        # ``pin_blocks`` = the *ids* of matched blocks currently held only
        # by the index, which the claim would pin (they stop being
        # evictable, so they must be charged against capacity).  admit()
        # accumulates these sets across one pass: claims land only after
        # admit returns, so an earlier same-batch admittee's pins are
        # invisible to refcounts and must be carried forward explicitly —
        # ids (not counts) so overlapping prefixes charge once, disjoint
        # ones add up.  ``pinned_external() -> int``: index blocks with
        # live readers that no running request's private reservation
        # covers; invariant within one admit pass, so it is sampled once
        # per pass.  Together they keep the worst-case guarantee:
        # reserved + pinned_external + pending pins never exceeds
        # capacity, so private growth can always be satisfied by free +
        # evictable blocks.
        self.prefix_probe = prefix_probe
        self.pinned_external = pinned_external
        self.waiting: deque = deque()
        self.running: dict = {}
        self._free_slots = list(range(max_slots - 1, -1, -1))
        self._live_tokens = 0
        self._reserved_blocks = 0

    # -- introspection -------------------------------------------------------------
    @property
    def live_tokens(self) -> int:
        return self._live_tokens

    @property
    def reserved_blocks(self) -> int:
        return self._reserved_blocks

    @property
    def n_waiting(self) -> int:
        return len(self.waiting)

    @property
    def n_running(self) -> int:
        return len(self.running)

    @property
    def idle(self) -> bool:
        return not self.waiting and not self.running

    def occupancy(self) -> dict:
        """Point-in-time admission state — the engine's per-step gauges
        and the watchdog's stall diagnostics read the same numbers."""
        return {
            "waiting": len(self.waiting),
            "running": len(self.running),
            "live_tokens": self._live_tokens,
            "max_live_tokens": self.max_live_tokens,
            "reserved_blocks": self._reserved_blocks,
            "capacity_blocks": self.capacity_blocks,
        }

    # -- queue ---------------------------------------------------------------------
    def validate(self, req) -> None:
        """Reject requests that could never be admitted (budget / pool)."""
        total = req.prompt_len + req.max_new_tokens
        rid = getattr(req, "rid", None)
        if total > self.max_live_tokens:
            raise RequestError(
                "over_token_budget",
                f"request needs {total} tokens but max_live_tokens="
                f"{self.max_live_tokens}; it can never be admitted",
                rid=rid,
            )
        if _blocks_for(total, self.page) > self.capacity_blocks_configured:
            raise RequestError(
                "over_pool_capacity",
                f"request needs {_blocks_for(total, self.page)} blocks but "
                f"the pool has {self.capacity_blocks_configured}; it can "
                f"never be admitted",
                rid=rid,
            )

    def submit(self, req) -> None:
        self.validate(req)
        self._insert(req)

    def requeue(self, req) -> None:
        """Put a preempted/restarted request back in the arrival order.

        No re-validation: the request was admissible when first submitted
        and its worst-case footprint never grows (the generated prefix is
        part of ``prompt + max_new``).  Sorted insertion by (arrival_step,
        rid) means a preempted request keeps its original queue position —
        eviction does not also cost it its place in line.
        """
        self._insert(req)

    def remove(self, req) -> bool:
        """Drop a waiting request (cancellation/expiry before admission)."""
        try:
            self.waiting.remove(req)
            return True
        except ValueError:
            return False

    def _insert(self, req) -> None:
        # deterministic FCFS even when callers interleave submissions from
        # several producers within one arrival tick: the queue is kept
        # sorted by (arrival_step, rid), so admission order — and with it
        # slot assignment, decode-row layout, and eventual eviction order —
        # depends only on the request set, not on submission interleaving.
        # Required for cross-role reproducibility in the disaggregated
        # engine, where prefill and decode roles each see the stream.
        key = (getattr(req, "arrival_step", 0), getattr(req, "rid", 0))
        i = len(self.waiting)
        while i > 0:
            prev = self.waiting[i - 1]
            if (getattr(prev, "arrival_step", 0),
                    getattr(prev, "rid", 0)) <= key:
                break
            i -= 1
        self.waiting.insert(i, req)

    def _probe(self, req) -> tuple:
        """(hits, pin block-id set) from the prefix cache; empty without
        one."""
        if self.prefix_probe is None:
            return 0, frozenset()
        return self.prefix_probe(req)

    def _reserve_blocks_for(self, req, hits: int = 0) -> int:
        """Blocks to reserve at admission, net of prefix-cache ``hits``.

        ``hits`` is the number of resident blocks the request reuses
        read-only — they are covered by the index's own accounting
        (``pinned_external``), never allocated privately, so discounting
        them is what turns page sharing into real admission headroom.
        """
        total = req.prompt_len + req.max_new_tokens
        if self.reserve == "worst_case":
            base = _blocks_for(total, self.page)
        else:
            # prompt mode: reserve only what the (resume-aware) prefill
            # writes; decode growth is accounted incrementally via grow()
            base = _blocks_for(getattr(req, "prefill_len", req.prompt_len),
                               self.page)
        return max(base - hits, 0)

    def _live_charge_for(self, req, hits: int = 0) -> int:
        """Live tokens to charge at admission, net of prefix hits.

        Shared pages hold tokens the request never stores privately, so
        the token budget (sized to pool tokens under worst-case reserve)
        discounts them just like the block reservation does — otherwise
        block sharing frees pool space the token clamp then refuses to
        spend.  The charge is stamped on the request (``live_charge``)
        so finish() releases exactly what admission took.
        """
        total = req.prompt_len + req.max_new_tokens
        return max(total - hits * self.page, 0)

    def _fits(self, req, hits: int = 0, n_pins: int = 0,
              pinned: int = 0) -> bool:
        """``n_pins`` is the total pending pin charge for this admit pass
        (the union of every prior admittee's pin blocks with this
        candidate's); ``pinned`` the pass's pinned_external sample."""
        return (
            bool(self._free_slots)
            and self._live_tokens + self._live_charge_for(req, hits)
            <= self.max_live_tokens
            and self._reserved_blocks + pinned + n_pins
            + self._reserve_blocks_for(req, hits)
            <= self.capacity_blocks
        )

    def admit(self, now_step: int = 0) -> list:
        """Pop FCFS-eligible requests while they fit; stamp slots.

        Requests whose ``not_before`` backoff stamp is in the future are
        skipped (not popped); among the eligible remainder admission is
        head-of-line blocking, preserving strict FCFS determinism.

        Pin accounting is cumulative across the pass: each admittee's
        probe pin blocks join ``pending``, and the next candidate is
        charged ``len(pending | its own pins)`` — ids, not counts, so a
        prefix two same-batch requests share is charged once while
        disjoint prefixes add up.  Without this, admitted-but-not-yet-
        claimed pins (refcount still 1 until the engine claims after
        admit returns) would be invisible and two requests could be
        admitted against the same capacity.
        """
        admitted = []
        pending: frozenset = frozenset()   # pin ids charged so far
        pinned = self.pinned_external() if self.pinned_external else 0
        i = 0
        while i < len(self.waiting):
            req = self.waiting[i]
            if getattr(req, "not_before", 0) > now_step:
                i += 1  # backing off — skip, keep queue position
                continue
            hits, pins = self._probe(req)
            pins = pending | pins
            if not self._fits(req, hits, len(pins), pinned):
                break  # head-of-line blocking among eligible requests
            pending = pins
            del self.waiting[i]
            req.slot = self._free_slots.pop()
            req.reserved_blocks = self._reserve_blocks_for(req, hits)
            req.live_charge = self._live_charge_for(req, hits)
            self._live_tokens += req.live_charge
            self._reserved_blocks += req.reserved_blocks
            self.running[req.slot] = req
            admitted.append(req)
        return admitted

    def grow(self, req, n_blocks: int = 1) -> None:
        """Account lazy block growth beyond the admission reservation.

        Under ``reserve="prompt"`` the engine allocates decode blocks the
        admission never reserved; charging them here keeps ``_fits`` (and
        with it the preemption pressure signal) truthful.  A no-op under
        worst-case reservation, where growth is always pre-reserved.
        """
        if self.reserve == "worst_case":
            return
        if self.running.get(req.slot) is not req:
            raise ValueError(f"request in slot {req.slot} is not running")
        req.reserved_blocks += n_blocks
        self._reserved_blocks += n_blocks

    def finish(self, req) -> None:
        """Evict a finished (or preempted) request: release its slot and
        reservations."""
        if self.running.get(req.slot) is not req:
            raise ValueError(f"request in slot {req.slot} is not running")
        del self.running[req.slot]
        self._free_slots.append(req.slot)
        self._live_tokens -= getattr(req, "live_charge",
                                     req.prompt_len + req.max_new_tokens)
        self._reserved_blocks -= req.reserved_blocks
        req.slot = None
