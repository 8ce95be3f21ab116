"""FCFS continuous-batching scheduler: admission, slots, token budget.

The port of ``repro/serve/scheduler.py`` with worst-case reservation:
admission is strict FCFS (the head of the queue blocks until it fits), and
a request is admitted only if a batch slot is free, the live-token budget
``sum(prompt + max_new)`` allows it, and ``ceil((prompt + max_new) / page)``
blocks can be reserved — so lazy block allocation during decode never
fails and nothing is ever preempted.  The reference's ``reserve="prompt"``
(preemption) and its prefix-sharing hooks come with later slices.

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
                 max_live_tokens: int, n_blocks_capacity: int):
        if max_slots < 1:
            raise ValueError(f"max_slots={max_slots}")
        self.page = page_size
        self.max_slots = max_slots
        self.capacity_blocks = n_blocks_capacity
        cap_tokens = n_blocks_capacity * page_size
        self.max_live_tokens = (min(max_live_tokens, cap_tokens)
                                if max_live_tokens else cap_tokens)
        self.waiting: deque = deque()
        self.running: dict = {}
        self._free_slots = list(range(max_slots - 1, -1, -1))
        self._live_tokens = 0
        self._reserved_blocks = 0

    @property
    def live_tokens(self) -> int:
        return self._live_tokens

    @property
    def reserved_blocks(self) -> int:
        return self._reserved_blocks

    @property
    def idle(self) -> bool:
        return not self.waiting and not self.running

    def occupancy(self) -> dict:
        return {
            "waiting": len(self.waiting),
            "running": len(self.running),
            "live_tokens": self._live_tokens,
            "max_live_tokens": self.max_live_tokens,
            "reserved_blocks": self._reserved_blocks,
            "capacity_blocks": self.capacity_blocks,
        }

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
        if _blocks_for(total, self.page) > self.capacity_blocks:
            raise RequestError(
                "over_pool_capacity",
                f"request needs {_blocks_for(total, self.page)} blocks but "
                f"the pool has {self.capacity_blocks}; it can never be "
                f"admitted",
                rid=rid,
            )

    def submit(self, req) -> None:
        self.validate(req)
        # kept sorted by (arrival_step, rid): admission order depends only
        # on the request set, not on submission interleaving
        key = (getattr(req, "arrival_step", 0), getattr(req, "rid", 0))
        i = len(self.waiting)
        while i > 0:
            prev = self.waiting[i - 1]
            if (getattr(prev, "arrival_step", 0),
                    getattr(prev, "rid", 0)) <= key:
                break
            i -= 1
        self.waiting.insert(i, req)

    def _fits(self, req) -> bool:
        total = req.prompt_len + req.max_new_tokens
        return (
            bool(self._free_slots)
            and self._live_tokens + total <= self.max_live_tokens
            and self._reserved_blocks + _blocks_for(total, self.page)
            <= self.capacity_blocks
        )

    def admit(self) -> list:
        """Pop FCFS requests while they fit (head-of-line blocking)."""
        admitted = []
        while self.waiting and self._fits(self.waiting[0]):
            req = self.waiting.popleft()
            req.slot = self._free_slots.pop()
            req.reserved_blocks = _blocks_for(
                req.prompt_len + req.max_new_tokens, self.page)
            self._live_tokens += req.prompt_len + req.max_new_tokens
            self._reserved_blocks += req.reserved_blocks
            self.running[req.slot] = req
            admitted.append(req)
        return admitted

    def finish(self, req) -> None:
        """Release a finished request's slot and reservations."""
        if self.running.get(req.slot) is not req:
            raise ValueError(f"request in slot {req.slot} is not running")
        del self.running[req.slot]
        self._free_slots.append(req.slot)
        self._live_tokens -= req.prompt_len + req.max_new_tokens
        self._reserved_blocks -= req.reserved_blocks
        req.slot = None
