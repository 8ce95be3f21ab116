"""Request lifecycle: state machine, structured errors, stall diagnostics.

Every request served by the paged engines moves through an explicit state
machine::

    QUEUED ──► PREFILLING ──► DECODING ──► FINISHED
      ▲            │              │
      └────────────┴──────────────┘        (preempt / fault restart:
      │            │              │         pages freed, prompt + generated
      ▼            ▼              ▼         prefix kept, re-admitted later)
             CANCELLED | EXPIRED | FAILED

The terminal states partition the failure modes: FINISHED emitted all
``max_new_tokens``; CANCELLED was withdrawn by the caller (``cancel(rid)``);
EXPIRED blew its ``deadline_steps`` budget; FAILED exhausted its bounded
retries (preemptions + fault restarts > ``max_retries``).  Preemption is
*not* a state of its own — an evicted request goes back to QUEUED with its
generated-token prefix intact, and re-admission re-prefills prompt+prefix.
Because sampling is keyed per (request, step) (see ``sampling.py``) and
prefill/decode logits are bit-identical position-for-position, a preempted
request's token stream is byte-identical to the uninterrupted run — the
repo's signature parity guarantee survives eviction.

:func:`transition` enforces the edge set; an illegal edge raises — state
bugs surface at the transition, not as a corrupted drain 500 steps later.
"""
from __future__ import annotations

from typing import Optional

__all__ = [
    "QUEUED", "PREFILLING", "DECODING",
    "FINISHED", "CANCELLED", "EXPIRED", "FAILED",
    "TERMINAL_STATES", "LIVE_STATES",
    "transition", "RequestError", "EngineStallError",
]

QUEUED = "QUEUED"
PREFILLING = "PREFILLING"
DECODING = "DECODING"
FINISHED = "FINISHED"
CANCELLED = "CANCELLED"
EXPIRED = "EXPIRED"
FAILED = "FAILED"

TERMINAL_STATES = frozenset({FINISHED, CANCELLED, EXPIRED, FAILED})
LIVE_STATES = frozenset({QUEUED, PREFILLING, DECODING})

# the full edge set; preemption / fault restart is the * -> QUEUED edge
_EDGES = {
    QUEUED: frozenset({PREFILLING, CANCELLED, EXPIRED, FAILED}),
    PREFILLING: frozenset({DECODING, QUEUED, CANCELLED, EXPIRED, FAILED}),
    DECODING: frozenset({FINISHED, QUEUED, CANCELLED, EXPIRED, FAILED}),
    FINISHED: frozenset(),
    CANCELLED: frozenset(),
    EXPIRED: frozenset(),
    FAILED: frozenset(),
}


def transition(req, to: str, obs=None, clock: int = 0) -> None:
    """Move ``req`` (anything with a ``state`` attr) along a legal edge.

    ``obs`` is an optional observability recorder (duck-typed — anything
    with ``on_transition(req, frm, to, clock)``); the engines pass theirs
    so every legal edge lands in the request's span at the engine-clock
    step it happened.  The hook fires *after* the state change, and only
    for legal edges — illegal edges raise before any side effect.
    """
    frm = req.state
    if to not in _EDGES[frm]:
        raise RuntimeError(
            f"illegal lifecycle transition {frm} -> {to} for request "
            f"{getattr(req, 'rid', '?')} (legal: {sorted(_EDGES[frm])})"
        )
    req.state = to
    if obs is not None:
        obs.on_transition(req, frm, to, clock)


class RequestError(ValueError):
    """Structured submit rejection / terminal failure.

    Subclasses ValueError so callers (and older tests) that catch broad
    validation errors keep working, but carries a machine-readable
    ``reason`` code and the ``rid`` (None when rejected before a rid was
    assigned) so callers can distinguish *rejection* — a property of the
    request — from an engine bug.

    Reason codes:
      * ``bad_prompt`` / ``bad_max_new_tokens`` — malformed arguments;
      * ``too_long`` — prompt + max_new exceeds ``max_request_len``;
      * ``over_token_budget`` — can never fit ``max_live_tokens``;
      * ``over_pool_capacity`` — can never fit the block pool;
      * ``retries_exhausted`` — preemptions + restarts > ``max_retries``;
      * ``deadline`` — expired past ``deadline_steps``;
      * ``fault_kill`` — killed by an injected fault (before any retry).
    """

    def __init__(self, reason: str, message: str,
                 rid: Optional[int] = None):
        super().__init__(message)
        self.reason = reason
        self.rid = rid

    def __reduce__(self):  # keep picklable with the extra fields
        return (RequestError, (self.reason, self.args[0], self.rid))


class EngineStallError(RuntimeError):
    """Raised by the engine watchdog when no request can make progress.

    The old failure mode was ``drain()`` spinning until its ``max_steps``
    fuse (100k steps of silence); the watchdog instead raises after
    ``max_idle_steps`` consecutive no-progress steps *while work is
    pending*, carrying a ``diagnostics`` dict (live rids + states, pool
    occupancy, waiting queue with backoff deadlines, scheduler budget) so
    the stall is debuggable from the exception alone.
    """

    def __init__(self, message: str, diagnostics: Optional[dict] = None):
        super().__init__(message)
        self.diagnostics = diagnostics or {}
