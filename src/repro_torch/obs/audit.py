"""Cross-check engine lifecycle counters against the request log.

The port of ``repro/obs/audit.py`` (host code, unchanged).

The engines maintain ``stats`` counters (finished/expired/failed/
cancelled/preemptions/fault_kills/prefix_*) incremented at scattered call
sites; nothing historically verified they agree with ground truth.  The
ground truth is derivable: every accepted request stays registered in
``engine.requests`` with its terminal ``state`` and its per-request
``preemptions``/``restarts`` counts, and (when a recorder ran) the span
log holds one ``on_token`` stamp per sampled token and the per-request
prefix-hit annotations.

:func:`audit_engine` recomputes each counter from those sources and
reports mismatches — the counter-audit tests call it after preemption,
fault-soak, and prefix-sharing runs and assert ``ok``.
"""
from __future__ import annotations

__all__ = ["audit_engine", "derive_counts"]

# String copies of serve.lifecycle's terminal states (obs must not import
# repro_torch.serve — the engines import obs).
_STATE_KEYS = {
    "FINISHED": "finished",
    "CANCELLED": "cancelled",
    "EXPIRED": "expired",
    "FAILED": "failed",
}


def derive_counts(engine) -> dict:
    """Recompute lifecycle counters from the request log alone."""
    reqs = list(engine.requests.values())
    derived = {k: 0 for k in _STATE_KEYS.values()}
    for r in reqs:
        key = _STATE_KEYS.get(r.state)
        if key is not None:
            derived[key] += 1
    derived["preemptions"] = sum(r.preemptions for r in reqs)
    derived["fault_kills"] = sum(r.restarts for r in reqs)
    return derived


def audit_engine(engine, spans=None) -> dict:
    """Compare ``engine.stats`` counters with request-log-derived counts.

    With ``spans`` (a :class:`~repro_torch.obs.spans.SpanLog` that observed the
    whole run) three more counters become checkable: sampled-token count
    (``generated_tokens`` — NOT derivable from ``len(req.generated)``,
    which fault restarts reset) and the prefix-sharing totals
    (``prefix_hit_tokens`` / ``prefix_hits``, accumulated per request via
    ``annotate()`` at claim time).

    Returns ``{"ok", "derived", "mismatches"}``; ``mismatches`` maps each
    disagreeing counter to its stats/derived pair.
    """
    derived = derive_counts(engine)
    if spans is not None:
        allspans = spans.spans.values()
        derived["generated_tokens"] = sum(
            len(s.token_steps) for s in allspans)
        derived["prefix_hit_tokens"] = sum(
            s.annotations.get("prefix_hit_tokens", 0) for s in allspans)
        derived["prefix_hits"] = sum(
            s.annotations.get("prefix_hit_pages", 0) for s in allspans)
    mismatches = {}
    for key, want in derived.items():
        if key not in engine.stats:
            continue   # engine variant without this counter
        got = engine.stats[key]
        if got != want:
            mismatches[key] = {"stats": got, "derived": want}
    return {"ok": not mismatches, "derived": derived,
            "mismatches": mismatches}
