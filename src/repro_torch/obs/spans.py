"""Per-request lifecycle spans: TTFT, TPOT, queue-wait, preemption cost.

The port of ``repro/obs/spans.py`` (host code, unchanged).

A :class:`SpanLog` listens to three engine signals and reconstructs each
request's timeline without the engine storing anything per-request itself:

  * ``on_submit(req, step)`` — opens the span with an initial QUEUED
    segment (QUEUED is the lifecycle's birth state, never entered via a
    ``transition()`` edge, so it needs its own hook);
  * ``on_transition(req, frm, to, step)`` — fired from
    ``repro_torch.serve.lifecycle.transition`` on every legal edge: closes the open
    segment and opens one for the target state (terminal states just
    close).  Preemption is the documented ``* -> QUEUED`` edge, so a
    preempted request's span simply grows another QUEUED/PREFILLING pair
    before decoding resumes — no special casing;
  * ``on_token(req, step)`` — one call per sampled token (prefill's first
    token included), stamping both the engine-step clock and wall time.

Derived per-request metrics (:meth:`SpanLog.request_metrics`):

  * **TTFT** — first token minus submit, in wall seconds and engine steps
    (for a lone request the step form equals the first-token step delta,
    which tests pin exactly);
  * **TPOT** / inter-token latency — mean/whole distribution of
    consecutive token wall-time gaps;
  * **queue-wait** — total QUEUED residency (initial wait + every
    post-preemption backoff);
  * **preemptions / lost_steps** — extra QUEUED entries, and the
    re-queued + re-prefill steps spent after the first token (the steps
    preemption recompute costs that an uninterrupted run would not pay);
  * **prefix_hit_tokens** etc. via ``annotate()`` — the engine reports
    prefix-cache hits per request, yielding the per-request prefill
    discount.

:meth:`aggregate` folds requests into deterministic nearest-rank
p50/p90/p99 tables (no interpolation: results are exact order statistics,
stable across platforms).
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Optional

__all__ = ["Segment", "RequestSpan", "SpanLog",
           "percentile", "percentile_table"]

# String copies of serve.lifecycle's states: obs sits *below* repro_torch.serve
# in the layering (engine imports obs), so importing lifecycle here would
# cycle through the serve package __init__.
_QUEUED = "QUEUED"
_PREFILLING = "PREFILLING"
_DECODING = "DECODING"
_TERMINAL = frozenset({"FINISHED", "CANCELLED", "EXPIRED", "FAILED"})


def percentile(values, p: float):
    """Nearest-rank percentile: the ``ceil(p/100 * n)``-th smallest value.

    Deterministic and exact — the result is always a member of ``values``
    (no interpolation), so cross-platform float noise cannot change it.
    Returns None for an empty input.
    """
    vs = sorted(values)
    if not vs:
        return None
    if p <= 0:
        return vs[0]
    rank = min(max(math.ceil(p / 100.0 * len(vs)), 1), len(vs))
    return vs[rank - 1]


def percentile_table(values, ps=(50, 90, 99)) -> dict:
    """``{"p50": ..., "p90": ..., "p99": ...}`` (empty dict if no data)."""
    vs = list(values)
    if not vs:
        return {}
    return {f"p{p:g}": percentile(vs, p) for p in ps}


@dataclasses.dataclass
class Segment:
    """One contiguous residency in a lifecycle state."""

    state: str
    start_step: int
    start_wall: float
    end_step: Optional[int] = None
    end_wall: Optional[float] = None

    @property
    def steps(self) -> int:
        return (self.end_step if self.end_step is not None
                else self.start_step) - self.start_step

    @property
    def wall_s(self) -> float:
        return (self.end_wall if self.end_wall is not None
                else self.start_wall) - self.start_wall


class RequestSpan:
    """Timeline of one request: state segments + token stamps."""

    __slots__ = ("rid", "submit_step", "submit_wall", "segments",
                 "token_steps", "token_walls", "annotations", "final_state")

    def __init__(self, rid: int, step: int, wall: float):
        self.rid = rid
        self.submit_step = step
        self.submit_wall = wall
        self.segments: list[Segment] = [Segment(_QUEUED, step, wall)]
        self.token_steps: list[int] = []
        self.token_walls: list[float] = []
        self.annotations: dict = {}
        self.final_state: Optional[str] = None


class SpanLog:
    """Collects RequestSpans; the engine talks to it through a Recorder.

    ``wall`` is injectable so tests can drive deterministic clocks.
    """

    def __init__(self, wall=time.perf_counter):
        self._wall = wall
        self.spans: dict[int, RequestSpan] = {}

    def _span(self, rid: int, step: int, wall: float) -> RequestSpan:
        span = self.spans.get(rid)
        if span is None:
            span = self.spans[rid] = RequestSpan(rid, step, wall)
        return span

    # -- engine signals ------------------------------------------------------------
    def on_submit(self, req, step: int) -> None:
        self._span(req.rid, step, self._wall())

    def on_transition(self, req, frm: str, to: str, step: int) -> None:
        wall = self._wall()
        span = self._span(req.rid, step, wall)
        open_seg = span.segments[-1] if span.segments else None
        if open_seg is not None and open_seg.end_step is None:
            open_seg.end_step = step
            open_seg.end_wall = wall
        if to in _TERMINAL:
            span.final_state = to
        else:
            span.segments.append(Segment(to, step, wall))

    def on_token(self, req, step: int) -> None:
        span = self._span(req.rid, step, self._wall())
        span.token_steps.append(step)
        span.token_walls.append(self._wall())

    def annotate(self, rid: int, **kw) -> None:
        span = self.spans.get(rid)
        if span is None:
            return
        for k, v in kw.items():
            if isinstance(v, (int, float)):
                span.annotations[k] = span.annotations.get(k, 0) + v
            else:
                span.annotations[k] = v

    # -- derived metrics -----------------------------------------------------------
    def request_metrics(self, rid: int) -> dict:
        span = self.spans[rid]
        m: dict = {
            "rid": rid,
            "final_state": span.final_state,
            "n_tokens": len(span.token_steps),
            "preemptions": max(
                sum(1 for s in span.segments if s.state == _QUEUED) - 1, 0),
        }
        queued = [s for s in span.segments if s.state == _QUEUED]
        m["queue_steps"] = sum(s.steps for s in queued)
        m["queue_s"] = sum(s.wall_s for s in queued)
        if span.token_steps:
            first_step = span.token_steps[0]
            m["ttft_steps"] = first_step - span.submit_step
            m["ttft_s"] = span.token_walls[0] - span.submit_wall
            gaps = [b - a for a, b in zip(span.token_walls,
                                          span.token_walls[1:])]
            m["itl_s"] = gaps
            m["tpot_s"] = sum(gaps) / len(gaps) if gaps else None
            # recompute cost: steps after the first token spent *not*
            # decoding (re-queued backoff + re-prefill).  An uninterrupted
            # run has zero such steps, so this is exactly what the
            # preemption(s) cost this request.
            m["lost_steps"] = sum(
                s.steps for s in span.segments
                if s.state != _DECODING and s.start_step >= first_step)
        else:
            m["ttft_steps"] = m["ttft_s"] = m["tpot_s"] = None
            m["itl_s"] = []
            m["lost_steps"] = 0
        m.update(span.annotations)
        return m

    def aggregate(self, ps=(50, 90, 99)) -> dict:
        """Fleet view: nearest-rank percentile tables + totals."""
        reqs = [self.request_metrics(rid) for rid in sorted(self.spans)]
        with_tok = [m for m in reqs if m["n_tokens"] > 0]
        itl_pool = [g for m in with_tok for g in m["itl_s"]]
        return {
            "requests": len(reqs),
            "with_tokens": len(with_tok),
            "tokens": sum(m["n_tokens"] for m in reqs),
            "ttft_s": percentile_table(
                [m["ttft_s"] for m in with_tok], ps),
            "ttft_steps": percentile_table(
                [m["ttft_steps"] for m in with_tok], ps),
            "tpot_s": percentile_table(
                [m["tpot_s"] for m in with_tok
                 if m["tpot_s"] is not None], ps),
            "itl_s": percentile_table(itl_pool, ps),
            "queue_steps": percentile_table(
                [m["queue_steps"] for m in reqs], ps),
            "preemptions": sum(m["preemptions"] for m in reqs),
            "lost_steps": sum(m["lost_steps"] for m in reqs),
            "prefix_hit_tokens": sum(
                m.get("prefix_hit_tokens", 0) for m in reqs),
        }
