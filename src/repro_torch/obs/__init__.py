"""Observability layer: metrics, request spans, step traces, counter audit.

The port of ``repro/obs`` (without ``kernelstats``, which hooks an
autotuner the port does not have yet).  The package sits below
``repro_torch.serve`` in the import graph: the engines construct a
recorder (or keep the no-op default) and call its hooks.

Entry points:

  * :class:`Recorder` / :data:`NULL_RECORDER` — the engines' recorder
    duck type (``record.py``; its ``fence`` synchronizes the card);
  * :class:`MetricsRegistry` / :class:`EngineStats` — counters, gauges,
    histograms; snapshot + Prometheus rendering (``metrics.py``);
  * :class:`SpanLog` — per-request TTFT/TPOT/queue/preemption spans
    (``spans.py``);
  * :class:`TraceBuffer` / :func:`validate_trace` — Perfetto
    ``trace_event`` export (``trace.py``; also a command:
    ``python -m repro_torch.obs.trace out.json``);
  * :func:`audit_engine` — lifecycle-counter cross-check against the
    request log (``audit.py``).
"""
from .audit import audit_engine, derive_counts
from .metrics import (SCHEMA_VERSION, Counter, Gauge, Histogram,
                      MetricsRegistry, EngineStats, bench_payload,
                      exponential_buckets, DURATION_BUCKETS_S)
from .record import NULL_RECORDER, NullRecorder, Recorder, fence
from .spans import RequestSpan, Segment, SpanLog, percentile, percentile_table
from .trace import TraceBuffer, validate_trace, validate_trace_file

__all__ = [
    "SCHEMA_VERSION",
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "EngineStats",
    "bench_payload", "exponential_buckets", "DURATION_BUCKETS_S",
    "Recorder", "NullRecorder", "NULL_RECORDER", "fence",
    "SpanLog", "RequestSpan", "Segment", "percentile", "percentile_table",
    "TraceBuffer", "validate_trace", "validate_trace_file",
    "audit_engine", "derive_counts",
]
