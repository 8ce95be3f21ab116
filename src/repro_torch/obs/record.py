"""The Recorder: the one object the engines talk to for observability.

The port of ``repro/obs/record.py``.  Two implementations share one duck
type:

  * :data:`NULL_RECORDER` (a :class:`NullRecorder`), the default: every
    hook is a no-op except ``timed()``, which adds the section's wall time
    into the engine's ``stats`` dict; no registry, no spans, no trace.
  * :class:`Recorder`: ``timed()`` also observes a ``<name>_seconds``
    histogram and emits a Perfetto slice; the lifecycle hooks feed the
    :class:`~repro_torch.obs.spans.SpanLog`; ``instant()`` marks point
    events on the trace.

Both fence: ``tm.fence(x)`` inside a timed section calls
``torch.cuda.synchronize`` on the card that holds ``x``, so the section's
time covers the work the card was given and not only its launch.  This is
a deliberate difference from the reference, whose null recorder does not
fence (a fence there serializes XLA's dispatch): the port's serving
numbers have always been fenced, and a card launch returns as early as
an XLA dispatch does, so an unfenced section would time the launches.
The engines synchronize before a timed section starts, too, so that
queued work of the step before does not land in it.
"""
from __future__ import annotations

import time
from typing import Optional

import torch

from .metrics import MetricsRegistry
from .spans import SpanLog
from .trace import TraceBuffer

__all__ = ["Recorder", "NullRecorder", "NULL_RECORDER", "fence"]


def _cuda_devices(x, out: set) -> None:
    if isinstance(x, torch.Tensor):
        if x.is_cuda:
            out.add(x.device)
    elif isinstance(x, dict):
        for v in x.values():
            _cuda_devices(v, out)
    elif isinstance(x, (list, tuple)):
        for v in x:
            _cuda_devices(v, out)


def fence(x):
    """Wait for the card(s) holding the tensors of ``x`` (a tensor, or
    nested dicts, lists and tuples of them); returns ``x``.  CPU tensors
    and other objects need no wait."""
    devices: set = set()
    _cuda_devices(x, devices)
    for dev in devices:
        torch.cuda.synchronize(dev)
    return x


class _NullTimed:
    """``stats[key] += perf_counter() - t0`` around the section."""

    __slots__ = ("_stats", "_key", "_t0")

    def __init__(self, stats, key):
        self._stats = stats
        self._key = key

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self._stats is not None and self._key is not None:
            self._stats[self._key] += time.perf_counter() - self._t0
        return False

    @staticmethod
    def fence(x):
        return fence(x)

    def set(self, **kw) -> None:
        pass


class NullRecorder:
    """Do-nothing recorder; the engines' default.  Stateless singleton."""

    enabled = False
    registry: Optional[MetricsRegistry] = None
    spans: Optional[SpanLog] = None
    trace: Optional[TraceBuffer] = None

    def now(self) -> float:
        return 0.0

    @staticmethod
    def fence(x):
        return fence(x)

    def timed(self, name, stats=None, key=None, track=None, **args):
        return _NullTimed(stats, key)

    def slice(self, name, start_s, end_s=None, track=None, **args):
        pass

    def instant(self, name, track="events", **args):
        pass

    def on_submit(self, req, step):
        pass

    def on_transition(self, req, frm, to, step):
        pass

    def on_token(self, req, step):
        pass

    def annotate(self, rid, **kw):
        pass


NULL_RECORDER = NullRecorder()


class _Timed:
    """Fenced timed section: stats accumulation + histogram + trace slice."""

    __slots__ = ("_rec", "_name", "_stats", "_key", "_track", "_args",
                 "_t0")

    def __init__(self, rec, name, stats, key, track, args):
        self._rec = rec
        self._name = name
        self._stats = stats
        self._key = key
        self._track = track
        self._args = args

    def __enter__(self):
        self._t0 = self._rec.now()
        return self

    def fence(self, x):
        return fence(x)

    def set(self, **kw) -> None:
        self._args.update(kw)

    def __exit__(self, *exc):
        rec = self._rec
        end = rec.now()
        elapsed = end - self._t0
        if self._stats is not None and self._key is not None:
            self._stats[self._key] += elapsed
        if rec.registry is not None:
            rec.registry.histogram(
                f"{self._name}_seconds",
                help=f"fenced wall-clock of {self._name} sections",
            ).observe(elapsed)
        if rec.trace is not None:
            rec.trace.slice(self._name, self._t0, end,
                            track=self._track, **self._args)
        return False


class Recorder:
    """Live recorder: registry + request spans + Perfetto trace.

    Any of the three sinks can be switched off at construction
    (``spans=False`` / ``trace=False``); pre-built instances can also be
    passed in (e.g. a SpanLog with an injected test clock).  All engine
    hooks are host-side bookkeeping; the only interaction with the card is
    the explicit ``fence`` inside timed sections.
    """

    enabled = True

    def __init__(self, registry: Optional[MetricsRegistry] = None,
                 spans=True, trace=True):
        self.registry = registry if registry is not None else MetricsRegistry()
        if spans is True:
            spans = SpanLog()
        self.spans = spans or None
        if trace is True:
            trace = TraceBuffer()
        self.trace = trace or None
        self._t0 = time.perf_counter()

    def now(self) -> float:
        """Seconds since recorder start — the shared slice/trace clock."""
        if self.trace is not None:
            return self.trace.now()
        return time.perf_counter() - self._t0

    @staticmethod
    def fence(x):
        return fence(x)

    def timed(self, name, stats=None, key=None, track=None, **args):
        return _Timed(self, name, stats, key, track, args)

    def slice(self, name, start_s, end_s=None, track=None, **args):
        if self.trace is not None:
            if end_s is None:
                end_s = self.trace.now()
            self.trace.slice(name, start_s, end_s, track=track, **args)

    def instant(self, name, track="events", **args):
        if self.trace is not None:
            self.trace.instant(name, track=track, **args)
        self.registry.counter(
            f"event_{name}_total", labels=()).inc()

    def on_submit(self, req, step):
        if self.spans is not None:
            self.spans.on_submit(req, step)

    def on_transition(self, req, frm, to, step):
        if self.spans is not None:
            self.spans.on_transition(req, frm, to, step)
        if self.trace is not None and to in ("FINISHED", "CANCELLED",
                                             "EXPIRED", "FAILED"):
            self.trace.instant(f"request_{to.lower()}", track="lifecycle",
                               rid=req.rid, step=step)

    def on_token(self, req, step):
        if self.spans is not None:
            self.spans.on_token(req, step)

    def annotate(self, rid, **kw):
        if self.spans is not None:
            self.spans.annotate(rid, **kw)
