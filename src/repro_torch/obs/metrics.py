"""Metrics registry: counters, gauges, histograms; snapshot + Prometheus.

The port of ``repro/obs/metrics.py`` (host code, unchanged: the same
metric names, Prometheus text and ``SCHEMA_VERSION``).

The registry replaces the engines' raw ``stats`` dicts as the source of
truth for serving counters without breaking a single caller: the engines
keep a dict-shaped ``stats`` attribute (:class:`EngineStats`, a real
``dict`` subclass), but every write mirrors into a named metric here, so
the same numbers come out three ways:

  * ``engine.stats["decode_steps"]`` — the historical dict read, used by
    the launch CLI, ``chip_smoke.py``, and the snapshot round-trip;
  * ``registry.snapshot()`` — a plain, JSON-serializable
    ``{name: value}`` dict (histograms expand to bucket tables), the form
    ``launch/serve.py --json`` embeds;
  * ``registry.render_prometheus()`` — the text exposition format, for
    scraping / ``--prom`` dumps.

Everything is host-side and lock-guarded but deliberately boring: no
background threads, no clocks, no I/O.  Recording costs one dict lookup
and one float add; the zero-overhead-when-disabled story lives in
``repro_torch.obs.record`` (the no-op recorder), not here.
"""
from __future__ import annotations

import re
import threading
from bisect import bisect_left
from typing import Iterable, Optional, Sequence

__all__ = [
    "SCHEMA_VERSION",
    "Counter", "Gauge", "Histogram",
    "MetricsRegistry", "EngineStats",
    "exponential_buckets", "DURATION_BUCKETS_S",
    "bench_payload",
]

# Version stamp shared by every machine-readable observability artifact
# (serve --json, chip_smoke.py's serve-obs record, traces).
# Bump on any breaking change to the payload shapes.
SCHEMA_VERSION = 1


def exponential_buckets(start: float, factor: float,
                        count: int) -> tuple[float, ...]:
    """``count`` upper bounds ``start * factor**i`` (Prometheus-style)."""
    if start <= 0 or factor <= 1 or count < 1:
        raise ValueError(f"exponential_buckets({start}, {factor}, {count})")
    return tuple(start * factor ** i for i in range(count))


# Default duration buckets: 1us .. ~67s, doubling.  Fixed bounds so
# percentile-ish reads from snapshots are comparable across runs.
DURATION_BUCKETS_S = exponential_buckets(1e-6, 2.0, 27)

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")


def _prom_name(name: str) -> str:
    n = _NAME_RE.sub("_", name)
    if not n or n[0].isdigit():
        n = "_" + n
    return n


def _fmt(v: float) -> str:
    f = float(v)
    return str(int(f)) if f.is_integer() else repr(f)


class Counter:
    """Monotonic counter.  ``set()`` exists only for the stats-shim /
    snapshot-restore path, which replays absolute values."""

    kind = "counter"
    __slots__ = ("name", "help", "value")

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self.value = 0.0

    def inc(self, v: float = 1.0) -> None:
        if v < 0:
            raise ValueError(f"counter {self.name}: inc({v})")
        self.value += v

    def set(self, v: float) -> None:
        self.value = float(v)

    def snapshot(self):
        return self.value


class Gauge:
    """Point-in-time value (pool occupancy, queue depth, peaks)."""

    kind = "gauge"
    __slots__ = ("name", "help", "value")

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def inc(self, v: float = 1.0) -> None:
        self.value += v

    def dec(self, v: float = 1.0) -> None:
        self.value -= v

    def snapshot(self):
        return self.value


class Histogram:
    """Fixed-bound histogram (cumulative ``le`` buckets + sum + count).

    Bounds are fixed at registration (default the exponential duration
    ladder), so two snapshots of the same metric are always comparable
    bucket-for-bucket.
    """

    kind = "histogram"
    __slots__ = ("name", "help", "bounds", "counts", "sum", "count")

    def __init__(self, name: str, help: str = "",
                 buckets: Sequence[float] = DURATION_BUCKETS_S):
        bounds = tuple(sorted(float(b) for b in buckets))
        if not bounds or any(b1 <= b0 for b0, b1 in zip(bounds, bounds[1:])):
            raise ValueError(f"histogram {name}: bad buckets {buckets}")
        self.name = name
        self.help = help
        self.bounds = bounds
        self.counts = [0] * (len(bounds) + 1)   # +1: the +Inf bucket
        self.sum = 0.0
        self.count = 0

    def observe(self, v: float) -> None:
        self.counts[bisect_left(self.bounds, v)] += 1
        self.sum += v
        self.count += 1

    def snapshot(self):
        cum = 0
        buckets = []
        for le, c in zip(self.bounds, self.counts):
            cum += c
            buckets.append([le, cum])
        buckets.append(["+Inf", self.count])
        return {"sum": self.sum, "count": self.count, "buckets": buckets}


_METRIC_TYPES = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class _Family:
    """Labeled metric family: ``family.labels(engine="x")`` -> child."""

    __slots__ = ("name", "help", "kind", "label_names", "children", "_kw")

    def __init__(self, name: str, kind: str, help: str,
                 label_names: Sequence[str], **kw):
        self.name = name
        self.help = help
        self.kind = kind
        self.label_names = tuple(label_names)
        self.children: dict[tuple, object] = {}
        self._kw = kw

    def labels(self, **labels):
        if set(labels) != set(self.label_names):
            raise ValueError(
                f"metric {self.name}: labels {sorted(labels)} != declared "
                f"{sorted(self.label_names)}")
        key = tuple(str(labels[k]) for k in self.label_names)
        child = self.children.get(key)
        if child is None:
            child = _METRIC_TYPES[self.kind](self.name, self.help, **self._kw)
            self.children[key] = child
        return child

    def snapshot(self):
        return {
            "{" + ",".join(f"{k}={v}"
                           for k, v in zip(self.label_names, key)) + "}":
            child.snapshot()
            for key, child in sorted(self.children.items())
        }


class MetricsRegistry:
    """Named metrics, get-or-create, kind-checked on re-registration."""

    def __init__(self):
        self._metrics: dict[str, object] = {}
        self._lock = threading.Lock()

    def _get(self, name: str, kind: str, help: str,
             labels: Sequence[str] = (), **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                if labels:
                    m = _Family(name, kind, help, labels, **kw)
                else:
                    m = _METRIC_TYPES[kind](name, help, **kw)
                self._metrics[name] = m
            elif m.kind != kind:
                raise ValueError(
                    f"metric {name!r} already registered as {m.kind}, "
                    f"requested {kind}")
            return m

    def counter(self, name: str, help: str = "",
                labels: Sequence[str] = ()):
        return self._get(name, "counter", help, labels)

    def gauge(self, name: str, help: str = "", labels: Sequence[str] = ()):
        return self._get(name, "gauge", help, labels)

    def histogram(self, name: str, help: str = "",
                  labels: Sequence[str] = (),
                  buckets: Sequence[float] = DURATION_BUCKETS_S):
        return self._get(name, "histogram", help, labels, buckets=buckets)

    def names(self) -> list[str]:
        with self._lock:
            return sorted(self._metrics)

    def snapshot(self) -> dict:
        """Plain JSON-serializable ``{name: value | bucket-table}`` dict."""
        with self._lock:
            return {name: m.snapshot()
                    for name, m in sorted(self._metrics.items())}

    def render_prometheus(self) -> str:
        """Text exposition format (one family per registered metric)."""
        out: list[str] = []
        with self._lock:
            items = sorted(self._metrics.items())
        for name, m in items:
            pn = _prom_name(name)
            if m.help:
                out.append(f"# HELP {pn} {m.help}")
            out.append(f"# TYPE {pn} {m.kind}")
            if isinstance(m, _Family):
                for key, child in sorted(m.children.items()):
                    lbl = ",".join(f'{k}="{v}"'
                                   for k, v in zip(m.label_names, key))
                    out.extend(_render_one(pn, child, "{" + lbl + "}"))
            else:
                out.extend(_render_one(pn, m, ""))
        return "\n".join(out) + "\n"


def _render_one(pn: str, m, lbl: str) -> Iterable[str]:
    if m.kind in ("counter", "gauge"):
        return [f"{pn}{lbl} {_fmt(m.value)}"]
    lines = []
    cum = 0
    base = lbl[1:-1] if lbl else ""
    sep = "," if base else ""
    for le, c in zip(m.bounds, m.counts):
        cum += c
        lines.append(f'{pn}_bucket{{{base}{sep}le="{_fmt(le)}"}} {cum}')
    lines.append(f'{pn}_bucket{{{base}{sep}le="+Inf"}} {m.count}')
    lines.append(f"{pn}_sum{lbl} {_fmt(m.sum)}")
    lines.append(f"{pn}_count{lbl} {m.count}")
    return lines


# Engine stats keys that are point-in-time values, not monotone counts.
_GAUGE_PREFIXES = ("peak_",)


class EngineStats(dict):
    """The engines' ``stats`` dict, mirrored into a registry.

    A true ``dict`` subclass: reads (``[]``, ``.get``, ``in``,
    ``.items()``, ``json.dump``) are inherited verbatim, so every
    caller — the launch CLI, ``chip_smoke.py``, snapshot save — sees
    exactly the old shape.  Writes (``[]=``, ``update``, ``setdefault``)
    additionally push the value into a same-named ``serve_*`` metric, so
    ``registry.snapshot()`` / ``render_prometheus()`` expose the counters
    without the engine code writing anything twice.  ``update`` with
    absolute values (the snapshot-restore path) resyncs the metrics too.
    """

    def __init__(self, registry: Optional[MetricsRegistry] = None,
                 initial=None, prefix: str = "serve"):
        super().__init__()
        self._registry = registry
        self._prefix = prefix
        if initial:
            self.update(initial)

    def _mirror(self, k: str, v) -> None:
        reg = self._registry
        if reg is None:
            return
        name = f"{self._prefix}_{k}"
        if k.startswith(_GAUGE_PREFIXES):
            reg.gauge(name).set(v)
        else:
            reg.counter(name).set(v)

    def __setitem__(self, k, v) -> None:
        super().__setitem__(k, v)
        self._mirror(k, v)

    def update(self, other=(), **kw) -> None:
        for k, v in dict(other, **kw).items():
            self[k] = v

    def setdefault(self, k, default=None):
        if k not in self:
            self[k] = default
        return dict.__getitem__(self, k)


def bench_payload(rows: Iterable[tuple], **extra) -> dict:
    """The shared ``--json`` payload for timing scripts.

    ``rows`` follow the harness contract ``(name, us_per_call, derived)``;
    the payload keeps the historical ``us_per_call`` / ``derived`` maps
    and stamps ``schema_version`` so downstream consumers can tell
    instrumented artifacts from stale ones.
    """
    rows = list(rows)
    payload = {
        "schema_version": SCHEMA_VERSION,
        "us_per_call": {name: us for name, us, _ in rows},
        "derived": {name: derived for name, _, derived in rows},
    }
    payload.update(extra)
    return payload
