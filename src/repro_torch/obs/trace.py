"""Chrome/Perfetto ``trace_event`` step timelines for the serving engines.

The port of ``repro/obs/trace.py`` (host code, unchanged).

The engine emits two event shapes:

  * **slices** — timed sections ("step", "prefill", "prefill_chunk",
    "decode") become complete events (``ph="X"``) with microsecond
    ``ts``/``dur``;
  * **instants** — point events ("preempt", "restart", "fault_kill",
    "snapshot", "prefix_cow") become ``ph="i"`` markers.

Each logical track (one per section name by default) maps to its own
``tid`` under a single ``pid``, with ``M``-phase ``thread_name`` metadata
so Perfetto labels the rows.  The engine is single-threaded and every
slice is recorded at its close, so per-track timestamps are monotone by
construction — :func:`validate_trace` re-checks that invariant (plus
JSON well-formedness), also from the command line:
``python -m repro_torch.obs.trace out.json``.

Timestamps are relative to the buffer's creation (``ts=0`` at trace
start) to keep the JSON small and diff-friendly.
"""
from __future__ import annotations

import json
import time
from typing import Optional

__all__ = ["TraceBuffer", "validate_trace", "validate_trace_file"]

_PID = 1


class TraceBuffer:
    """Accumulates trace events; ``to_json()``/``save()`` export them."""

    def __init__(self, process_name: str = "repro_torch.serve"):
        self._t0 = time.perf_counter()
        self.events: list[dict] = []
        self._tids: dict[str, int] = {}
        self.process_name = process_name

    def now(self) -> float:
        """Wall seconds since trace start (the slice clock)."""
        return time.perf_counter() - self._t0

    def _tid(self, track: str) -> int:
        tid = self._tids.get(track)
        if tid is None:
            tid = self._tids[track] = len(self._tids) + 1
        return tid

    def slice(self, name: str, start_s: float, end_s: float,
              track: Optional[str] = None, **args) -> None:
        """Record a completed section [start_s, end_s) on a track."""
        self.events.append({
            "name": name,
            "ph": "X",
            "pid": _PID,
            "tid": self._tid(track or name),
            "ts": round(start_s * 1e6, 3),
            "dur": round(max(end_s - start_s, 0.0) * 1e6, 3),
            "args": args,
        })

    def instant(self, name: str, track: str = "events", **args) -> None:
        self.events.append({
            "name": name,
            "ph": "i",
            "s": "t",
            "pid": _PID,
            "tid": self._tid(track),
            "ts": round(self.now() * 1e6, 3),
            "args": args,
        })

    def to_json(self) -> dict:
        meta = [{
            "name": "process_name", "ph": "M", "pid": _PID, "tid": 0,
            "args": {"name": self.process_name},
        }]
        for track, tid in sorted(self._tids.items(), key=lambda kv: kv[1]):
            meta.append({
                "name": "thread_name", "ph": "M", "pid": _PID, "tid": tid,
                "args": {"name": track},
            })
        return {"traceEvents": meta + self.events,
                "displayTimeUnit": "ms"}

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_json(), f)


def validate_trace(doc) -> dict:
    """Check a trace document; raises ValueError on malformed input.

    Validates the shape the trace readers rely on: a ``traceEvents``
    list, every event carrying a phase, X/i events carrying numeric
    non-negative ``ts`` (and ``dur`` for X), and slice start times
    monotonically non-decreasing per (pid, tid) track — slices are
    appended at close by a single-threaded engine, and a regression
    there means the trace renders scrambled in Perfetto.

    Returns summary stats (event/slice/instant/track counts).
    """
    if not isinstance(doc, dict) or "traceEvents" not in doc:
        raise ValueError("trace: missing traceEvents")
    events = doc["traceEvents"]
    if not isinstance(events, list):
        raise ValueError("trace: traceEvents is not a list")
    last_start: dict[tuple, float] = {}
    n_slices = n_instants = 0
    tracks = set()
    for i, ev in enumerate(events):
        if not isinstance(ev, dict) or "ph" not in ev:
            raise ValueError(f"trace: event {i} has no phase: {ev!r}")
        ph = ev["ph"]
        if ph == "M":
            continue
        key = (ev.get("pid"), ev.get("tid"))
        tracks.add(key)
        ts = ev.get("ts")
        if not isinstance(ts, (int, float)) or ts < 0:
            raise ValueError(f"trace: event {i} bad ts {ts!r}")
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                raise ValueError(f"trace: event {i} bad dur {dur!r}")
            prev = last_start.get(key)
            if prev is not None and ts < prev:
                raise ValueError(
                    f"trace: event {i} ({ev.get('name')!r}) ts {ts} < "
                    f"previous slice start {prev} on track {key}")
            last_start[key] = ts
            n_slices += 1
        elif ph == "i":
            n_instants += 1
    return {"events": len(events), "slices": n_slices,
            "instants": n_instants, "tracks": len(tracks)}


def validate_trace_file(path: str) -> dict:
    with open(path) as f:
        doc = json.load(f)
    return validate_trace(doc)


def _main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(
        description="Validate a Perfetto trace_event JSON file")
    p.add_argument("paths", nargs="+", help="trace files to check")
    args = p.parse_args(argv)
    for path in args.paths:
        stats = validate_trace_file(path)
        print(f"{path}: OK — {stats['slices']} slices, "
              f"{stats['instants']} instants on {stats['tracks']} tracks")
    return 0


if __name__ == "__main__":
    raise SystemExit(_main())
