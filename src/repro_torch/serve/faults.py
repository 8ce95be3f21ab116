"""Deterministic fault injection for the serving engines.

The port of ``repro/serve/faults.py`` (host bookkeeping, unchanged).

A :class:`FaultSchedule` is an immutable, seed-reproducible list of
:class:`FaultEvent`\\ s pinned to engine-step ticks; the engine threads it
through every step via a :class:`FaultInjector`.  Four fault kinds cover
the production failure modes the robustness layer must absorb:

  * ``capacity_drop`` / ``capacity_restore`` — quarantine ``arg`` free
    blocks out of the :class:`~repro_torch.serve.cache.PageAllocator` (a
    neighbouring tenant grabbing HBM, a pool resize, a device loss taking
    its pages) and later hand them back.  Admission shrinks accordingly
    and live requests whose lazy block growth no longer fits are preempted
    — never corrupted.
  * ``alloc_fail`` — every allocation reports failure for ``arg`` steps (a
    transient allocator outage).  Affected requests are preempted and
    re-admitted with backoff.
  * ``delay`` — the engine makes no forward progress for ``arg`` steps (a
    stalled device / straggler tick).  Deadlines keep ticking; the
    watchdog knows the pause is injected and does not count it.
  * ``kill`` — crash one live request (deterministically chosen:
    ``sorted(live rids)[arg % n_live]``): its pages are freed, its
    generated prefix *discarded*, and it restarts from scratch with
    backoff, bounded by ``max_retries``.  Because sampling is keyed per
    (request, step), a restarted request re-emits byte-identical tokens —
    the fault-soak gate asserts surviving outputs match the no-fault run.

Everything is host-side bookkeeping: fault handling never touches model
math, which is what keeps the bit-exactness contract intact under faults.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Sequence

import numpy as np

__all__ = ["FaultEvent", "FaultSchedule", "FaultInjector", "FAULT_KINDS"]

FAULT_KINDS = ("capacity_drop", "capacity_restore", "alloc_fail", "delay",
               "kill")


@dataclasses.dataclass(frozen=True, order=True)
class FaultEvent:
    """One fault at one engine-step tick. ``arg`` meaning depends on kind:
    blocks to drop/restore, steps to fail/delay, or the kill victim index
    into the sorted live-rid list."""

    step: int
    kind: str
    arg: int = 0

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"have {FAULT_KINDS}")
        if self.step < 0 or self.arg < 0:
            raise ValueError(f"negative step/arg in {self}")


class FaultSchedule:
    """Immutable step-indexed fault plan (seed-reproducible via :meth:`random`)."""

    def __init__(self, events: Iterable[FaultEvent] = ()):
        self.events: tuple[FaultEvent, ...] = tuple(sorted(events))
        self._by_step: dict[int, list[FaultEvent]] = {}
        for ev in self.events:
            self._by_step.setdefault(ev.step, []).append(ev)

    def at(self, step: int) -> Sequence[FaultEvent]:
        return self._by_step.get(step, ())

    @property
    def horizon(self) -> int:
        """Last scheduled tick (engines may run past it fault-free)."""
        return self.events[-1].step if self.events else 0

    def __len__(self) -> int:
        return len(self.events)

    def __repr__(self) -> str:
        return f"FaultSchedule({list(self.events)!r})"

    @classmethod
    def random(cls, seed: int, *, horizon: int = 48, n_events: int = 6,
               max_drop: int = 4, max_fail_steps: int = 2,
               max_delay_steps: int = 2, kill_weight: float = 0.25
               ) -> "FaultSchedule":
        """Seeded random schedule: ~``n_events`` faults in ``[1, horizon)``.

        ``capacity_drop`` events always come with a paired
        ``capacity_restore`` a few ticks later, so a finite schedule can
        never starve the pool forever (the soak must terminate).
        """
        rng = np.random.default_rng(seed)
        kinds = ["capacity", "alloc_fail", "delay", "kill"]
        probs = np.array([1.0, 1.0, 1.0, kill_weight * 4])
        probs = probs / probs.sum()
        events: list[FaultEvent] = []
        for _ in range(n_events):
            kind = kinds[int(rng.choice(len(kinds), p=probs))]
            t = int(rng.integers(1, max(2, horizon)))
            if kind == "capacity":
                n = int(rng.integers(1, max_drop + 1))
                hold = int(rng.integers(2, 10))
                events.append(FaultEvent(t, "capacity_drop", n))
                events.append(FaultEvent(t + hold, "capacity_restore", n))
            elif kind == "alloc_fail":
                events.append(FaultEvent(
                    t, "alloc_fail", int(rng.integers(1, max_fail_steps + 1))
                ))
            elif kind == "delay":
                events.append(FaultEvent(
                    t, "delay", int(rng.integers(1, max_delay_steps + 1))
                ))
            else:
                events.append(FaultEvent(t, "kill", int(rng.integers(0, 8))))
        return cls(events)


class FaultInjector:
    """Engine-owned mutable fault state over an immutable schedule.

    The engine calls :meth:`begin_step` once per step *before* any
    admission/prefill/decode work; the injector applies the tick's events
    against the engine (quarantining pool blocks, arming allocation
    failures, killing requests) and returns whether the step is an
    injected pause.  :meth:`alloc_allowed` gates every allocation attempt.
    """

    def __init__(self, schedule: FaultSchedule):
        self.schedule = schedule
        self._paused_until = 0
        self._alloc_blocked_until = 0
        self.log: list[tuple[int, str, int]] = []

    def begin_step(self, engine, step: int) -> bool:
        for ev in self.schedule.at(step):
            self.log.append((step, ev.kind, ev.arg))
            engine.stats["fault_events"] += 1
            engine._obs.instant(f"fault_{ev.kind}", arg=ev.arg, step=step)
            if ev.kind == "capacity_drop":
                engine.kv.allocator.quarantine(ev.arg)
                engine.scheduler.capacity_blocks = engine.kv.allocator.n_total
            elif ev.kind == "capacity_restore":
                engine.kv.allocator.restore_quarantined(ev.arg)
                engine.scheduler.capacity_blocks = engine.kv.allocator.n_total
            elif ev.kind == "alloc_fail":
                self._alloc_blocked_until = max(
                    self._alloc_blocked_until, step + max(1, ev.arg)
                )
            elif ev.kind == "delay":
                self._paused_until = max(self._paused_until,
                                         step + max(1, ev.arg))
            elif ev.kind == "kill":
                engine._fault_kill(ev.arg)
        paused = step < self._paused_until
        if paused:
            engine.stats["fault_paused_steps"] += 1
        return paused

    def alloc_allowed(self, step: int) -> bool:
        return step >= self._alloc_blocked_until
