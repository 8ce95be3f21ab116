"""The port's request lifecycle against the reference engine's.

Mirrors tests/test_serve_lifecycle.py, with each run held against the
reference engine on the same weights: preemption under ``reserve="prompt"``
(single-shot and chunked: streams, ``preempt_log``, preemption and
resumed-prefill counts), cancellation, expiry, ``retries_exhausted``, the
watchdog's diagnostics, the fault soak (states, streams and the
allocator's block-id trace), snapshots (restored runs finish with the
oracle's streams; another plan fingerprint is refused) and the static
engine.  The allocator's sharing and quarantine invariants get a property
test that sets ``REPRO_SERVE_CHECKS`` itself (a function-scoped fixture
inside ``@given`` fails hypothesis's health check).
"""
import contextlib
import os

import numpy as np
import pytest
import torch

from repro.serve import ContinuousEngine as JContinuousEngine
from repro.serve import FaultSchedule as JFaultSchedule
from repro.serve import StaticEngine as JStaticEngine
from repro_torch.serve import (CANCELLED, DECODING, EXPIRED, FAILED,
                               FINISHED, QUEUED, TERMINAL_STATES,
                               ContinuousEngine, EngineStallError,
                               FaultEvent, FaultSchedule, PageAllocator,
                               Request, RequestError, StaticEngine,
                               make_engine, restore_engine, run_sequential,
                               transition)

from test_torch_model import build_pair

torch.set_num_threads(1)

# decode growth overflows a small pool: prompts reserve 1+3+2+4+2 = 12
# blocks at page 4, generations force 13 more
SHAPES = [(4, 8), (12, 10), (8, 9), (16, 6), (6, 10)]


@pytest.fixture(scope="module")
def pair():
    return build_pair()


@contextlib.contextmanager
def serve_checks():
    """REPRO_SERVE_CHECKS=1 for the block (every allocator mutation
    re-checks its invariants and records handed-out block ids)."""
    old = os.environ.get("REPRO_SERVE_CHECKS")
    os.environ["REPRO_SERVE_CHECKS"] = "1"
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("REPRO_SERVE_CHECKS", None)
        else:
            os.environ["REPRO_SERVE_CHECKS"] = old


def make_workload(vocab, shapes=SHAPES, seed=0):
    rng = np.random.default_rng(seed)
    return [{"rid": i, "prompt": rng.integers(0, vocab, s).astype(np.int32),
             "max_new_tokens": g} for i, (s, g) in enumerate(shapes)]


def engine_kw(**kw):
    kw.setdefault("page_size", 4)
    kw.setdefault("max_slots", 4)
    kw.setdefault("max_request_len", 40)
    return kw


def run_both(pair, wl, jfaults=None, faults=None, **kw):
    """The reference and the port engine drained on ``wl``."""
    jm, jp, tm, _ = pair
    kw = engine_kw(**kw)
    jeng = JContinuousEngine(jm, jp, faults=jfaults, **kw)
    eng = ContinuousEngine(tm, faults=faults, **kw)
    for e in (jeng, eng):
        for r in wl:
            e.submit(r["prompt"], r["max_new_tokens"])
    return jeng, jeng.drain(), eng, eng.drain()


def assert_same_streams(got, want, what=""):
    assert set(got) == set(want), what
    for rid in want:
        np.testing.assert_array_equal(np.asarray(got[rid]),
                                      np.asarray(want[rid]),
                                      err_msg=f"{what} rid {rid}")


# -- state machine ------------------------------------------------------------------


def test_transition_edges():
    req = Request(rid=0, prompt=np.zeros(4, np.int32), max_new_tokens=2)
    assert req.state == QUEUED
    for to in ("PREFILLING", "DECODING", "QUEUED", "PREFILLING", "DECODING",
               FINISHED):
        transition(req, to)
    with pytest.raises(RuntimeError, match="illegal lifecycle transition"):
        transition(req, "DECODING")
    req2 = Request(rid=1, prompt=np.zeros(4, np.int32), max_new_tokens=2)
    with pytest.raises(RuntimeError, match="illegal"):
        transition(req2, FINISHED)


def test_request_error_codes(pair):
    tm = pair[2]
    eng = ContinuousEngine(tm, page_size=4, max_slots=2, max_request_len=16)
    cases = [
        (dict(prompt=np.zeros((0,), np.int32), max_new_tokens=2),
         "bad_prompt"),
        (dict(prompt=np.zeros(4, np.int32), max_new_tokens=0),
         "bad_max_new_tokens"),
        (dict(prompt=np.zeros(4, np.int32), max_new_tokens=2,
              deadline_steps=0), "bad_deadline"),
        (dict(prompt=np.zeros(15, np.int32), max_new_tokens=8), "too_long"),
    ]
    for kwargs, reason in cases:
        with pytest.raises(RequestError) as ei:
            eng.submit(**kwargs)
        assert ei.value.reason == reason
        assert isinstance(ei.value, ValueError)
    assert eng.stats["rejected"] == len(cases)
    assert eng._next_rid == 0 and not eng.requests


# -- preemption ------------------------------------------------------------------


@pytest.mark.parametrize("chunk", [0, 4])
def test_preemption_matches_reference(pair, chunk):
    """n_blocks=11 and prompt reservation force evictions; the port
    preempts the same requests at the same steps and resumes them to the
    same streams, which equal the oversized pool's and the oracle's."""
    tm = pair[2]
    wl = make_workload(tm.cfg.vocab_size)
    jeng, want, eng, got = run_both(pair, wl, reserve="prompt", n_blocks=11,
                                    prefill_chunk=chunk)
    assert eng.stats["preemptions"] >= 2, dict(eng.stats)
    assert_same_streams(got, want, "port vs reference")
    assert eng.preempt_log == jeng.preempt_log
    assert eng.step_trace == jeng.step_trace
    for k in ("preemptions", "resumed_prefills", "prefill_calls",
              "prompt_tokens", "decode_steps", "finished"):
        assert eng.stats[k] == jeng.stats[k], k
    if chunk == 0:
        assert eng.stats["resumed_prefills"] >= 2
    else:
        assert all(t["prefill_chunks"] <= 1 for t in eng.step_trace)
    big = ContinuousEngine(tm, **engine_kw(prefill_chunk=chunk))
    for r in wl:
        big.submit(r["prompt"], r["max_new_tokens"])
    assert_same_streams(got, big.drain(), "small vs big pool")
    assert big.stats["preemptions"] == 0
    assert_same_streams(got, run_sequential(tm, wl,
                                            cache_len=eng.gather_tokens),
                        "vs oracle")
    assert all(r.state == FINISHED for r in eng.finished.values())
    alloc = eng.kv.allocator
    assert alloc.n_allocated == 0 and alloc.n_free == alloc.n_total


def test_priority_orders_victims(pair):
    jm, jp, tm, _ = pair
    wl = make_workload(tm.cfg.vocab_size)
    kw = engine_kw(reserve="prompt", n_blocks=11)
    jeng, eng = JContinuousEngine(jm, jp, **kw), ContinuousEngine(tm, **kw)
    for e in (jeng, eng):
        for r in wl:
            e.submit(r["prompt"], r["max_new_tokens"],
                     priority=1 if r["rid"] == 1 else 0)
    assert_same_streams(eng.drain(), jeng.drain())
    assert eng.stats["preemptions"] >= 2
    assert all(rid != 1 for _, rid, _ in eng.preempt_log)
    assert eng.preempt_log == jeng.preempt_log


# -- deadlines / cancellation ----------------------------------------------------


def test_deadline_expiry_matches_reference(pair):
    jm, jp, tm, _ = pair
    kw = dict(page_size=4, max_slots=2, max_request_len=40)
    jeng, eng = JContinuousEngine(jm, jp, **kw), ContinuousEngine(tm, **kw)
    for e in (jeng, eng):
        e.submit(np.arange(4, dtype=np.int32) % 7, 3)
        e.submit(np.arange(8, dtype=np.int32) % 7, 30, deadline_steps=5)
    assert_same_streams(eng.drain(), jeng.drain())
    fast, slow = eng.requests[0], eng.requests[1]
    assert fast.state == FINISHED and len(fast.tokens) == 3
    assert slow.state == EXPIRED and slow.error.reason == "deadline"
    assert 0 < len(slow.tokens) < 30
    np.testing.assert_array_equal(slow.tokens,
                                  np.asarray(jeng.requests[1].tokens))
    assert str(slow.error) == str(jeng.requests[1].error)
    assert eng.stats["expired"] == jeng.stats["expired"] == 1
    alloc = eng.kv.allocator
    assert alloc.n_allocated == 0 and alloc.n_free == alloc.n_total


def test_cancel(pair):
    tm = pair[2]
    eng = ContinuousEngine(tm, page_size=4, max_slots=1, max_request_len=40)
    rid_run = eng.submit(np.arange(4, dtype=np.int32) % 7, 20)
    rid_wait = eng.submit(np.arange(4, dtype=np.int32) % 7, 5)
    eng.step()
    assert eng.requests[rid_run].state == DECODING
    assert eng.cancel(rid_run)
    assert eng.requests[rid_run].state == CANCELLED
    assert eng.kv.allocator.n_allocated == 0
    assert eng.cancel(rid_wait)
    assert eng.requests[rid_wait].state == CANCELLED
    assert not eng.cancel(rid_run)
    assert not eng.cancel(999)
    assert eng.idle and eng.stats["cancelled"] == 2
    # a cancelled chunked prefill leaves no temp state and no pages behind
    eng = ContinuousEngine(tm, page_size=4, max_slots=2, max_request_len=40,
                           prefill_chunk=4)
    rid = eng.submit(np.arange(16, dtype=np.int32) % 7, 4)
    eng.step()
    assert rid in eng._prefilling
    assert eng.cancel(rid) and not eng._prefilling
    assert eng.kv.allocator.n_allocated == 0 and eng.idle


def test_retries_exhausted_matches_reference(pair):
    jm, jp, tm, _ = pair
    events = [(s, "alloc_fail", 2) for s in range(0, 12, 2)]
    kw = dict(page_size=4, max_slots=2, max_request_len=40,
              reserve="prompt", n_blocks=12, max_retries=3,
              preempt_backoff=0)
    from repro.serve import FaultEvent as JFaultEvent

    jeng = JContinuousEngine(jm, jp, faults=JFaultSchedule(
        [JFaultEvent(*e) for e in events]), **kw)
    eng = ContinuousEngine(tm, faults=FaultSchedule(
        [FaultEvent(*e) for e in events]), **kw)
    for e in (jeng, eng):
        e.submit(np.arange(16, dtype=np.int32) % 7, 8)
        e.drain()
    req, jreq = eng.requests[0], jeng.requests[0]
    assert req.state == jreq.state == FAILED
    assert req.error.reason == "retries_exhausted"
    assert req.preemptions == jreq.preemptions == eng.max_retries + 1
    assert eng.preempt_log == jeng.preempt_log
    assert eng.stats["failed"] == 1
    alloc = eng.kv.allocator
    assert alloc.n_allocated == 0 and alloc.n_free == alloc.n_total


# -- watchdog ---------------------------------------------------------------------


def test_watchdog_diagnostics_match_reference(pair):
    jm, jp, tm, _ = pair
    from repro.serve import EngineStallError as JEngineStallError
    from repro.serve import FaultEvent as JFaultEvent

    kw = dict(page_size=4, max_slots=2, max_request_len=40,
              max_idle_steps=10)
    jeng = JContinuousEngine(jm, jp, faults=JFaultSchedule(
        [JFaultEvent(0, "capacity_drop", 100)]), **kw)
    eng = ContinuousEngine(tm, faults=FaultSchedule(
        [FaultEvent(0, "capacity_drop", 100)]), **kw)
    for e in (jeng, eng):
        e.submit(np.arange(4, dtype=np.int32) % 7, 3)
    with pytest.raises(JEngineStallError) as jei:
        jeng.drain()
    with pytest.raises(EngineStallError) as ei:
        eng.drain()
    diag = ei.value.diagnostics
    assert diag == jei.value.diagnostics
    assert diag["pool"]["n_free"] == 0 and diag["pool"]["n_quarantined"] > 0
    assert len(diag["waiting"]) == 1
    assert diag["clock"] >= eng.max_idle_steps - 1
    assert str(ei.value) == str(jei.value)


# -- fault soak -------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(4))
def test_fault_soak_matches_reference(pair, seed):
    """Seeded random fault schedules: every request terminal, survivors'
    streams equal the no-fault run's, the allocator whole and checked at
    every mutation, and the port hands out the reference's block ids in
    the reference's order (the block-id trace) with its states, streams
    and preemption log."""
    tm = pair[2]
    wl = make_workload(tm.cfg.vocab_size)
    base = ContinuousEngine(tm, **engine_kw(reserve="prompt", n_blocks=13))
    for r in wl:
        base.submit(r["prompt"], r["max_new_tokens"])
    baseline = base.drain()
    kw = dict(horizon=24, n_events=4, max_drop=3)
    faults = FaultSchedule.random(seed, **kw)
    assert faults.events == tuple(
        FaultEvent(e.step, e.kind, e.arg)
        for e in JFaultSchedule.random(seed, **kw).events)
    with serve_checks():
        jeng, want, eng, got = run_both(
            pair, wl, jfaults=JFaultSchedule.random(seed, **kw),
            faults=faults, reserve="prompt", n_blocks=13, preempt_backoff=0)
    states = {r.rid: r.state for r in eng.requests.values()}
    assert all(s in TERMINAL_STATES for s in states.values()), states
    assert states == {r.rid: r.state for r in jeng.requests.values()}
    assert_same_streams(got, want, f"seed {seed}")
    for req in eng.requests.values():
        if req.state == FINISHED:
            np.testing.assert_array_equal(got[req.rid], baseline[req.rid])
    assert eng.kv.allocator.trace, "armed trace stayed empty"
    assert eng.kv.allocator.trace == jeng.kv.allocator.trace
    assert eng.preempt_log == jeng.preempt_log
    assert eng._injector.log == jeng._injector.log
    for k in ("preemptions", "fault_kills", "fault_events",
              "fault_paused_steps", "resumed_prefills", "failed"):
        assert eng.stats[k] == jeng.stats[k], k
    alloc = eng.kv.allocator
    alloc.check_invariants()
    assert alloc.n_allocated == 0


def test_allocator_sharing_and_quarantine_invariants():
    """A property test of the port's allocator: random alloc, share,
    release, free, quarantine and restore steps keep every invariant
    (checked at each mutation) and conserve blocks."""
    hypothesis = pytest.importorskip("hypothesis")
    st = hypothesis.strategies

    @hypothesis.settings(max_examples=60, deadline=None)
    @hypothesis.given(st.lists(st.tuples(st.integers(0, 5),
                                         st.integers(0, 6)),
                               min_size=1, max_size=60))
    def run(ops):
        with serve_checks():
            alloc = PageAllocator(12)
            held: list[list[int]] = []
            for op, n in ops:
                if op == 0 and alloc.can_alloc(n):
                    held.append(alloc.alloc(n))
                elif op == 1 and held and held[-1]:
                    alloc.share(held[-1])
                    held.append(list(held[-1]))
                elif op == 2 and held:
                    alloc.release(held.pop(n % len(held)))
                elif op == 3 and held:
                    blocks = held[n % len(held)]
                    if all(alloc.refcount(b) == 1 for b in blocks):
                        alloc.free(blocks)
                        held.remove(blocks)
                elif op == 4:
                    taken = alloc.quarantine(n)
                    assert taken <= n
                elif op == 5:
                    alloc.restore_quarantined(n if n else None)
                assert (alloc.n_free + alloc.n_allocated
                        == alloc.n_total)
                assert (alloc.n_total + alloc.n_quarantined
                        == alloc.n_blocks - 1)
            for blocks in held:
                alloc.release(blocks)
            alloc.restore_quarantined()
            assert alloc.n_allocated == 0
            assert alloc.n_free == alloc.n_total == 11
            assert 0 not in alloc.trace

    run()


# -- snapshot / restore -----------------------------------------------------------


@pytest.mark.parametrize("kill_at", [1, 4, 7])
def test_snapshot_restore_finishes_with_the_reference_streams(pair, tmp_path,
                                                              kill_at):
    jm, jp, tm, _ = pair
    wl = make_workload(tm.cfg.vocab_size)
    from repro.serve import run_sequential as j_run_sequential

    eng = ContinuousEngine(tm, **engine_kw())
    want = j_run_sequential(jm, jp, wl, cache_len=eng.gather_tokens)
    for r in wl:
        eng.submit(r["prompt"], r["max_new_tokens"])
    for _ in range(kill_at):
        eng.step()
    path = str(tmp_path / "engine.npz")
    meta = eng.snapshot(path)
    assert meta["snapshot_version"] == 1 and meta["cache_dtype"] == "float32"
    del eng
    eng2 = restore_engine(path, tm)
    assert_same_streams(eng2.drain(), {r["rid"]: want[r["rid"]] for r in wl},
                        f"kill_at={kill_at}")
    assert all(r.state == FINISHED for r in eng2.finished.values())


def test_snapshot_restore_preserves_terminal_states(pair, tmp_path):
    tm = pair[2]
    eng = ContinuousEngine(tm, page_size=4, max_slots=2, max_request_len=40)
    rid_done = eng.submit(np.arange(4, dtype=np.int32) % 7, 2)
    rid_cancel = eng.submit(np.arange(4, dtype=np.int32) % 7, 9)
    rid_live = eng.submit(np.arange(8, dtype=np.int32) % 7, 4)
    eng.step()
    eng.cancel(rid_cancel)
    eng.step()
    path = str(tmp_path / "engine.npz")
    eng.snapshot(path)
    eng2 = restore_engine(path, tm)
    assert eng2.requests[rid_done].state == FINISHED
    assert eng2.requests[rid_cancel].state == CANCELLED
    assert eng2.requests[rid_live].state == QUEUED
    assert dict(eng2.stats) == dict(eng.stats)
    out = eng2.drain()
    np.testing.assert_array_equal(out[rid_done],
                                  eng.requests[rid_done].tokens)
    assert eng2.requests[rid_live].state == FINISHED
    assert len(out[rid_live]) == 4


def test_snapshot_refuses_another_plan_fingerprint(pair, tmp_path):
    tm = pair[2]
    eng = ContinuousEngine(tm, page_size=4, max_slots=2, max_request_len=40)
    eng.submit(np.arange(4, dtype=np.int32) % 7, 3)
    eng.plan_fingerprint = "deadbeef"
    path = str(tmp_path / "engine.npz")
    eng.snapshot(path)
    with pytest.raises(RuntimeError, match="sparsity plan"):
        restore_engine(path, tm, plan_fingerprint="cafef00d")
    with pytest.raises(RuntimeError, match="sparsity plan"):
        restore_engine(path, tm, plan=tm.cfg.sparsity_rules)
    assert len(restore_engine(path, tm,
                              plan_fingerprint="deadbeef").requests) == 1
    assert len(restore_engine(path, tm).requests) == 1
    with pytest.raises(FileNotFoundError):
        restore_engine(str(tmp_path / "missing.npz"), tm)


# -- the static engine ------------------------------------------------------------


def test_static_engine_matches_reference(pair):
    jm, jp, tm, _ = pair
    wl = make_workload(tm.cfg.vocab_size,
                       [(4, 5), (8, 3), (4, 6), (8, 2), (4, 4), (6, 3)])
    jeng = JStaticEngine(jm, jp, batch=2)
    eng = make_engine("static", tm, batch=2)
    assert isinstance(eng, StaticEngine)
    for e in (jeng, eng):
        for r in wl:
            e.submit(r["prompt"], r["max_new_tokens"])
    assert_same_streams(eng.drain(), jeng.drain())
    for k in ("prefill_calls", "decode_steps", "prompt_tokens",
              "generated_tokens", "wasted_row_steps", "cache_slot_steps",
              "live_token_steps", "steps", "finished"):
        assert eng.stats[k] == jeng.stats[k], k
    seq = run_sequential(tm, wl)
    for r in wl:
        np.testing.assert_array_equal(eng.requests[r["rid"]].tokens,
                                      seq[r["rid"]])
    for kind in ("sharded", "disagg"):
        with pytest.raises(NotImplementedError):
            make_engine(kind, tm)
