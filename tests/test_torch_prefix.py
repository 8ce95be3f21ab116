"""The port's prefix sharing against the reference's.

The radix index's unit cases (page-granular matching, the copy-on-write
plan, first writer wins, deterministic LRU, the read-only probe, batch
eviction), then the engine: with sharing on and off, single-shot and
chunked, and under preemption, the port's greedy streams and its prefix
counters (``prefix_hits``, ``prefix_hit_tokens``, ``prefix_evictions``,
``prefix_cow_copies``, ...) equal the reference engine's on the same
weights; and a copy-on-write never changes a shared page's bytes.
"""
import contextlib
import os

import numpy as np
import pytest
import torch

from repro.serve import ContinuousEngine as JContinuousEngine
from repro.serve import PrefixIndex as JPrefixIndex
from repro_torch.serve import (ContinuousEngine, FCFSScheduler,
                               PageAllocator, PrefixIndex, restore_engine,
                               run_sequential, save_engine)

from test_torch_model import build_pair

torch.set_num_threads(1)

PREFIX_STATS = ("prefix_hits", "prefix_hit_tokens", "prefix_misses",
                "prefix_evictions", "prefix_cow_copies", "shared_prefills",
                "preemptions", "prompt_tokens", "prefill_calls",
                "prefill_chunks")


@pytest.fixture(scope="module")
def pair():
    return build_pair()


@contextlib.contextmanager
def serve_checks():
    old = os.environ.get("REPRO_SERVE_CHECKS")
    os.environ["REPRO_SERVE_CHECKS"] = "1"
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("REPRO_SERVE_CHECKS", None)
        else:
            os.environ["REPRO_SERVE_CHECKS"] = old


def shared_prefix_workload(vocab, seed=0):
    """Prompts around page_size=4: an exact-multiple repeat (COW on the
    second), a fully covered shorter prompt (COW), a partial hit with a
    private tail, and a cold miss."""
    rng = np.random.default_rng(seed)
    base = rng.integers(1, vocab, size=16).astype(np.int32)
    cold = rng.integers(1, vocab, size=10).astype(np.int32)
    tail = rng.integers(1, vocab, size=9).astype(np.int32)
    return [
        {"rid": 0, "prompt": base.copy(), "max_new_tokens": 4},
        {"rid": 1, "prompt": base.copy(), "max_new_tokens": 4},
        {"rid": 2, "prompt": base[:8].copy(), "max_new_tokens": 4},
        {"rid": 3, "prompt": np.concatenate([base[:12], tail]),
         "max_new_tokens": 4},
        {"rid": 4, "prompt": cold, "max_new_tokens": 4},
    ]


def pressure_workload(vocab):
    rng = np.random.default_rng(1)
    base = rng.integers(1, vocab, size=12).astype(np.int32)
    wl = [{"rid": 0, "prompt": base.copy(), "max_new_tokens": 8}]
    for i in range(1, 6):
        tail = rng.integers(1, vocab, size=4 + i).astype(np.int32)
        wl.append({"rid": i,
                   "prompt": np.concatenate([base[:4 * (i % 3 + 1)], tail]),
                   "max_new_tokens": 6})
    return wl


def drain_both(pair, wl, **kw):
    jm, jp, tm, _ = pair
    kw.setdefault("page_size", 4)
    kw.setdefault("max_request_len", 32)
    jeng = JContinuousEngine(jm, jp, **kw)
    eng = ContinuousEngine(tm, **kw)
    for e in (jeng, eng):
        for r in wl:
            e.submit(r["prompt"], r["max_new_tokens"])
    with serve_checks():
        got = eng.drain()
    return jeng, jeng.drain(), eng, got


def assert_matches_reference(jeng, want, eng, got, wl):
    for r in wl:
        np.testing.assert_array_equal(got[r["rid"]],
                                      np.asarray(want[r["rid"]]),
                                      err_msg=f"rid {r['rid']}")
    for k in PREFIX_STATS:
        assert eng.stats[k] == jeng.stats[k], k
    assert eng.step_trace == jeng.step_trace
    assert eng.preempt_log == jeng.preempt_log
    assert eng.prefix.blocks() == jeng.prefix.blocks()
    eng.kv.allocator.check_invariants()


# -- the engine against the reference ------------------------------------------------


@pytest.mark.parametrize("chunk", [0, 5])
def test_sharing_matches_reference_and_off(pair, chunk):
    tm = pair[2]
    wl = shared_prefix_workload(tm.cfg.vocab_size)
    jeng, want, eng, got = drain_both(pair, wl, max_slots=1,
                                      prefill_chunk=chunk, prefix_cache=True)
    assert_matches_reference(jeng, want, eng, got, wl)
    s = eng.stats
    assert s["prefix_hits"] > 0 and s["prefix_cow_copies"] >= 2
    assert s["shared_prefills"] >= 3 and s["prefix_misses"] >= 1
    off = ContinuousEngine(tm, page_size=4, max_request_len=32, max_slots=1,
                           prefill_chunk=chunk)
    for r in wl:
        off.submit(r["prompt"], r["max_new_tokens"])
    off_out = off.drain()
    seq = run_sequential(tm, wl, cache_len=eng.gather_tokens)
    for r in wl:
        np.testing.assert_array_equal(got[r["rid"]], off_out[r["rid"]])
        np.testing.assert_array_equal(got[r["rid"]], seq[r["rid"]])
    assert off.stats["prefix_hits"] == 0
    # sharing recomputed fewer prompt tokens for the same streams; chunked,
    # the resume point rounds down to a chunk start and re-feeds rows
    assert s["prompt_tokens"] < off.stats["prompt_tokens"]
    if chunk == 0:
        assert s["prompt_tokens"] + s["prefix_hit_tokens"] == \
            off.stats["prompt_tokens"]


@pytest.mark.parametrize("chunk", [0, 5])
def test_sharing_under_preemption_matches_reference(pair, chunk):
    tm = pair[2]
    wl = pressure_workload(tm.cfg.vocab_size)
    jeng, want, eng, got = drain_both(pair, wl, n_blocks=14, max_slots=3,
                                      prefill_chunk=chunk, reserve="prompt",
                                      prefix_cache=True)
    assert_matches_reference(jeng, want, eng, got, wl)
    assert eng.stats["preemptions"] > 0 and eng.stats["prefix_hits"] > 0
    seq = run_sequential(tm, wl, cache_len=eng.gather_tokens)
    for r in wl:
        np.testing.assert_array_equal(got[r["rid"]], seq[r["rid"]])


def test_probe_under_pool_pressure_then_eviction(pair):
    """A waiting request keeps probing a cached prefix while two running
    requests fill the pool and force index evictions (the reference's
    regression scenario): streams and eviction counts as the reference."""
    jm, jp, tm, _ = pair
    rng = np.random.default_rng(5)
    V = tm.cfg.vocab_size
    base = rng.integers(1, V, size=8).astype(np.int32)
    cold = [rng.integers(1, V, size=4).astype(np.int32) for _ in range(3)]
    tail = rng.integers(1, V, size=4).astype(np.int32)
    wl = [{"rid": 0, "prompt": base.copy(), "max_new_tokens": 4},
          {"rid": 1, "prompt": cold[0], "max_new_tokens": 4},
          {"rid": 2, "prompt": cold[1], "max_new_tokens": 16},
          {"rid": 3, "prompt": cold[2], "max_new_tokens": 8},
          {"rid": 4, "prompt": np.concatenate([base, tail]),
           "max_new_tokens": 8}]
    kw = dict(page_size=4, n_blocks=9, max_slots=3, max_request_len=24,
              prefix_cache=True)
    jeng, eng = JContinuousEngine(jm, jp, **kw), ContinuousEngine(tm, **kw)
    for e in (jeng, eng):
        for batch in (wl[:1], wl[1:2], wl[2:]):
            for r in batch:
                e.submit(r["prompt"], r["max_new_tokens"])
            e.drain()
    assert eng.stats["prefix_evictions"] >= 1
    for k in PREFIX_STATS:
        assert eng.stats[k] == jeng.stats[k], k
    seq = run_sequential(tm, wl, cache_len=eng.gather_tokens)
    for r in wl:
        np.testing.assert_array_equal(eng.requests[r["rid"]].tokens,
                                      np.asarray(jeng.requests[
                                          r["rid"]].tokens))
        np.testing.assert_array_equal(eng.requests[r["rid"]].tokens,
                                      seq[r["rid"]])
    eng.kv.allocator.check_invariants()


def test_cow_never_mutates_shared_page(pair):
    """A fully covered prompt gathers the donor page (a copy) and writes
    only private blocks: every indexed block's bytes are unchanged after
    the COW request ran to completion."""
    tm = pair[2]
    rng = np.random.default_rng(2)
    base = rng.integers(1, tm.cfg.vocab_size, size=8).astype(np.int32)
    eng = ContinuousEngine(tm, page_size=4, max_slots=1, max_request_len=24,
                           prefix_cache=True)
    eng.submit(base.copy(), 3)
    eng.drain()
    indexed = eng.prefix.blocks()
    assert indexed, "first request indexed nothing"
    idx = torch.as_tensor(indexed)

    def pool_bytes():
        return [t[idx].clone() for pool in eng.kv.pools
                for t in pool.values()]

    before = pool_bytes()
    eng.submit(base.copy(), 3)       # fully covered: the COW path
    eng.drain()
    assert eng.stats["prefix_cow_copies"] == 1
    for b, a in zip(before, pool_bytes()):
        assert torch.equal(b, a), "a shared page's bytes changed"
    # the gather copies: the temp cache holds no view of a pool page
    cache = tm.init_cache(1, 8, torch.float32, full_length=True)
    eng.kv.read_pages(cache, indexed)
    cache[0]["k"].fill_(7.0)
    assert torch.equal(pool_bytes()[0], before[0])


def test_snapshot_restore_with_sharing(pair, tmp_path):
    tm = pair[2]
    wl = shared_prefix_workload(tm.cfg.vocab_size, seed=3)
    eng = ContinuousEngine(tm, page_size=4, max_slots=2, max_request_len=32,
                           prefix_cache=True)
    ref = run_sequential(tm, wl, cache_len=eng.gather_tokens)
    for r in wl:
        eng.submit(r["prompt"], r["max_new_tokens"])
    for _ in range(5):
        eng.step()
    path = str(tmp_path / "snap.npz")
    save_engine(eng, path)
    eng2 = restore_engine(path, tm)
    assert eng2.prefix is not None and eng2.prefix.n_nodes == 0
    out = eng2.drain()
    for r in wl:
        np.testing.assert_array_equal(out[r["rid"]], ref[r["rid"]])
    assert eng2.prefix.n_nodes > 0
    eng2.kv.allocator.check_invariants()


def test_hit_discounted_reservations_admit_more(pair):
    tm = pair[2]
    base = np.random.default_rng(4).integers(
        1, tm.cfg.vocab_size, size=16).astype(np.int32)
    kw = dict(n_blocks=13, max_slots=6, page_size=4, max_request_len=32)

    def run(prefix_cache):
        eng = ContinuousEngine(tm, prefix_cache=prefix_cache, **kw)
        for _ in range(6):
            eng.submit(base.copy(), 4)
        peak = 0
        while not eng.idle:
            eng.step()
            peak = max(peak, eng.scheduler.n_running)
        return eng, {r.rid: r.generated for r in eng.requests.values()}, peak

    _, off, peak_off = run(False)
    eng_on, on, peak_on = run(True)
    for rid in off:
        np.testing.assert_array_equal(on[rid], off[rid])
    assert peak_on > peak_off, (peak_on, peak_off)
    eng_on.kv.allocator.check_invariants()


# -- the radix index ---------------------------------------------------------------


class _FakeReq:
    def __init__(self, rid, prompt_len, max_new):
        self.rid = rid
        self.prompt_len = prompt_len
        self.max_new_tokens = max_new
        self.arrival_step = 0


@pytest.mark.parametrize("overlap", [False, True])
def test_same_batch_pins_accumulate_across_admit(overlap):
    pins = {0: frozenset({10, 11}),
            1: frozenset({10, 11}) if overlap else frozenset({12, 13})}
    sched = FCFSScheduler(page_size=4, max_slots=4, max_live_tokens=0,
                          n_blocks_capacity=5, reserve="worst_case",
                          prefix_probe=lambda r: (2, pins[r.rid]),
                          pinned_external=lambda: 0)
    sched.submit(_FakeReq(0, 8, 4))
    sched.submit(_FakeReq(1, 8, 4))
    admitted = [r.rid for r in sched.admit()]
    assert admitted == ([0, 1] if overlap else [0])


def test_prefix_index_match_and_cow_plan():
    ix = PrefixIndex(4)
    toks = np.arange(12, dtype=np.int32)
    assert ix.plan(toks, now=0).hit_pages == 0
    assert ix.insert(toks, [7, 8, 9], 12, now=0) == [7, 8, 9]
    p = ix.plan(np.concatenate([toks[:8], np.int32([99, 98, 97])]), now=1)
    assert p.blocks == [7, 8] and p.cow_src is None and p.suffix_start == 8
    p = ix.plan(toks, now=2)
    assert p.blocks == [7, 8] and p.cow_src == 9 and p.suffix_start == 11
    assert p.hit_pages == 3 and p.hit_tokens == 11
    p = ix.plan(toks[:10], now=3)
    assert p.blocks == [7, 8] and p.cow_src is None and p.suffix_start == 8
    bad = toks.copy()
    bad[5] = 99
    assert ix.plan(bad, now=4).blocks == [7]


def test_prefix_index_first_writer_wins():
    ix = PrefixIndex(4)
    toks = np.arange(8, dtype=np.int32)
    assert ix.insert(toks, [3, 4], 8, now=0) == [3, 4]
    assert ix.insert(toks, [5, 6], 8, now=1) == []
    assert ix.plan(np.concatenate([toks, np.int32([1, 2, 3])]),
                   now=2).blocks == [3, 4]
    toks2 = np.concatenate([toks, np.int32([9, 9, 9])])
    assert ix.insert(toks2, [5, 6, 7], 11, now=3) == []
    assert ix.n_nodes == 2


def test_prefix_index_lru_eviction_deterministic():
    ix = PrefixIndex(2)
    a, b = np.int32([1, 1, 2, 2]), np.int32([1, 1, 3, 3])
    ix.insert(a, [10, 11], 4, now=0)
    ix.insert(b, [10, 12], 4, now=0)
    assert [ix.evict_one(lambda blk: True) for _ in range(4)] == \
        [11, 12, 10, None]
    ix.insert(a, [10, 11], 4, now=5)
    ix.insert(b, [10, 12], 4, now=5)
    ix.plan(a, now=9)
    assert ix.evict_one(lambda blk: True) == 12
    assert ix.evict_one(lambda blk: blk != 11) is None
    ix.drop_all()
    assert ix.n_nodes == 0 and ix.blocks() == []


def test_prefix_index_probe_is_read_only():
    ix = PrefixIndex(2)
    a = np.int32([1, 1, 2, 2])
    ix.insert(a, [10, 11], 4, now=0)
    ix.insert(np.int32([5, 5]), [12], 2, now=1)
    ix.plan(a, now=None)
    assert ix.plan(a, now=None).blocks == [10]
    assert [ix.evict_one(lambda blk: True) for _ in range(3)] == [11, 10, 12]


def test_prefix_index_batch_eviction_matches_single_and_reference():
    """Batch eviction reproduces repeated single evictions, and the
    port's index evicts exactly what the reference's does."""
    def build(cls):
        ix = cls(2)
        ix.insert(np.int32([1, 1, 2, 2, 3, 3]), [10, 11, 12], 6, now=0)
        ix.insert(np.int32([1, 1, 4, 4]), [10, 13], 4, now=2)
        ix.insert(np.int32([5, 5]), [14], 2, now=1)
        return ix

    gate = lambda blk: blk != 13
    seq, ix = [], build(PrefixIndex)
    while (blk := ix.evict_one(gate)) is not None:
        seq.append(blk)
    assert seq == [12, 11, 14]
    assert build(PrefixIndex).evict_lru(gate, 10) == seq
    assert build(JPrefixIndex).evict_lru(gate, 10) == seq
    ix2 = build(PrefixIndex)
    assert ix2.evict_lru(gate, 2) == seq[:2] and ix2.evict_lru(gate, 0) == []


def test_prefix_index_random_ops_match_reference():
    """Random inserts, plans and evictions on both indexes: every result
    and the block set are equal step by step."""
    rng = np.random.default_rng(7)
    ix, jix = PrefixIndex(2), JPrefixIndex(2)
    next_block = 1
    for now in range(200):
        toks = rng.integers(0, 3, size=int(rng.integers(1, 9))).astype(
            np.int32)
        op = rng.integers(3)
        if op == 0:
            blocks = list(range(next_block, next_block + len(toks) // 2))
            next_block += len(blocks)
            assert ix.insert(toks, blocks, len(toks), now) == \
                jix.insert(toks, blocks, len(toks), now)
        elif op == 1:
            p, q = ix.plan(toks, now), jix.plan(toks, now)
            assert (p.blocks, p.cow_src, p.suffix_start) == \
                (q.blocks, q.cow_src, q.suffix_start)
        else:
            n = int(rng.integers(0, 3))
            gate = lambda blk: blk % 3 != 0
            assert ix.evict_lru(gate, n) == jix.evict_lru(gate, n)
        assert ix.blocks() == jix.blocks() and ix.n_nodes == jix.n_nodes


def test_prefix_index_with_allocator_lifecycle():
    """Allocator + index driven the way the engine drives them: indexed
    blocks outlive their writer, a pinned claim is never freed or
    evicted, and everything returns to the pool."""
    alloc, ix = PageAllocator(10), PrefixIndex(4)
    toks = np.arange(8, dtype=np.int32)
    first = alloc.alloc(2)
    alloc.share(ix.insert(toks, first, 8, now=0))
    alloc.release(first)
    assert all(alloc.refcount(b) == 1 for b in first)
    plan = ix.plan(toks, now=1)
    assert plan.cow_src == first[1]
    alloc.share(list(plan.blocks) + [plan.cow_src])
    with pytest.raises(ValueError):
        alloc.free([first[0]])
    assert ix.evict_one(lambda b: alloc.refcount(b) == 1) is None
    alloc.release([plan.cow_src])
    alloc.release(plan.blocks)
    for want in (first[1], first[0]):
        blk = ix.evict_one(lambda b: alloc.refcount(b) == 1)
        assert blk == want
        alloc.release([blk])
    assert alloc.n_allocated == 0 and alloc.n_free == alloc.n_total
    alloc.check_invariants()
