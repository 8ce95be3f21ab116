"""The port's chunked prefill against the reference's, on the same weights.

``LMModel.prefill_chunk`` (a full chunk, the ragged last chunk, and a
resume after ``mask_cache_rows``) gives the reference's logits and cache
within 1e-5 * max|ref| in float32; the chunked engine gives the reference
chunked engine's greedy streams and ``step_trace`` for reduced tinyllama
and qwen2-moe; and the temp-cache helpers agree with the reference's.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serve import ContinuousEngine as JContinuousEngine
from repro.serve import chunked as jchunked
from repro_torch.models.transformer import jax_stack_split
from repro_torch.serve import (ContinuousEngine, chunk_cache_len,
                               mask_cache_rows, run_sequential, slice_cache,
                               trim_cache)

from test_torch_model import build_pair
from test_torch_moe_model import build_moe_pair

torch.set_num_threads(1)
TOL = 1e-5


@pytest.fixture(scope="module")
def pair():
    return build_pair()


@pytest.fixture(scope="module")
def moe_pair():
    return build_moe_pair()


def jax_cache_layers(cfg, jcache) -> list:
    """The reference's cache tree (head / scanned periods / tail) as the
    port's list of per-layer dicts of numpy arrays."""
    n_head, period, n_full, tail_start = jax_stack_split(cfg)
    out = []
    for i in range(cfg.n_layers):
        if i < n_head:
            layer = jcache["head"][i]
        elif i < tail_start:
            t, j = divmod(i - n_head, period)
            layer = {k: v[t] for k, v in jcache["scan"][f"j{j}"].items()}
        else:
            layer = jcache["tail"][i - tail_start]
        out.append({k: np.asarray(v) for k, v in layer.items()})
    return out


def assert_close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), (err, np.abs(want).max())


def assert_caches_match(cfg, tcache, jcache):
    for i, (t, j) in enumerate(zip(tcache, jax_cache_layers(cfg, jcache))):
        np.testing.assert_array_equal(t["pos"].numpy(), j["pos"],
                                      err_msg=f"layer {i} pos")
        for name in ("k", "v"):
            assert_close(t[name].numpy(), j[name])


def run_chunks(jm, jp, tm, tokens, cache_len, chunk, starts, jcache=None,
               tcache=None):
    """Feed ``tokens[start:start + chunk]`` (zero-padded) at each start
    through both models; returns (per-chunk (got, want) logits, caches)."""
    if jcache is None:
        jcache = jm.init_cache(1, cache_len, jnp.float32, full_length=True)
        tcache = tm.init_cache(1, cache_len, torch.float32, full_length=True)
    logits = []
    for start in starts:
        n_valid = min(chunk, len(tokens) - start)
        piece = np.zeros((1, chunk), np.int32)
        piece[0, :n_valid] = tokens[start:start + n_valid]
        want, jcache = jm.prefill_chunk(jp, {"tokens": jnp.asarray(piece)},
                                        jcache, jnp.int32(start),
                                        jnp.int32(n_valid))
        got, tcache = tm.prefill_chunk(piece, tcache, start, n_valid)
        logits.append((got.numpy(), np.asarray(want)))
    return logits, jcache, tcache


@pytest.mark.parametrize("model", ["tinyllama", "qwen2-moe"])
def test_prefill_chunk_matches_reference(model, request):
    """Two full chunks and the ragged last one (19 tokens, chunk 8, a
    24-slot temp cache): each chunk's last-valid-row logits and the final
    cache (K, V within 1e-5 * max|ref|, positions equal, the pad rows at
    -1)."""
    jm, jp, tm, _ = request.getfixturevalue(
        "pair" if model == "tinyllama" else "moe_pair")
    tokens = np.random.default_rng(0).integers(
        0, tm.cfg.vocab_size, 19).astype(np.int32)
    logits, jcache, tcache = run_chunks(jm, jp, tm, tokens, 24, 8,
                                        (0, 8, 16))
    for got, want in logits:
        assert got.shape == want.shape == (1, tm.cfg.vocab_size)
        assert_close(got, want)
    assert_caches_match(tm.cfg, tcache, jcache)
    pos = tcache[0]["pos"][0].numpy()
    np.testing.assert_array_equal(pos[:19], np.arange(19))
    assert (pos[19:] == -1).all()
    # the chunked prefill computes what one single-shot prefill computes
    single, _ = tm.prefill(tokens[None], tm.init_cache(1, 24, torch.float32,
                                                       full_length=True))
    assert_close(logits[-1][0], single.numpy(), 1e-4)


def test_prefill_chunk_after_mask_cache_rows_resume(pair):
    """A prefix resume: the cache holds 21 tokens (as after gathering a
    shared prefix), the resume point rounds down to 8, slots [8, 24) are
    masked to -1 and the chunks from 8 on are fed again; logits and cache
    match the reference's same resume, and the resumed logits equal the
    uninterrupted run's."""
    jm, jp, tm, _ = pair
    tokens = np.random.default_rng(1).integers(
        0, tm.cfg.vocab_size, 21).astype(np.int32)
    first, jcache, tcache = run_chunks(jm, jp, tm, tokens, 24, 8,
                                       (0, 8, 16))
    jcache = jchunked.mask_cache_rows(jcache, 8, 24)
    tcache = mask_cache_rows(tcache, 8, 24)
    assert_caches_match(tm.cfg, tcache, jcache)
    assert (tcache[0]["pos"][0, 8:] == -1).all()
    again, jcache, tcache = run_chunks(jm, jp, tm, tokens, 24, 8, (8, 16),
                                       jcache, tcache)
    for got, want in again:
        assert_close(got, want)
    assert_caches_match(tm.cfg, tcache, jcache)
    assert_close(again[-1][0], first[-1][0], 1e-4)


def drain_pair(jm, jp, tm, wl, **kw):
    jeng = JContinuousEngine(jm, jp, **kw)
    eng = ContinuousEngine(tm, **kw)
    for e in (jeng, eng):
        for r in wl:
            e.submit(r["prompt"], r["max_new_tokens"])
    return jeng, jeng.drain(), eng, eng.drain()


def workload(vocab, shapes, seed=0):
    rng = np.random.default_rng(seed)
    return [{"rid": i, "prompt": rng.integers(0, vocab, s).astype(np.int32),
             "max_new_tokens": g} for i, (s, g) in enumerate(shapes)]


@pytest.mark.parametrize("model,chunk", [("tinyllama", 4), ("tinyllama", 5),
                                         ("qwen2-moe", 5)])
def test_chunked_engine_matches_reference_engine(model, chunk, request):
    jm, jp, tm, _ = request.getfixturevalue(
        "pair" if model == "tinyllama" else "moe_pair")
    wl = workload(tm.cfg.vocab_size,
                  [(4, 5), (12, 6), (9, 4), (16, 3), (7, 5)])
    jeng, want, eng, got = drain_pair(jm, jp, tm, wl, page_size=4,
                                      max_slots=3, max_request_len=24,
                                      prefill_chunk=chunk)
    assert set(got) == set(want) == {r["rid"] for r in wl}
    for rid in want:
        np.testing.assert_array_equal(got[rid], np.asarray(want[rid]),
                                      err_msg=f"request {rid}")
    assert eng.step_trace == jeng.step_trace
    assert all(t["prefill_chunks"] <= 1 for t in eng.step_trace)
    for k in ("prefill_chunks", "prefill_calls", "prompt_tokens",
              "decode_steps", "peak_allocated_blocks"):
        assert eng.stats[k] == jeng.stats[k], k
    # and the port's own oracle
    seq = run_sequential(tm, wl, cache_len=eng.gather_tokens)
    for r in wl:
        np.testing.assert_array_equal(got[r["rid"]], seq[r["rid"]])
    assert eng.kv.allocator.n_allocated == 0


@pytest.mark.parametrize("max_len,page,chunk", [
    (24, 4, 5), (40, 4, 4), (40, 8, 6), (7, 16, 3), (576, 16, 128),
    (64, 16, 128), (100, 1, 7)])
def test_chunk_cache_len_matches_reference(max_len, page, chunk):
    got = chunk_cache_len(max_len, page, chunk)
    assert got == jchunked.chunk_cache_len(max_len, page, chunk)
    assert got % page == 0 or got % chunk == 0
    # the last chunk's window and the widest block span both fit
    assert got >= -(-max_len // chunk) * chunk
    assert got >= -(-max_len // page) * page


def test_slice_trim_and_mask_match_reference(pair):
    jm, jp, tm, _ = pair
    tokens = np.random.default_rng(2).integers(
        0, tm.cfg.vocab_size, 13).astype(np.int32)
    _, jcache, tcache = run_chunks(jm, jp, tm, tokens, 16, 8, (0, 8))
    for start, end in ((0, 12), (4, 16), (8, 40), (0, 16)):
        got = slice_cache(tcache, start, end)
        want = jchunked.slice_cache(jcache, start, end)
        assert_caches_match(tm.cfg, got, want)
        assert got[0]["pos"].shape[1] == min(end, 16) - start
    got, want = trim_cache(tcache, 8), jchunked.trim_cache(jcache, 8)
    assert_caches_match(tm.cfg, got, want)
    # views: the slice reads the same storage the temp cache holds
    assert got[0]["k"].data_ptr() == tcache[0]["k"].data_ptr()
    # masking touches only the position marks, and only [start, end)
    k_before = tcache[0]["k"].clone()
    mask_cache_rows(tcache, 3, 40)
    jcache = jchunked.mask_cache_rows(jcache, 3, 40)
    assert_caches_match(tm.cfg, tcache, jcache)
    assert torch.equal(tcache[0]["k"], k_before)
    np.testing.assert_array_equal(tcache[1]["pos"][0, :3].numpy(),
                                  [0, 1, 2])
    assert mask_cache_rows(tcache, 5, 5) is tcache
