"""The port's serving engine: greedy parity with the reference engine and
with its own sequential path, reproducible sampling, allocator
bookkeeping, and the serve launcher end to end (all on the CPU).
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.serve import ContinuousEngine as JContinuousEngine
from repro_torch.data import RequestStream
from repro_torch.serve import (ContinuousEngine, PageAllocator,
                               SamplingParams, run_sequential)

from test_torch_model import build_pair

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def pair():
    return build_pair()


def workload(vocab, n=6, seed=0):
    return RequestStream(vocab, n, prompt_lens=(4, 8, 12),
                         gen_lens=(2, 4, 6, 8), seed=seed).requests()


def submit_all(engine, reqs, sampling=None):
    for r in reqs:
        engine.submit(r["prompt"], r["max_new_tokens"], sampling=sampling)


def test_greedy_streams_match_reference_engine(pair):
    jm, jp, tm, _ = pair
    reqs = workload(tm.cfg.vocab_size)
    jeng = JContinuousEngine(jm, jp, page_size=4, max_slots=3,
                             max_request_len=20)
    submit_all(jeng, reqs)
    want = jeng.drain()
    eng = ContinuousEngine(tm, page_size=4, max_slots=3, max_request_len=20)
    submit_all(eng, reqs)
    got = eng.drain()
    assert set(got) == set(want) == {r["rid"] for r in reqs}
    for rid in want:
        np.testing.assert_array_equal(got[rid], np.asarray(want[rid]),
                                      err_msg=f"request {rid}")
    assert eng.stats["prefill_calls"] == jeng.stats["prefill_calls"]
    assert eng.stats["decode_steps"] == jeng.stats["decode_steps"]
    assert eng.stats["peak_allocated_blocks"] == \
        jeng.stats["peak_allocated_blocks"]


def test_engine_matches_own_sequential_path(pair):
    _, _, tm, _ = pair
    reqs = workload(tm.cfg.vocab_size, seed=1)
    eng = ContinuousEngine(tm, page_size=4, max_slots=3, max_request_len=20)
    submit_all(eng, reqs)
    got = eng.drain()
    want = run_sequential(tm, reqs, cache_len=eng.gather_tokens)
    for r in reqs:
        np.testing.assert_array_equal(got[r["rid"]], want[r["rid"]])
        assert len(got[r["rid"]]) == r["max_new_tokens"]
    # every block went back and the pool is whole again
    assert eng.kv.allocator.n_free == eng.kv.allocator.n_total
    eng.kv.allocator.check_invariants()


def test_temperature_sampling_repeats_under_the_same_seed(pair):
    _, _, tm, _ = pair
    reqs = workload(tm.cfg.vocab_size, seed=2)

    def run(seed, top_k=0):
        eng = ContinuousEngine(tm, page_size=4, max_slots=3,
                               max_request_len=20)
        submit_all(eng, reqs, SamplingParams(temperature=1.5, top_k=top_k,
                                             seed=seed))
        return eng.drain()

    a, b, c = run(5), run(5), run(6)
    for rid in a:
        np.testing.assert_array_equal(a[rid], b[rid])
    assert any(not np.array_equal(a[rid], c[rid]) for rid in a)
    # per-(request, step) keys: the sequential path draws the same stream
    seq = run_sequential(tm, [dict(r, sampling=SamplingParams(
        temperature=1.5, seed=5)) for r in reqs],
        cache_len=ContinuousEngine(tm, page_size=4, max_slots=3,
                                   max_request_len=20).gather_tokens)
    for rid in a:
        np.testing.assert_array_equal(a[rid], seq[rid])
    # top-k = 1 is greedy
    greedy = run_sequential(tm, reqs, cache_len=20)
    k1 = run(7, top_k=1)
    for rid in greedy:
        np.testing.assert_array_equal(k1[rid], greedy[rid])


def test_request_stream_matches_reference():
    from repro.data import RequestStream as JRequestStream

    kw = dict(prompt_lens=(128, 256, 512), gen_lens=(8, 16, 32, 64), seed=3,
              arrival_rate=0.5)
    want = JRequestStream(32000, 5, **kw).requests()
    got = RequestStream(32000, 5, **kw).requests()
    for a, b in zip(got, want):
        assert a.keys() == b.keys()
        np.testing.assert_array_equal(a["prompt"], b["prompt"])
        assert [a[k] for k in ("rid", "max_new_tokens", "arrival_step")] == \
            [b[k] for k in ("rid", "max_new_tokens", "arrival_step")]


def test_page_allocator_conserves_blocks():
    rng = np.random.default_rng(0)
    alloc = PageAllocator(17)
    held: list[list[int]] = []
    for _ in range(400):
        if held and (rng.random() < 0.45 or not alloc.can_alloc(1)):
            blocks = held.pop(int(rng.integers(len(held))))
            if rng.random() < 0.5:
                alloc.free(blocks)
            else:
                assert sorted(alloc.release(blocks)) == sorted(blocks)
        else:
            n = int(rng.integers(0, min(alloc.n_free, 4) + 1))
            blocks = alloc.alloc(n)
            assert 0 not in blocks
            held.append(blocks)
        alloc.check_invariants()
        assert alloc.n_free + alloc.n_allocated == alloc.n_total == 16
        assert alloc.n_allocated == sum(len(b) for b in held)
    with pytest.raises(RuntimeError):
        alloc.alloc(alloc.n_free + 1)
    if held and held[-1]:
        alloc.free(held[-1])
        with pytest.raises(ValueError):
            alloc.free(held[-1])


def _run_launcher(*args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", *args],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)


def test_serve_launcher_runs_on_cpu(tmp_path):
    out = tmp_path / "stats.json"
    p = _run_launcher("--reduced", "--device", "cpu", "--mixed",
                      "--requests", "4", "--prompt-len", "12", "--gen", "6",
                      "--page-size", "4", "--json", str(out))
    assert p.returncode == 0, p.stderr
    assert "served 4 requests" in p.stdout
    assert out.exists()


def test_serve_launcher_without_cuda_names_the_flag():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device works")
    p = _run_launcher("--reduced")
    assert p.returncode != 0
    assert "--device cpu" in p.stdout + p.stderr
