"""The port's observability layer against the reference's.

Units first: the metrics registry, its Prometheus text, ``EngineStats``,
percentiles, request spans (on a fake clock) and the trace buffer give
the reference's results for the same calls.  Then the engines: a recorder
changes no token; on the same workload (preemption, fault soak, prefix
sharing) the port's ``derive_counts`` and counter audit equal the
reference's, its spans' step metrics equal the reference's, and its
registry carries the reference's metric names and counter values; the
serve driver's ``--trace`` output passes ``python -m
repro_torch.obs.trace``.
"""
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.obs as jobs
import repro_torch.obs as tobs
from repro.serve import ContinuousEngine as JContinuousEngine
from repro.serve import FaultSchedule as JFaultSchedule
from repro_torch.serve import ContinuousEngine, FaultSchedule, StaticEngine

from test_torch_model import build_pair

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
SHAPES = [(4, 8), (12, 10), (8, 9), (16, 6), (6, 10)]
# stats that are wall-clock seconds (the two sides time different work)
TIMED = ("prefill_time_s", "decode_time_s")


@pytest.fixture(scope="module")
def pair():
    return build_pair()


# -- units, port against reference ----------------------------------------------------


def registry_scenario(obs):
    reg = obs.MetricsRegistry()
    reg.counter("reqs_total", help="requests").inc()
    reg.counter("reqs_total").inc(2)
    reg.gauge("pool_blocks").set(7)
    reg.gauge("pool_blocks").dec(3)
    h = reg.histogram("lat_seconds", buckets=(0.001, 0.01, 0.1))
    for v in (0.0005, 0.005, 0.05, 5.0):
        h.observe(v)
    fam = reg.counter("per_engine_total", labels=("engine",))
    fam.labels(engine="continuous").inc(2)
    fam.labels(engine="static").inc()
    reg.histogram("dt_seconds").observe(0.7)
    st = obs.EngineStats(reg, {"decode_steps": 0, "peak_allocated_blocks": 0})
    st["decode_steps"] += 3
    st.update(finished=2)
    st.setdefault("handoffs", 0)
    st["peak_allocated_blocks"] = 9
    return reg, st


def test_registry_snapshot_and_prometheus_match_reference():
    assert tobs.SCHEMA_VERSION == jobs.SCHEMA_VERSION == 1
    treg, tst = registry_scenario(tobs)
    jreg, jst = registry_scenario(jobs)
    assert treg.snapshot() == jreg.snapshot()
    assert treg.render_prometheus() == jreg.render_prometheus()
    assert dict(tst) == dict(jst) and isinstance(tst, dict)
    json.dumps(treg.snapshot())
    assert type(treg.gauge("serve_peak_allocated_blocks")).kind == "gauge"
    with pytest.raises(ValueError, match="already registered"):
        treg.gauge("reqs_total")
    with pytest.raises(ValueError, match="labels"):
        treg.counter("per_engine_total", labels=("engine",)).labels(x="y")
    assert tobs.DURATION_BUCKETS_S == jobs.DURATION_BUCKETS_S
    assert tobs.exponential_buckets(1e-6, 2.0, 3) == (1e-6, 2e-6, 4e-6)
    rows = [("k,a", 1.5, 2.0), ("k,b", 3.0, 0.5)]
    assert tobs.bench_payload(rows, x=1) == jobs.bench_payload(rows, x=1)


@pytest.mark.parametrize("vals", [list(range(1, 11)), [7.0], [],
                                  [0.1, 0.2, 10.0], [3, 1, 2, 2]])
def test_percentiles_match_reference(vals):
    for p in (0, 50, 90, 99, 100):
        assert tobs.percentile(vals, p) == jobs.percentile(vals, p)
    assert tobs.percentile_table(vals) == jobs.percentile_table(vals)


class _Req:
    def __init__(self, rid):
        self.rid = rid


def _clock():
    t = [0.0]

    def tick():
        t[0] += 0.5
        return t[0]
    return tick


def span_scenario(obs):
    log = obs.SpanLog(wall=_clock())
    a, b = _Req(0), _Req(7)
    log.on_submit(a, 0)
    log.on_submit(b, 0)
    log.annotate(7, prefix_hit_tokens=8, prefix_hit_pages=2)
    log.annotate(7, prefix_hit_tokens=4)
    log.annotate(99, prefix_hit_tokens=1)
    for r, frm, to, step in [(a, "QUEUED", "PREFILLING", 2),
                             (a, "PREFILLING", "DECODING", 3),
                             (b, "QUEUED", "PREFILLING", 1),
                             (b, "PREFILLING", "DECODING", 2)]:
        log.on_transition(r, frm, to, step)
    for step in (3, 4, 5):
        log.on_token(a, step)
    log.on_token(b, 2)
    log.on_token(b, 3)
    log.on_transition(b, "DECODING", "QUEUED", 4)
    log.on_transition(b, "QUEUED", "PREFILLING", 6)
    log.on_transition(b, "PREFILLING", "DECODING", 7)
    log.on_token(b, 7)
    log.on_transition(a, "DECODING", "FINISHED", 5)
    log.on_transition(b, "DECODING", "FINISHED", 8)
    return log


def test_spans_match_reference():
    tlog, jlog = span_scenario(tobs), span_scenario(jobs)
    for rid in (0, 7):
        assert tlog.request_metrics(rid) == jlog.request_metrics(rid)
    assert tlog.aggregate() == jlog.aggregate()
    m = tlog.request_metrics(7)
    assert m["preemptions"] == 1 and m["lost_steps"] == 3
    assert m["queue_steps"] == 3 and m["prefix_hit_tokens"] == 12
    m = tlog.request_metrics(0)
    assert m["ttft_steps"] == 3 and m["tpot_s"] == pytest.approx(1.0)


def test_trace_buffer_and_validator(tmp_path):
    docs = []
    for obs in (tobs, jobs):
        buf = obs.TraceBuffer()
        buf.slice("step", 0.0, 0.001, track="step", step=0)
        buf.slice("prefill", 0.0002, 0.0008, rid=0)
        buf.slice("a", 0.010, 0.011, track="t1")
        buf.slice("b", 0.005, 0.006, track="t2")
        docs.append(buf.to_json())
    # the same events and tracks; only the process name differs
    strip = lambda d: [e for e in d["traceEvents"]
                       if e["name"] != "process_name"]
    assert strip(docs[0]) == strip(docs[1])
    assert tobs.validate_trace(docs[0]) == jobs.validate_trace(docs[1])
    buf = tobs.TraceBuffer()
    buf.slice("x", 0.0, 0.001)
    buf.instant("preempt", rid=1, step=3)
    path = tmp_path / "t.json"
    buf.save(str(path))
    stats = tobs.validate_trace_file(str(path))
    assert stats["slices"] == 1 and stats["instants"] == 1
    for doc, msg in [
            ([], "missing traceEvents"), ({"traceEvents": 3}, "not a list"),
            ({"traceEvents": [{"name": "x"}]}, "no phase"),
            ({"traceEvents": [{"ph": "X", "ts": -1, "dur": 0}]}, "bad ts"),
            ({"traceEvents": [
                {"ph": "X", "ts": 10, "dur": 1, "pid": 1, "tid": 1},
                {"ph": "X", "ts": 5, "dur": 1, "pid": 1, "tid": 1}]},
             "previous slice start")]:
        with pytest.raises(ValueError, match=msg):
            tobs.validate_trace(doc)


def test_fence_and_null_recorder():
    tree = {"a": torch.ones(2), "b": [torch.zeros(1), 3, "x"], "c": None}
    assert tobs.fence(tree) is tree
    assert tobs.NULL_RECORDER.enabled is False
    assert tobs.NULL_RECORDER.registry is None
    st = {"prefill_time_s": 0.0}
    with tobs.NULL_RECORDER.timed("prefill", st, "prefill_time_s") as tm:
        time.sleep(0.002)
        assert tm.fence(tree) is tree
    assert st["prefill_time_s"] >= 0.002
    rec = tobs.Recorder(spans=False, trace=False)
    st = {"t": 0.0}
    with rec.timed("prefill", st, "t"):
        time.sleep(0.002)
    snap = rec.registry.snapshot()["prefill_seconds"]
    assert snap["count"] == 1 and snap["sum"] == st["t"] >= 0.002


# -- the engines ------------------------------------------------------------------


def make_workload(vocab, shapes=SHAPES, seed=0):
    rng = np.random.default_rng(seed)
    return [{"rid": i, "prompt": rng.integers(0, vocab, s).astype(np.int32),
             "max_new_tokens": g} for i, (s, g) in enumerate(shapes)]


def run_both(pair, wl, jfaults=None, faults=None, **kw):
    """Both engines under a Recorder on ``wl``."""
    jm, jp, tm, _ = pair
    kw.setdefault("page_size", 4)
    kw.setdefault("max_slots", 4)
    kw.setdefault("max_request_len", 40)
    jrec, rec = jobs.Recorder(), tobs.Recorder()
    jeng = JContinuousEngine(jm, jp, recorder=jrec, faults=jfaults, **kw)
    eng = ContinuousEngine(tm, recorder=rec, faults=faults, **kw)
    for e in (jeng, eng):
        for r in wl:
            e.submit(r["prompt"], r["max_new_tokens"])
    return (jeng, jrec, jeng.drain()), (eng, rec, eng.drain())


def assert_obs_match(j, t):
    (jeng, jrec, want), (eng, rec, got) = j, t
    for rid in want:
        np.testing.assert_array_equal(got[rid], np.asarray(want[rid]))
    assert tobs.derive_counts(eng) == jobs.derive_counts(jeng)
    audit = tobs.audit_engine(eng, spans=rec.spans)
    jaudit = jobs.audit_engine(jeng, spans=jrec.spans)
    assert audit["ok"], audit["mismatches"]
    assert audit["derived"] == jaudit["derived"]
    # spans: the step metrics (not the wall ones) are the reference's
    for rid in want:
        m, jm_ = rec.spans.request_metrics(rid), jrec.spans.request_metrics(
            rid)
        for k in ("final_state", "n_tokens", "preemptions", "queue_steps",
                  "ttft_steps", "lost_steps"):
            assert m[k] == jm_[k], (rid, k)
    # the registry: the reference's metric names and counter values
    assert rec.registry.names() == jrec.registry.names()
    snap, jsnap = rec.registry.snapshot(), jrec.registry.snapshot()
    for name, v in jsnap.items():
        if isinstance(v, dict):
            assert snap[name]["count"] == v["count"], name
        elif not name.endswith(TIMED):
            assert snap[name] == v, name
    names = lambda text: sorted({line.split()[0].split("{")[0]
                                 for line in text.splitlines()})
    assert names(rec.registry.render_prometheus()) == \
        names(jrec.registry.render_prometheus())
    # the trace: the same slice counts per name, the same instants
    count = lambda doc, ph: sorted(
        (e["name"], e.get("args", {}).get("step")) for e in
        doc["traceEvents"] if e["ph"] == ph)
    doc, jdoc = rec.trace.to_json(), jrec.trace.to_json()
    tobs.validate_trace(doc)
    assert count(doc, "X") == count(jdoc, "X")
    assert count(doc, "i") == count(jdoc, "i")


def test_recorder_does_not_change_tokens(pair):
    tm = pair[2]
    wl = make_workload(tm.cfg.vocab_size, seed=3)
    out = []
    for rec in (None, tobs.Recorder()):
        eng = ContinuousEngine(tm, page_size=4, max_slots=3,
                               max_request_len=40, prefill_chunk=6,
                               recorder=rec)
        for r in wl:
            eng.submit(r["prompt"], r["max_new_tokens"])
        out.append(eng.drain())
    for rid in out[0]:
        np.testing.assert_array_equal(out[0][rid], out[1][rid])
    slices = {e["name"] for e in rec.trace.to_json()["traceEvents"]
              if e["ph"] == "X"}
    assert {"step", "decode", "prefill_chunk"} <= slices
    # static engine too
    for rec in (None, tobs.Recorder()):
        eng = StaticEngine(tm, batch=2, recorder=rec)
        for r in wl[:3]:
            eng.submit(r["prompt"], r["max_new_tokens"])
        got = eng.drain()
        for rid in got:
            np.testing.assert_array_equal(got[rid], out[0][rid])


@pytest.mark.parametrize("chunk", [0, 6])
def test_preemption_audit_matches_reference(pair, chunk):
    wl = make_workload(pair[2].cfg.vocab_size)
    j, t = run_both(pair, wl, reserve="prompt", n_blocks=11,
                    prefill_chunk=chunk)
    assert t[0].stats["preemptions"] >= 2
    assert_obs_match(j, t)
    agg = t[1].spans.aggregate()
    assert agg["preemptions"] == t[0].stats["preemptions"]
    assert agg["tokens"] == sum(g for _, g in SHAPES)


def test_fault_soak_audit_matches_reference(pair):
    wl = make_workload(pair[2].cfg.vocab_size, seed=2)
    kw = dict(horizon=24, n_events=4, max_drop=3)
    j, t = run_both(pair, wl, jfaults=JFaultSchedule.random(1, **kw),
                    faults=FaultSchedule.random(1, **kw), reserve="prompt",
                    n_blocks=13, preempt_backoff=0)
    assert t[0].stats["fault_events"] > 0
    assert_obs_match(j, t)


def test_prefix_audit_matches_reference(pair):
    rng = np.random.default_rng(0)
    V = pair[2].cfg.vocab_size
    base = rng.integers(1, V, 16).astype(np.int32)
    cold = rng.integers(1, V, 10).astype(np.int32)
    wl = [{"rid": 0, "prompt": base.copy(), "max_new_tokens": 4},
          {"rid": 1, "prompt": base.copy(), "max_new_tokens": 4},
          {"rid": 2, "prompt": base[:8].copy(), "max_new_tokens": 4},
          {"rid": 3, "prompt": cold, "max_new_tokens": 4}]
    j, t = run_both(pair, wl, max_slots=1, max_request_len=32,
                    prefix_cache=True)
    assert t[0].stats["prefix_hits"] > 0
    assert_obs_match(j, t)
    eng, rec = t[0], t[1]
    per_req = [rec.spans.request_metrics(r["rid"]).get("prefix_hit_tokens",
                                                        0) for r in wl]
    assert sum(per_req) == eng.stats["prefix_hit_tokens"]
    assert per_req[1] > 0 and per_req[3] == 0


def test_snapshot_restore_resyncs_a_new_registry(pair, tmp_path):
    from repro_torch.serve import restore_engine, run_sequential, save_engine

    tm = pair[2]
    wl = make_workload(tm.cfg.vocab_size, seed=6,
                       shapes=[(6, 5), (10, 4), (4, 6)])
    rec = tobs.Recorder()
    eng = ContinuousEngine(tm, page_size=4, max_slots=2, max_request_len=24,
                           recorder=rec)
    for r in wl:
        eng.submit(r["prompt"], r["max_new_tokens"])
    for _ in range(3):
        eng.step()
    path = str(tmp_path / "snap.npz")
    meta = save_engine(eng, path)
    assert meta["stats"]["prompt_tokens"] == eng.stats["prompt_tokens"]
    assert any(e.get("name") == "snapshot"
               for e in rec.trace.to_json()["traceEvents"])
    rec2 = tobs.Recorder()
    eng2 = restore_engine(path, tm, recorder=rec2)
    assert dict(eng2.stats) == dict(eng.stats)
    assert rec2.registry.snapshot()["serve_prompt_tokens"] == \
        eng.stats["prompt_tokens"]
    out = eng2.drain()
    ref = run_sequential(tm, wl, cache_len=eng2.gather_tokens)
    for r in wl:
        np.testing.assert_array_equal(out[r["rid"]], ref[r["rid"]])
    assert tobs.audit_engine(eng2)["ok"]


# -- the serve driver ---------------------------------------------------------------


def _run(module, *args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable, "-m", module, *args], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=300)


def test_serve_driver_new_flags_and_trace_cli(tmp_path):
    trace, prom, js = (str(tmp_path / n) for n in ("t.json", "p.txt",
                                                    "r.json"))
    p = _run("repro_torch.launch.serve", "--reduced", "--device", "cpu",
             "--mixed", "--requests", "6", "--page-size", "4", "--batch",
             "3", "--prefill-chunk", "4", "--reserve", "prompt",
             "--fault-seed", "0", "--arrival-rate", "0.5",
             "--deadline-steps", "400", "--max-retries", "8",
             "--max-idle-steps", "500", "--trace", trace, "--prom", prom,
             "--json", js)
    assert p.returncode == 0, p.stdout + p.stderr
    assert "chunked prefill:" in p.stdout and "fault schedule" in p.stdout
    payload = json.load(open(js))
    assert payload["schema_version"] == 1 and payload["all_terminal"]
    assert payload["fault_events"] > 0 and payload["reserve"] == "prompt"
    assert payload["metrics"]["serve_fault_events"] == payload["fault_events"]
    assert "serve_finished" in open(prom).read()
    q = _run("repro_torch.obs.trace", trace)
    assert q.returncode == 0 and "OK" in q.stdout, q.stdout + q.stderr
    s = _run("repro_torch.launch.serve", "--reduced", "--device", "cpu",
             "--engine", "static", "--requests", "4", "--batch", "2")
    assert s.returncode == 0, s.stdout + s.stderr
    assert "served 4 requests" in s.stdout
