"""The port's kernel roofline table (``repro_torch.obs.kernelstats``)
against the reference's, on the CPU, and the drivers' ``--kernel-stats``,
``--autotune-cache`` and ``--plan`` scoping.

  * The autotuner hook: resolutions land as records with the model's
    estimate, a second resolution of a key is a cache hit on the same
    record, ``disable`` stops the feed (the reference's test).
  * One ``RBGP4Op.linear`` under ``enable()`` records the same (kind,
    dims signature, N, dtype) rows in both packages.
  * ``measure_op`` times each of the eight kinds (``perf_counter`` on the
    CPU) and prices it through the port's ``perf_model``.
  * The serve and train drivers print the table; the train driver's
    ``--plan`` scopes the cache entries by the plan's fingerprint.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import RBGP4Layout as JLayout
from repro.core import RBGP4Spec as JSpec
from repro.kernels import RBGP4Op as JOp
from repro.kernels import autotune as jat
from repro.obs import kernelstats as jks
from repro_torch.core import (ChainLayout, RBGP4Layout, RBGP4Spec,
                              design_rbgp)
from repro_torch.kernels import ChainOp, KernelDims, RBGP4Op, autotune
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.obs import SCHEMA_VERSION, kernelstats

torch.set_num_threads(1)
SPEC = dict(g_o=(8, 8), g_r=(8, 16), g_i=(4, 4), g_b=(1, 1), sp_o=0.75,
            sp_i=0.5, seed=1)
SMALL = dict(g_o=(4, 4), g_r=(4, 4), g_i=(4, 4), g_b=(1, 1), sp_o=0.5,
             sp_i=0.5, seed=0)


@pytest.fixture(autouse=True)
def clean(tmp_path, monkeypatch):
    monkeypatch.delenv("REPRO_AUTOTUNE_MODE", raising=False)
    autotune.set_cache_path(str(tmp_path / "port.json"))
    jat.set_cache_path(str(tmp_path / "reference.json"))
    kernelstats.reset()
    jks.reset()
    yield
    for ks in (kernelstats, jks):
        ks.disable()
        ks.reset()
    for at in (autotune, jat):
        at.set_plan_fingerprint(None)
        at.set_cache_path(None)


def test_autotune_hook_records_resolutions():
    kernelstats.enable()
    assert kernelstats.enabled()
    dims = KernelDims.from_layout(RBGP4Layout(RBGP4Spec(**SPEC)))
    autotune.autotune(dims, 4096, dtype="bfloat16", kind="rhs",
                      platform="h100-model")
    recs = kernelstats.records()
    assert len(recs) == 1
    r = recs[0]
    assert r.kind == "rhs" and r.resolutions == 1 and r.n == 4096
    assert r.model_us is not None and r.model_us > 0
    assert r.source == "model"
    autotune.autotune(dims, 4096, dtype="bfloat16", kind="rhs",
                      platform="h100-model")
    recs = kernelstats.records()
    assert len(recs) == 1 and recs[0].resolutions == 2
    assert recs[0].cache_hits == 1
    rep = kernelstats.report()
    assert rep["schema_version"] == SCHEMA_VERSION
    assert rep["n_records"] == 1 and rep["n_measured"] == 0
    kernelstats.disable()
    autotune.autotune(dims, 2048, dtype="bfloat16", kind="rhs",
                      platform="h100-model")
    assert len(kernelstats.records()) == 1


def test_one_linear_records_the_references_rows():
    jks.enable()
    kernelstats.enable()
    rng = np.random.default_rng(0)
    for n in (8, 24, 100):
        jop = JOp(JLayout(JSpec(**SPEC)), interpret=True)
        op = RBGP4Op(RBGP4Layout(RBGP4Spec(**SPEC)), device="cpu")
        w = rng.standard_normal(op.layout.data_shape).astype(np.float32)
        x = rng.standard_normal((n, op.dims.k)).astype(np.float32)
        want = jop.linear(jnp.asarray(x), jnp.asarray(w))
        got = op.linear(torch.tensor(x), torch.tensor(w))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-4, atol=1e-4)

    def rows(ks):
        return sorted((r.kind, r.dims, r.n, r.dtype) for r in ks.records())

    assert rows(kernelstats) == rows(jks)
    assert len(rows(kernelstats)) == 3
    for r in kernelstats.records():
        assert r.platform == "cpu" and r.model_us > 0


def test_the_memo_feeds_one_resolution_a_shape():
    """The hook fires once per (tables, N): a second launch at the same N
    is a memo hit and records nothing more."""
    kernelstats.enable()
    op = RBGP4Op(RBGP4Layout(RBGP4Spec(**SPEC)), device="cpu")
    w, x = op.init_data(), torch.randn(24, op.dims.k)
    op.linear(x, w)
    op.linear(x, w)
    (rec,) = kernelstats.records()
    assert rec.resolutions == 1


def chain_op():
    factors = (("ramanujan", 0, 0, 0.5),) * 2 + (("complete", 2, 2, 0.0),)
    return ChainOp(ChainLayout(design_rbgp(64, 64, 0.75, factors=factors,
                                           seed=0)), device="cpu")


@pytest.mark.parametrize("kind", kernelstats.MEASURE_KINDS)
def test_measure_op_roofline_row(kind):
    op = (chain_op() if kind.startswith("chain")
          else RBGP4Op(RBGP4Layout(RBGP4Spec(**SMALL)), device="cpu"))
    row = op.measure(n=16, reps=2, kind=kind)
    assert row["source"] == "direct"
    assert row["kind"] == ("direct_linear" if kind == "rhs"
                           else f"direct_{kind}")
    assert row["measured_us"] > 0
    assert row["model_us"] is not None and row["model_us"] > 0
    assert row["efficiency"] == pytest.approx(
        row["model_us"] / row["measured_us"])
    assert any(r["kind"] == row["kind"]
               for r in kernelstats.efficiency_table())
    if kind.endswith("_stacked"):
        one = autotune.model_us(kind, op.dims, 16, "float32", "float32",
                                row["block_n"])
        assert row["model_us"] == pytest.approx(4 * one)


def test_serve_driver_prints_the_roofline_table(tmp_path, capsys):
    cache = tmp_path / "serve.json"
    out_json = tmp_path / "run.json"
    launch_serve.main(["--reduced", "--device", "cpu", "--requests", "2",
                       "--batch", "2", "--prompt-len", "8", "--gen", "2",
                       "--page-size", "4", "--kernel-stats",
                       "--autotune-cache", str(cache),
                       "--json", str(out_json)])
    text = capsys.readouterr().out
    assert "kernel roofline (model µs / measured µs):" in text
    assert "rhs" in text.split("kernel roofline")[1]
    keys = json.loads(cache.read_text())["entries"]
    assert keys and all("|cpu|" in k for k in keys)
    report = json.loads(out_json.read_text())["kernel_stats"]
    assert report["n_records"] >= 1
    assert all(r["model_us"] > 0 for r in report["records"])


def test_train_driver_stats_compression_and_plan_scope(tmp_path, capsys):
    from repro_torch.sparsity import PatternSpec, SparsityPlan

    plan = SparsityPlan.uniform(PatternSpec(pattern="rbgp4", sparsity=0.75,
                                            backend="auto", min_dim=64))
    plan_path = tmp_path / "plan.json"
    plan.save(str(plan_path))
    cache = tmp_path / "train.json"
    launch_train.main(["--reduced", "--device", "cpu", "--steps", "2",
                       "--batch", "2", "--seq", "8", "--log-every", "1",
                       "--checkpoint-dir", str(tmp_path / "ckpt"),
                       "--plan", str(plan_path), "--grad-compression",
                       "int8", "--kernel-stats", "--autotune-cache",
                       str(cache)])
    text = capsys.readouterr().out
    assert "done: steps=2" in text
    assert "kernelstats:" in text and "kernel shapes resolved" in text
    fp = autotune.plan_fingerprint()
    assert fp is not None
    keys = json.loads(cache.read_text())["entries"]
    assert keys and all(k.startswith(f"plan{fp}|") for k in keys)
    # forward, dX (transposed) and dW each resolved
    kinds = {k.split("|")[1] for k in keys}
    assert {"rhs", "rhs.t", "sddmm"} <= kinds


def test_device_kernels_reads_a_profiler_window():
    """``device_kernels`` reads the raw records of a profiler window: a
    window of CPU operators only holds records, and no kernel on the
    card among them."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        torch.ones(8, 8) @ torch.ones(8, 8)
    assert prof.events()
    assert kernelstats.device_kernels(prof) == []
