"""Plan-aware admission and the plan driver of the port, on the CPU.

  * ``ContinuousEngine(plan=...)`` admits ``plan_live_tokens`` equal to
    the reference engine's for the same model, weights and plan (none, the
    budget plan at 0.5 and at 0.25), growing with sparsity and clamped to
    the pool; under the 0.25 plan it serves the reference engine's greedy
    streams;
  * ``plan_aware_live_tokens`` with ``with_quant("int8")`` equals the
    reference's (the int8 credit through ``leaf_block_dims``), and an
    engine serving int8 values admits more than the same plan in float32;
  * ``repro_torch.launch.plan`` writes the reference driver's plan and
    report files for the same flags, and exits 1 when a proper factor
    breaks its bound; the serve driver hands its plan to the engine.

Reduced tinyllama, float32, ``device="cpu"``; the budgets are integers
and must be equal.
"""
import json
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs import apply_sparsity as j_apply_sparsity
from repro.configs import get_config as j_get_config
from repro.configs import reduce_config as j_reduce_config
from repro.models import LMModel as JLMModel
from repro.serve import ContinuousEngine as JContinuousEngine
from repro.serve import plan_aware_live_tokens as j_plan_aware_live_tokens
from repro.sparsity import model_matmul_shapes as j_shapes
from repro.sparsity import solve_budget as j_solve_budget
from repro_torch.bridge import load_jax_params
from repro_torch.configs import apply_sparsity, get_config, reduce_config
from repro_torch.data import RequestStream
from repro_torch.models import LMModel
from repro_torch.serve import ContinuousEngine, plan_aware_live_tokens
from repro_torch.sparsity import (PatternSpec, PlanRule, SparsityPlan,
                                  model_matmul_shapes, solve_budget)
from repro_torch.sparsity import plan as plan_mod

from test_torch_model import jax_tree_to_numpy

torch.set_num_threads(1)

ENGINE = dict(page_size=4, max_slots=2, max_live_tokens=24,
              max_request_len=24)


@pytest.fixture(scope="module")
def tables():
    return (j_shapes(j_reduce_config(j_get_config("tinyllama-1.1b"))),
            model_matmul_shapes(reduce_config(get_config("tinyllama-1.1b"))))


@pytest.fixture(scope="module")
def plans(tables):
    """{name: (reference plan, port plan)} of the budget plans."""
    shapes_j, shapes_t = tables
    return {
        f"density-{t}": (j_solve_budget(shapes_j, target_density=t,
                                        min_dim=64),
                         solve_budget(shapes_t, target_density=t,
                                      min_dim=64))
        for t in (0.5, 0.25)}


def _models(plan_j, plan_t):
    """The reduced tinyllama under a plan in both packages, the port
    holding the reference's weights."""
    jcfg = j_reduce_config(j_get_config("tinyllama-1.1b"))
    if plan_j is not None:
        jcfg = j_apply_sparsity(jcfg, plan=plan_j)
    jm = JLMModel(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    cfg = reduce_config(get_config("tinyllama-1.1b"))
    if plan_t is not None:
        cfg = apply_sparsity(cfg, plan=plan_t)
    tm = LMModel(cfg, device="cpu")
    load_jax_params(tm, jax_tree_to_numpy(jp))
    return jm, jp, tm


@pytest.fixture(scope="module")
def quarter_models(plans):
    return _models(*plans["density-0.25"])


@pytest.mark.parametrize("name", ["none", "density-0.5", "density-0.25"])
def test_plan_live_tokens_equal_the_reference_engine(name, plans,
                                                     quarter_models):
    jm, jp, tm = quarter_models
    plan_j, plan_t = plans.get(name, (None, None))
    want = JContinuousEngine(jm, jp, plan=plan_j, **ENGINE)
    got = ContinuousEngine(tm, plan=plan_t, **ENGINE)
    assert got.kv_bytes_per_token() == want.kv_bytes_per_token()
    assert got.plan_live_tokens == want.plan_live_tokens
    assert got.base_live_tokens == want.base_live_tokens == 24
    assert got.plan_fingerprint == want.plan_fingerprint
    assert got.scheduler.max_live_tokens == want.scheduler.max_live_tokens
    assert got.scheduler.max_live_tokens <= \
        got.kv.allocator.n_total * got.page


def test_plan_live_tokens_grow_with_sparsity_and_the_pool_caps_them(
        plans, tables, quarter_models):
    _, _, tm = quarter_models
    shapes = tables[1]
    eng = {name: ContinuousEngine(tm, plan=plans[name][1] if name != "none"
                                  else None, **ENGINE)
           for name in ("none", "density-0.5", "density-0.25")}
    live = [eng[n].plan_live_tokens for n in ("none", "density-0.5",
                                              "density-0.25")]
    assert live[0] == 24 < live[1] < live[2]
    half = eng["density-0.5"]
    assert half.plan_live_tokens == plan_aware_live_tokens(
        24, plan=plans["density-0.5"][1], shapes=shapes,
        kv_bytes_per_token=half.kv_bytes_per_token(), value_bytes=4)
    cap = half.kv.allocator.n_total * half.page
    assert half.plan_live_tokens > cap
    assert half.scheduler.max_live_tokens == cap
    # no budget: no credit, the pool alone bounds admission
    free = ContinuousEngine(tm, plan=plans["density-0.5"][1],
                            **dict(ENGINE, max_live_tokens=0))
    assert free.plan_live_tokens == 0
    assert free.scheduler.max_live_tokens == cap


def test_plan_served_streams_equal_the_reference_engine(plans,
                                                        quarter_models):
    """Under the 0.25 budget plan (mixed 0.75 / 0.875 layers, wk/wv
    dense) and its grown budget, the greedy streams of the two engines."""
    jm, jp, tm = quarter_models
    plan_j, plan_t = plans["density-0.25"]
    reqs = RequestStream(tm.cfg.vocab_size, 5, prompt_lens=(4, 8, 12),
                         gen_lens=(2, 4, 6), seed=2).requests()
    engines = (JContinuousEngine(jm, jp, plan=plan_j, **ENGINE),
               ContinuousEngine(tm, plan=plan_t, **ENGINE))
    outs = []
    for eng in engines:
        for r in reqs:
            eng.submit(r["prompt"], r["max_new_tokens"])
        outs.append(eng.drain())
    want, got = outs
    assert set(got) == set(want) == {r["rid"] for r in reqs}
    for rid in want:
        np.testing.assert_array_equal(got[rid], np.asarray(want[rid]),
                                      err_msg=f"request {rid}")


def test_int8_credit_equals_the_reference(plans, tables):
    """``tests/test_quant.py:359`` on both packages: the int8 plan frees
    more than the float32 one, monotone in the base, dense plans free
    nothing, and every budget equals the reference's."""
    shapes_j, shapes_t = tables
    plan_j, plan_t = plans["density-0.25"]
    kw = dict(kv_bytes_per_token=1024.0, value_bytes=4)
    for base, pj, pt in ((64, plan_j, plan_t),
                         (64, plan_j.with_quant("int8"),
                          plan_t.with_quant("int8")),
                         (128, plan_j.with_quant("int8"),
                          plan_t.with_quant("int8"))):
        assert plan_aware_live_tokens(base, plan=pt, shapes=shapes_t,
                                      **kw) == \
            j_plan_aware_live_tokens(base, plan=pj, shapes=shapes_j, **kw)
    f32 = plan_aware_live_tokens(64, plan=plan_t, shapes=shapes_t, **kw)
    q = plan_aware_live_tokens(64, plan=plan_t.with_quant("int8"),
                               shapes=shapes_t, **kw)
    assert 64 < f32 < q
    dense = SparsityPlan(rules=(PlanRule(".*", PatternSpec(pattern="dense")),))
    assert plan_aware_live_tokens(64, plan=dense, shapes=shapes_t, **kw) == 64


def test_int8_engine_admits_more(plans, quarter_models):
    _, _, tm = quarter_models
    plan = plans["density-0.5"][1]

    def live(p):
        return ContinuousEngine(tm, plan=p, **ENGINE).plan_live_tokens

    assert live(plan.with_quant("int8")) > live(plan) > 24


# ---------------------------------------------------------------------------
# the drivers
# ---------------------------------------------------------------------------

FLAGS = ["--arch", "tinyllama-1.1b", "--reduced", "--target-density",
         "0.25", "--min-dim", "64"]


@pytest.mark.parametrize("extra", [[], ["--group", "role"],
                                   ["--target-density", "0", "--target-flops",
                                    "0.5", "--pattern", "unstructured"]],
                         ids=["path", "role", "flops-unstructured"])
def test_plan_driver_writes_the_references_files(extra, tmp_path,
                                                 monkeypatch, capsys):
    from repro.launch import plan as j_driver
    from repro_torch.launch import plan as driver

    files = {}
    for who, run in (("ref", lambda argv: j_driver.main()),
                     ("port", driver.main)):
        out, rep = tmp_path / f"{who}.json", tmp_path / f"{who}-cert.json"
        argv = FLAGS + extra + ["--out", str(out), "--report", str(rep)]
        monkeypatch.setattr(sys, "argv", ["plan"] + argv)
        run(argv)
        printed = capsys.readouterr().out.replace(str(out), "OUT").replace(
            str(rep), "REPORT")
        files[who] = (out.read_text(), rep.read_text(), printed)
    assert files["port"] == files["ref"]
    assert json.loads(files["port"][1])["summary"]["all_ok"]
    # the written plan loads in the port and names the reference's digest
    plan = SparsityPlan.loads(files["port"][0])
    assert plan.fingerprint() in files["port"][2]


def test_plan_driver_exits_1_on_a_factor_over_its_bound(tmp_path,
                                                        monkeypatch, capsys):
    from repro_torch.launch import plan as driver

    monkeypatch.setattr(plan_mod, "second_singular_value", lambda g: 1e9)
    rep = tmp_path / "cert.json"
    with pytest.raises(SystemExit) as e:
        driver.main(FLAGS + ["--report", str(rep)])
    assert e.value.code == 1
    assert "violates the spectral bound" in capsys.readouterr().err
    assert not json.loads(rep.read_text())["summary"]["all_ok"]


def test_serve_driver_passes_the_plan_to_the_engine(tmp_path, monkeypatch,
                                                    capsys):
    from repro_torch.launch import plan as driver
    from repro_torch.launch import serve

    out = tmp_path / "plan.json"
    driver.main(FLAGS + ["--out", str(out)])
    seen = {}
    real = ContinuousEngine.__init__

    def spy(self, model, **kw):
        seen.update(kw)
        real(self, model, **kw)

    monkeypatch.setattr(ContinuousEngine, "__init__", spy)
    serve.main(["--reduced", "--device", "cpu", "--requests", "2",
                "--batch", "2", "--prompt-len", "8", "--gen", "4",
                "--page-size", "4", "--plan", str(out),
                "--max-live-tokens", "32"])
    printed = capsys.readouterr().out
    assert seen["plan"] == SparsityPlan.load(str(out))
    assert "plan-aware admission: max_live_tokens 32 ->" in printed
    assert "served 2 requests" in printed
