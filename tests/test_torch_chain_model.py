"""The reduced tinyllama under a deep-chain plan computes the reference's
function, served and trained.

Widths: the reduced config (d_model 64, 4 heads of 16, one KV head,
d_ff 128, 2 layers, vocab 997) under the one-rule plan
``complete(2,2) . ramanujan^3 . complete(2,2)`` at 0.875 with
``min_dim=64``: wq, wo, gate, up and down are chains with a 4 x 4 leaf,
wk and wv (16 x 64) stay dense.  The JAX ``LMModel.init(PRNGKey(0))``
parameters load through the bridge.  Tolerance 1e-4 * max|ref| (float32,
summation order across a dozen products); greedy streams equal.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import TrainConfig as JTrainConfig
from repro.configs import apply_sparsity as j_apply_sparsity
from repro.configs import get_config as j_get_config
from repro.configs import reduce_config as j_reduce_config
from repro.models import LMModel as JLMModel
from repro.serve import ContinuousEngine as JContinuousEngine
from repro.sparsity import ChainWeight as JChain
from repro.sparsity import PatternSpec as JPatternSpec
from repro.sparsity import PlanRule as JPlanRule
from repro.sparsity import SparsityPlan as JSparsityPlan
from repro.train import Trainer as JTrainer
from repro_torch.bridge import flatten_jax_tree, load_jax_params
from repro_torch.configs import (TrainConfig, apply_sparsity, get_config,
                                 reduce_config)
from repro_torch.kernels import chain_sddmm_rhs, chainmm_rhs
from repro_torch.models import LMModel
from repro_torch.models.transformer import jax_stack_split
from repro_torch.serve import ContinuousEngine
from repro_torch.sparsity import (ChainWeight, DenseWeight, PatternSpec,
                                  PlanRule, SparsityPlan, lower_config)
from repro_torch.train import Trainer
from test_torch_model import jax_tree_to_numpy
from test_torch_serve import submit_all, workload
from test_torch_train import batches, port_grads

torch.set_num_threads(1)
RTOL = 1e-4
ROOT = Path(__file__).resolve().parents[1]

SMALL = (("complete", 2, 2, 0.0), ("ramanujan", 0, 0, -1.0),
         ("ramanujan", 0, 0, -1.0), ("ramanujan", 0, 0, -1.0),
         ("complete", 2, 2, 0.0))
SPEC = dict(pattern="rbgp", sparsity=0.875, backend="auto", factors=SMALL,
            min_dim=64)


def chain_plans(first_dense: bool = False):
    """(port plan, reference plan); ``first_dense`` puts a keep-dense rule
    for layer 0 before the chain rule."""
    out = []
    for PS, PR, SP in ((PatternSpec, PlanRule, SparsityPlan),
                       (JPatternSpec, JPlanRule, JSparsityPlan)):
        rules = (PR(".*", PS(**SPEC)),)
        if first_dense:
            rules = (PR(r"l0\..*", PS(backend="auto")),) + rules
        out.append(SP(rules=rules))
    return out


def build_chain_pair(first_dense: bool = False):
    plan, jplan = chain_plans(first_dense)
    jcfg = j_apply_sparsity(j_reduce_config(j_get_config("tinyllama-1.1b")),
                            plan=jplan)
    jm = JLMModel(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    cfg = apply_sparsity(reduce_config(get_config("tinyllama-1.1b")),
                         plan=plan)
    tm = LMModel(cfg, device="cpu")
    tree = jax_tree_to_numpy(jp)
    load_jax_params(tm, tree)
    return jm, jp, tm, tree


@pytest.fixture(scope="module")
def pair():
    return build_chain_pair()


def assert_close(got, want, rtol=RTOL, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = float(np.abs(got - want).max())
    assert err <= rtol * float(np.abs(want).max()), (what, err)


def fresh(tree, cfg):
    model = LMModel(cfg, device="cpu")
    load_jax_params(model, tree)
    return model


def test_storage_kinds_follow_the_reference(pair):
    _, jp, tm, _ = pair
    assert tm.cfg.plan.fingerprint() == chain_plans()[1].fingerprint()
    for i, layer in enumerate(tm.stack.layers):
        jl = jp["stack"]["scan"]["j0"]
        for name in ("wq", "wk", "wv", "wo"):
            mod = getattr(layer.mixer, name)
            want = (ChainWeight if isinstance(jl["mixer"][name], JChain)
                    else DenseWeight)
            assert isinstance(mod.weight(), want), (i, name)
        assert layer.mixer.wk.mode == "dense"
        for name in ("wq", "wo"):
            assert getattr(layer.mixer, name).mode == "chain"
        for name in ("gate", "up", "down"):
            mod = getattr(layer.ffn, name)
            assert mod.mode == "chain"
            assert (mod.tables.group_rows, mod.tables.chunk_cols) == (4, 4)
    n_jax = sum(int(np.prod(l.shape)) for l in jax.tree_util.tree_leaves(jp))
    assert tm.n_params() == n_jax


def test_prefill_logits_match_reference(pair):
    jm, jp, tm, _ = pair
    tokens = np.random.default_rng(0).integers(
        0, tm.cfg.vocab_size, (2, 11)).astype(np.int32)
    want, _ = jm.prefill(jp, {"tokens": jnp.asarray(tokens)},
                         jm.init_cache(2, 16, jnp.float32))
    got, _ = tm.prefill(tokens, tm.init_cache(2, 16, torch.float32))
    assert_close(got.numpy(), want)


def test_paged_decode_steps_match_reference(pair):
    jm, jp, tm, _ = pair
    jpages = jm.init_pages(9, 4, jnp.float32)
    tpages = tm.init_pages(9, 4, torch.float32)
    bt = np.array([[1, 2, -1], [3, 4, 5], [-1, -1, -1]], np.int32)
    pos = np.array([0, 5, 0], np.int32)
    rng = np.random.default_rng(1)
    decode = jax.jit(jm.decode_step_paged)
    for _ in range(4):
        toks = rng.integers(0, tm.cfg.vocab_size, (3, 1)).astype(np.int32)
        want, jpages = decode(jp, jnp.asarray(toks), jpages,
                              jnp.asarray(bt), jnp.asarray(pos))
        got, tpages = tm.decode_step_paged(toks, tpages, bt, pos)
        assert_close(got.numpy()[:2], np.asarray(want)[:2])
        pos = pos + np.array([1, 1, 0], np.int32)


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
    assert set(got) == set(want)
    for rid in want:
        np.testing.assert_array_equal(got[rid], np.asarray(want[rid]),
                                      err_msg=f"request {rid}")


def test_loss_and_every_gradient_match_reference(pair):
    jm, jp, tm, tree = pair
    batch = batches(tm.cfg.vocab_size, 1)[0]
    jbatch = {"tokens": jnp.asarray(batch["tokens"])}
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jm.loss(p, jbatch, train=True), has_aux=True))(jp)
    before = chainmm_rhs.launches, chain_sddmm_rhs.launches
    loss, grads = port_grads(fresh(tree, tm.cfg), batch)
    assert (chainmm_rhs.launches, chain_sddmm_rhs.launches) == before
    assert abs(loss - float(jloss)) <= RTOL * abs(float(jloss))
    want = flatten_jax_tree(tm.cfg, jax_tree_to_numpy(jgrads))
    assert set(want) == set(grads)
    for name, g in grads.items():
        assert_close(g.numpy(), want[name], what=name)


@pytest.mark.parametrize("opt,schedule,lr", [("sgdm", "cosine", 3e-2),
                                             ("adamw", "constant", 1e-3)])
def test_three_trainer_steps_match_reference(pair, opt, schedule, lr):
    jm, jp, tm, tree = pair
    data = batches(tm.cfg.vocab_size, 3, seed=2)
    kw = dict(optimizer=opt, lr=lr, schedule=schedule, warmup_steps=1,
              total_steps=3, grad_clip=1.0)

    def jloss(params, batch):
        loss, (ce, aux) = jm.loss(params, batch, train=True)
        return loss, {"ce": ce, "aux": aux}

    jtr = JTrainer(jloss, jp, JTrainConfig(**kw), iter(data),
                   checkpoint=False)
    jhist = jtr.run(3)
    tr = Trainer(fresh(tree, tm.cfg), TrainConfig(**kw), iter(data),
                 checkpoint=False)
    hist = tr.run(3)
    for h, jh in zip(hist, jhist):
        for key in ("loss", "grad_norm", "lr"):
            assert abs(h[key] - jh[key]) <= RTOL * abs(jh[key]), (key, h, jh)
    want = flatten_jax_tree(tm.cfg, jax_tree_to_numpy(jtr.state.params))
    for name, p in tr.state.params.items():
        assert_close(p.numpy(), want[name], what=name)


def test_a_dense_first_rule_splits_the_stack_as_the_reference():
    """Under a two-rule plan (layer 0 dense, the rest chains) the
    reference scans layer 1 alone: the bridge splits its tree the same
    way, and the logits agree."""
    jm, jp, tm, _ = build_chain_pair(first_dense=True)
    stack = jm.stack
    assert jax_stack_split(tm.cfg) == (stack.n_head, stack.period,
                                       stack.n_full, stack.tail_start)
    assert tm.stack.layers[0].mixer.wq.mode == "dense"
    assert tm.stack.layers[1].mixer.wq.mode == "chain"
    tokens = np.random.default_rng(3).integers(0, 997, (1, 9)).astype(
        np.int32)
    want, _ = jm.prefill(jp, {"tokens": jnp.asarray(tokens)},
                         jm.init_cache(1, 12, jnp.float32))
    got, _ = tm.prefill(tokens, tm.init_cache(1, 12, torch.float32))
    assert_close(got.numpy(), want)


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "qwen2-moe-a2.7b"])
def test_a_lowered_config_keeps_the_rbgp4_layouts(arch):
    """A uniform SparsityConfig and the same config lowered to a one-rule
    plan build the same layouts, tables and initial values, bit for bit
    (every projection resolves through the plan by path)."""
    cfg = apply_sparsity(reduce_config(get_config(arch)), sparsity=0.75,
                         min_dim=64)
    planned = cfg.with_(plan=lower_config(cfg.sparsity))
    assert planned.sparsity_rules.fingerprint() == \
        cfg.sparsity_rules.fingerprint()
    a, b = LMModel(cfg, device="cpu"), LMModel(planned, device="cpu")
    n_compact = 0
    for (name, ma), mb in zip(a.named_modules(), b.modules()):
        if getattr(ma, "mode", None) == "compact":
            n_compact += 1
            assert ma.layout.spec == mb.layout.spec, name
            assert torch.equal(ma.tables.col0, mb.tables.col0), name
        if getattr(ma, "compact", False):   # stacked experts
            n_compact += 1
            for side in ("in", "out"):
                assert ma.layouts[side].spec == mb.layouts[side].spec
    assert n_compact > 0
    sa, sb = a.state_dict(), b.state_dict()
    assert set(sa) == set(sb)
    for name in sa:
        assert torch.equal(sa[name], sb[name]), name


def test_checkpoint_refuses_a_restore_under_another_plan(pair, tmp_path):
    _, _, tm, tree = pair
    plan, _ = chain_plans()
    other = lower_config(reduce_config(get_config("tinyllama-1.1b")).sparsity)
    assert plan.fingerprint() != other.fingerprint()
    tcfg = TrainConfig(checkpoint_dir=str(tmp_path), checkpoint_every=1,
                       total_steps=2)
    data = batches(tm.cfg.vocab_size, 4)
    tr = Trainer(fresh(tree, tm.cfg), tcfg, iter(data),
                 plan_fingerprint=plan.fingerprint())
    tr.run(1)
    again = Trainer(fresh(tree, tm.cfg), tcfg, iter(data),
                    plan_fingerprint=other.fingerprint())
    with pytest.raises(RuntimeError, match="sparsity plan"):
        again.try_resume()
    same = Trainer(fresh(tree, tm.cfg), tcfg, iter(data),
                   plan_fingerprint=plan.fingerprint())
    assert same.try_resume() == 1
    unstamped = Trainer(fresh(tree, tm.cfg), tcfg, iter(data))
    assert unstamped.try_resume() == 1


def test_launchers_take_a_plan_and_resume_only_under_it(tmp_path):
    plan, _ = chain_plans()
    path = tmp_path / "plan.json"
    plan.save(str(path))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    ck = str(tmp_path / "ck")

    def run(module, *args):
        return subprocess.run(
            [sys.executable, "-m", f"repro_torch.launch.{module}",
             "--reduced", "--device", "cpu", *args], cwd=ROOT, env=env,
            capture_output=True, text=True, timeout=600)

    p = run("train", "--steps", "2", "--batch", "2", "--seq", "8",
            "--checkpoint-dir", ck, "--plan", str(path))
    assert p.returncode == 0, p.stdout + p.stderr
    assert f"plan={plan.fingerprint()}" in p.stdout
    p = run("train", "--steps", "3", "--batch", "2", "--seq", "8",
            "--checkpoint-dir", ck)
    assert p.returncode != 0 and "sparsity plan" in p.stderr
    p = run("serve", "--requests", "2", "--batch", "2", "--prompt-len", "6",
            "--gen", "3", "--page-size", "4", "--plan", str(path))
    assert p.returncode == 0, p.stdout + p.stderr
    assert "served 2 requests" in p.stdout
