"""Weight-only int8 models of the port against the reference's, on the CPU.

The reference's ``qlm`` setup (``tests/test_quant.py``: reduced
tinyllama-1.1b, rbgp4 at 0.5, ``min_dim=64``), the reduced qwen2-moe-a2.7b
(rbgp4 at 0.75, experts stacked) and the reduced tinyllama under the
deep-chain plan of ``tests/test_torch_chain_model.py``: the reference's
``quantize_weights`` turns every compact and chain container into int8
leaf blocks + scales, which ``load_jax_params`` carries into a port model
quantized the same way.  Then

  * the port's float32 prefill logits are within 1e-5 * max|ref| of the
    reference model's on the quantized params (summation order only: both
    dequantize to the same float32 values);
  * the port's ``ContinuousEngine`` greedy streams equal the reference's
    ``ContinuousEngine`` streams on the quantized params, the port's
    ``run_sequential``, and the port's own streams after
    ``dequantize_weights`` (bit for bit on the CPU: dequantize and
    delegate); routed tests assert top-k router margins of at least
    ``MARGIN``;

and the launchers run end to end with ``--quant int8`` on the CPU, the
train launcher writing its ``ptq_int8/`` export.
"""
import contextlib
import copy
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import apply_sparsity as j_apply_sparsity
from repro.configs import get_config as j_get_config
from repro.configs import reduce_config as j_reduce_config
from repro.models import LMModel as JLMModel
from repro.serve import ContinuousEngine as JContinuousEngine
from repro.sparsity import QuantizedWeight as JQuantized
from repro.sparsity import quantize_weights as j_quantize_weights
from repro_torch.bridge import load_jax_params
from repro_torch.configs import apply_sparsity, get_config, reduce_config
from repro_torch.data import RequestStream
from repro_torch.models import LMModel
from repro_torch.serve import ContinuousEngine, run_sequential
from repro_torch.train import CheckpointManager
from repro_torch.sparsity import (QuantizedWeight, dequantize_weights,
                                  quantize_weights)

from test_torch_chain_model import chain_plans
from test_torch_model import jax_tree_to_numpy
from test_torch_moe import topk_margins

torch.set_num_threads(1)
RTOL = 1e-5
ROOT = Path(__file__).resolve().parents[1]
KINDS = ("tinyllama", "qwen2-moe", "chain")


def quant_tree_to_numpy(node):
    """The reference's params with ``QuantizedWeight`` containers given as
    their field dicts, the form ``load_jax_params`` takes."""
    if isinstance(node, JQuantized):
        return {"q_data": np.asarray(node.q_data),
                "scales": np.asarray(node.scales),
                "b": None if node.b is None else np.asarray(node.b)}
    if isinstance(node, dict):
        return {k: quant_tree_to_numpy(v) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [quant_tree_to_numpy(v) for v in node]
    return jax_tree_to_numpy(node)


def configs(kind):
    if kind == "chain":
        plan, jplan = chain_plans()
        return (j_apply_sparsity(j_reduce_config(
                    j_get_config("tinyllama-1.1b")), plan=jplan),
                apply_sparsity(reduce_config(get_config("tinyllama-1.1b")),
                               plan=plan))
    arch, sp = (("tinyllama-1.1b", 0.5) if kind == "tinyllama"
                else ("qwen2-moe-a2.7b", 0.75))
    return (j_apply_sparsity(j_reduce_config(j_get_config(arch)),
                             pattern="rbgp4", sparsity=sp, backend="auto",
                             min_dim=64),
            apply_sparsity(reduce_config(get_config(arch)), pattern="rbgp4",
                           sparsity=sp, min_dim=64))


@pytest.fixture(scope="module", params=KINDS)
def qpair(request):
    jcfg, cfg = configs(request.param)
    jm = JLMModel(jcfg)
    qp = j_quantize_weights(jm.init(jax.random.PRNGKey(0)))
    n_q = sum(isinstance(x, JQuantized) for x in jax.tree_util.tree_leaves(
        qp, is_leaf=lambda x: isinstance(x, JQuantized)))
    assert n_q > 0
    tm = quantize_weights(LMModel(cfg, device="cpu"))
    load_jax_params(tm, quant_tree_to_numpy(qp))
    return request.param, jm, qp, tm


def routed(kind, model):
    """Top-k margins asserted where the model routes."""
    if kind == "qwen2-moe":
        return topk_margins(model)
    return contextlib.nullcontext()


def test_quantized_storage_loads_as_int8(qpair):
    kind, _, _, tm = qpair
    state = tm.state_dict()
    q = [k for k, v in state.items() if k.endswith(".q_data")]
    assert q and all(state[k].dtype == torch.int8 for k in q)
    assert all(state[k[:-len("q_data")] + "scales"].dtype == torch.float32
               for k in q)
    assert not any(k.endswith(".w_data") for k in state)
    kinds = {m.weight().kind for m in tm.modules()
             if getattr(m, "quantized", False) and hasattr(m, "mode")}
    assert kinds == ({"chain"} if kind == "chain" else {"compact"})
    if kind == "qwen2-moe":
        assert isinstance(tm.stack.layers[0].ffn.experts.weight("gate"),
                          QuantizedWeight)


def test_quantized_logits_match_reference(qpair):
    kind, jm, qp, tm = qpair
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, tm.cfg.vocab_size, (2, 9)).astype(np.int32)
    want, _ = jm.prefill(qp, {"tokens": jnp.asarray(tokens)},
                         jm.init_cache(2, 16, jnp.float32))
    with torch.no_grad(), routed(kind, tm):
        got, _ = tm.prefill(tokens, tm.init_cache(2, 16, torch.float32))
    want = np.asarray(want, np.float64)
    err = np.abs(got.numpy().astype(np.float64) - want).max()
    assert err <= RTOL * np.abs(want).max(), (kind, err)


def test_quantized_streams_match_reference_and_dequantized(qpair):
    kind, jm, qp, tm = qpair
    reqs = RequestStream(tm.cfg.vocab_size, 4, prompt_lens=(4, 12, 8, 16),
                         gen_lens=(3, 6, 2, 4), seed=0).requests()
    jeng = JContinuousEngine(jm, qp, page_size=4, max_slots=3,
                             max_request_len=40)
    for r in reqs:
        jeng.submit(r["prompt"], r["max_new_tokens"])
    want = jeng.drain()

    def drain(model):
        eng = ContinuousEngine(model, page_size=4, max_slots=3,
                               max_request_len=40)
        for r in reqs:
            eng.submit(r["prompt"], r["max_new_tokens"])
        with routed(kind, model):
            out = eng.drain()
            seq = run_sequential(model, reqs, cache_len=eng.gather_tokens)
        return out, seq

    got, seq = drain(tm)
    deq, _ = drain(dequantize_weights(copy.deepcopy(tm)))
    assert set(got) == set(want) == {r["rid"] for r in reqs}
    for r in reqs:
        rid = r["rid"]
        assert len(got[rid]) == r["max_new_tokens"]
        np.testing.assert_array_equal(got[rid], np.asarray(want[rid]),
                                      err_msg=f"{kind} request {rid}")
        np.testing.assert_array_equal(got[rid], seq[rid])
        np.testing.assert_array_equal(got[rid], deq[rid])


def _run(module, *args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    return subprocess.run(
        [sys.executable, "-m", f"repro_torch.launch.{module}", "--reduced",
         "--device", "cpu", "--quant", "int8", *args], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=600)


def test_serve_launcher_quant_int8_on_cpu():
    cfg = apply_sparsity(reduce_config(get_config("tinyllama-1.1b")),
                         pattern="rbgp4", sparsity=0.75, min_dim=64)
    qfp = cfg.sparsity_rules.with_quant("int8").fingerprint()
    p = _run("serve", "--requests", "3", "--batch", "2", "--prompt-len",
             "6", "--gen", "3", "--page-size", "4")
    assert p.returncode == 0, p.stdout + p.stderr
    assert "weight-only PTQ" in p.stdout and f"plan={qfp}" in p.stdout
    assert "served 3 requests" in p.stdout


def test_train_launcher_quant_int8_writes_ptq_export(tmp_path):
    ck = tmp_path / "ck"
    p = _run("train", "--steps", "2", "--batch", "2", "--seq", "8",
             "--checkpoint-dir", str(ck))
    assert p.returncode == 0, p.stdout + p.stderr
    cfg = apply_sparsity(reduce_config(get_config("tinyllama-1.1b")),
                         pattern="rbgp4", sparsity=0.75, min_dim=64)
    qplan = cfg.sparsity_rules.with_quant("int8")
    snaps = sorted((ck / "ptq_int8").glob("ckpt_*.npz"))
    assert len(snaps) == 1, p.stdout
    assert f"plan {qplan.fingerprint()}" in p.stdout
    model = quantize_weights(LMModel(cfg, device="cpu"))
    like = dict(model.state_dict())
    flat, meta = CheckpointManager(
        str(ck / "ptq_int8"),
        plan_fingerprint=qplan.fingerprint()).restore(like)
    assert meta["plan_fingerprint"] == qplan.fingerprint()
    q = [k for k in flat if k.endswith(".q_data")]
    assert q and all(flat[k].dtype == np.int8 for k in q)
    assert all(flat[k].dtype == np.float32 for k in flat
               if k.endswith(".scales"))
    with pytest.raises(RuntimeError, match="plan"):
        CheckpointManager(
            str(ck / "ptq_int8"),
            plan_fingerprint=cfg.sparsity_rules.fingerprint()).restore(like)
