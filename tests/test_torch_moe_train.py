"""The port's MoE training path against the reference's, on the CPU.

The reduced qwen2-moe-a2.7b (see ``test_torch_moe_model.py``), float32,
the JAX ``LMModel.init(PRNGKey(0))`` weights loaded through
``load_jax_params``: the loss (with the Switch aux loss) and every leaf of
its gradient, and three ``Trainer`` steps with sgdm and with adamw, held
against the reference.  Training routes with capacity (the reference's
``full_capacity=False`` on the cache-free forward), so the dropped
(token, k) pairs must be the reference's too.

Tolerances: 1e-4 * max|ref| for gradients and parameters, 1e-4 relative
for losses (float32; summation order), with the smallest top-k router
margin of every routed call asserted to be at least ``MARGIN`` (see
``test_torch_moe.py``).
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import TrainConfig as JTrainConfig
from repro.train import Trainer as JTrainer
from repro_torch.bridge import flatten_jax_tree, load_jax_params
from repro_torch.configs import TrainConfig
from repro_torch.kernels import rbgp4_sddmm_rhs_stacked, rbgp4mm_rhs_stacked
from repro_torch.models import LMModel
from repro_torch.train import Trainer

from test_torch_model import jax_tree_to_numpy
from test_torch_moe import RTOL, assert_close, topk_margins
from test_torch_moe_model import build_moe_pair
from test_torch_train import batches, port_grads

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def pair():
    return build_moe_pair()


def fresh_model(tree, cfg, **kw):
    model = LMModel(cfg.with_(**kw) if kw else cfg, device="cpu")
    load_jax_params(model, tree)
    return model


def test_loss_aux_and_every_gradient_match_reference(pair):
    jm, jp, tm, tree = pair
    batch = batches(tm.cfg.vocab_size, 1)[0]
    jbatch = {"tokens": jnp.asarray(batch["tokens"])}
    (jloss, (jce, jaux)), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jm.loss(p, jbatch, train=True), has_aux=True))(jp)
    model = fresh_model(tree, tm.cfg)
    with topk_margins(model):
        _, (ce, aux) = model.loss(batch)
        loss, grads = port_grads(model, batch)
    assert float(aux) > 0
    assert abs(float(aux) - float(jaux)) <= RTOL * abs(float(jaux))
    assert abs(float(ce) - float(jce)) <= RTOL * abs(float(jce))
    assert abs(loss - float(jloss)) <= RTOL * abs(float(jloss))
    want = flatten_jax_tree(tm.cfg, jax_tree_to_numpy(jgrads))
    assert set(want) == set(grads)
    for name, g in grads.items():
        assert_close(g.numpy(), want[name], what=name)
    assert float(grads["stack.layers.1.ffn.router"].abs().max()) > 0


def test_moe_gradients_are_the_same_with_and_without_remat(pair):
    _, _, tm, tree = pair
    batch = batches(tm.cfg.vocab_size, 1, seed=1)[0]
    loss_r, g_r = port_grads(fresh_model(tree, tm.cfg), batch)
    loss_p, g_p = port_grads(fresh_model(tree, tm.cfg, remat=False), batch)
    assert loss_r == loss_p
    for name in g_r:
        assert torch.equal(g_r[name], g_p[name]), name


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
    tr = Trainer(fresh_model(tree, tm.cfg), TrainConfig(**kw), iter(data),
                 checkpoint=False)
    with topk_margins(tr.model):
        hist = tr.run(3)
    for h, jh in zip(hist, jhist):
        for key in ("loss", "grad_norm", "lr", "aux"):
            assert abs(h[key] - jh[key]) <= RTOL * abs(jh[key]), (key, h, jh)
    want = flatten_jax_tree(tm.cfg, jax_tree_to_numpy(jtr.state.params))
    assert set(want) == set(tr.state.params)
    for name, p in tr.state.params.items():
        assert p.dtype == torch.float32
        assert_close(p.numpy(), want[name], what=name)


def test_stacked_launch_counters_stay_zero_on_cpu_tensors(pair):
    _, _, tm, tree = pair
    rbgp4mm_rhs_stacked.launches = rbgp4mm_rhs_stacked.launches_dx = 0
    rbgp4_sddmm_rhs_stacked.launches = 0
    tr = Trainer(fresh_model(tree, tm.cfg), TrainConfig(lr=1e-2),
                 iter(batches(tm.cfg.vocab_size, 1)), checkpoint=False)
    tr.run(1)
    assert (rbgp4mm_rhs_stacked.launches, rbgp4mm_rhs_stacked.launches_dx,
            rbgp4_sddmm_rhs_stacked.launches) == (0, 0, 0)


def test_train_and_serve_launchers_run_the_reduced_moe_model(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    run = lambda mod, *args: subprocess.run(
        [sys.executable, "-m", f"repro_torch.launch.{mod}", "--arch",
         "qwen2-moe-a2.7b", "--reduced", "--device", "cpu", *args],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    p = run("train", "--steps", "2", "--batch", "2", "--seq", "16",
            "--log-every", "1", "--checkpoint-dir", str(tmp_path))
    assert p.returncode == 0, p.stdout + p.stderr
    assert "arch=qwen2-moe-a2.7b-smoke" in p.stdout
    assert " aux " in p.stdout and "done: steps=2" in p.stdout
    p = run("serve", "--mixed", "--requests", "3", "--page-size", "4",
            "--batch", "2")
    assert p.returncode == 0, p.stdout + p.stderr
    assert "arch=qwen2-moe-a2.7b-smoke" in p.stdout
