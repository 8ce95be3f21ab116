"""The port's training path against the reference's, on the CPU.

Reduced tinyllama with rbgp4 at 0.75 (``min_dim=64``: wq/wo/gate/up/down
compact, wk/wv dense), float32, the JAX ``LMModel.init(PRNGKey(0))``
weights loaded through ``load_jax_params``.  The loss and every leaf of its
gradient, and three ``Trainer`` steps with sgdm and with adamw, are held
against the reference; then the port's own train-loop contracts
(microbatches, remat, checkpoint resume, the launcher's failure drill).

Tolerances: 1e-4 * max|ref| for gradients and parameters, 1e-4 relative
for losses (float32; summation order across a dozen products).
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
from repro.train import Trainer as JTrainer
from repro.train import clip_by_global_norm as j_clip
from repro.train import make_schedule as j_make_schedule
from repro_torch.bridge import flatten_jax_tree, load_jax_params
from repro_torch.configs import TrainConfig
from repro_torch.data import TokenStream
from repro_torch.kernels import rbgp4_sddmm_rhs, rbgp4mm_rhs
from repro_torch.launch import train as launch_train
from repro_torch.models import LMModel
from repro_torch.train import (Trainer, clip_by_global_norm, init_train_state,
                               make_schedule, make_train_step)

from test_torch_model import build_pair, jax_tree_to_numpy

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
RTOL = 1e-4


@pytest.fixture(scope="module")
def pair():
    return build_pair()


def batches(vocab, n, batch=4, seq=12, seed=0):
    stream = TokenStream(vocab, batch, seq, seed=seed)
    return [{"tokens": stream.batch_at(i)} for i in range(n)]


def fresh_model(tree, cfg, **kw):
    model = LMModel(cfg.with_(**kw) if kw else cfg, device="cpu")
    load_jax_params(model, tree)
    return model


def assert_close(got, want, rtol=RTOL, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = float(np.abs(got - want).max())
    scale = float(np.abs(want).max())
    assert err <= rtol * scale, (what, err, scale)


def port_grads(model, batch, train=True) -> tuple[float, dict]:
    for p in model.parameters():
        p.requires_grad_(True)
        p.grad = None
    loss, _ = model.loss(batch, train=train)
    loss.backward()
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    for p in model.parameters():
        p.requires_grad_(False)
        p.grad = None
    return loss.item(), grads


def test_loss_and_every_gradient_match_reference(pair):
    jm, jp, tm, tree = pair
    batch = batches(tm.cfg.vocab_size, 1)[0]
    jbatch = {"tokens": jnp.asarray(batch["tokens"])}
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jm.loss(p, jbatch, train=True), has_aux=True))(jp)
    model = fresh_model(tree, tm.cfg)
    loss, grads = port_grads(model, batch)
    assert abs(loss - float(jloss)) <= RTOL * abs(float(jloss))
    want = flatten_jax_tree(tm.cfg, jax_tree_to_numpy(jgrads))
    assert set(want) == set(grads)
    for name, g in grads.items():
        assert_close(g.numpy(), want[name], what=name)


def test_gradients_are_the_same_with_and_without_remat(pair):
    _, _, tm, tree = pair
    batch = batches(tm.cfg.vocab_size, 1, seed=1)[0]
    loss_r, g_r = port_grads(fresh_model(tree, tm.cfg), batch)
    loss_p, g_p = port_grads(fresh_model(tree, tm.cfg, remat=False), batch)
    loss_e, g_e = port_grads(fresh_model(tree, tm.cfg), batch, train=False)
    assert loss_r == loss_p == loss_e
    for name in g_r:
        assert torch.equal(g_r[name], g_p[name]), name
        assert torch.equal(g_r[name], g_e[name]), name


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
    hist = tr.run(3)
    for h, jh in zip(hist, jhist):
        for key in ("loss", "grad_norm", "lr"):
            assert abs(h[key] - jh[key]) <= RTOL * abs(jh[key]), (key, h, jh)
    want = flatten_jax_tree(tm.cfg, jax_tree_to_numpy(jtr.state.params))
    assert set(want) == set(tr.state.params)
    for name, p in tr.state.params.items():
        assert p.dtype == torch.float32
        assert_close(p.numpy(), want[name], what=name)
    # the model's tensors hold the updated values
    for name, p in tr.model.named_parameters():
        assert torch.equal(p.detach(), tr.state.params[name])


def test_schedules_and_clipping_match_reference():
    for kw in (dict(schedule="cosine", lr=0.3, warmup_steps=10,
                    total_steps=100),
               dict(schedule="cosine", lr=0.1, warmup_steps=0,
                    total_steps=7),
               dict(schedule="step", lr=1.0, lr_step_epochs=(5, 10),
                    lr_step_gamma=0.1),
               dict(schedule="constant", lr=0.05)):
        ours = make_schedule(TrainConfig(**kw))
        ref = j_make_schedule(JTrainConfig(**kw))
        for step in (0, 1, 5, 9, 10, 11, 50, 99, 100, 150):
            assert ours(step) == float(ref(jnp.int32(step))), (kw, step)
    rng = np.random.default_rng(0)
    for max_norm in (0.5, 1e3):
        tree = {"a": rng.standard_normal((3, 4)).astype(np.float32),
                "b": rng.standard_normal(5).astype(np.float32)}
        want, want_norm = j_clip({k: jnp.asarray(v) for k, v in tree.items()},
                                 max_norm)
        got, norm = clip_by_global_norm(
            {k: torch.tensor(v) for k, v in tree.items()}, max_norm)
        assert abs(float(norm) - float(want_norm)) <= 1e-6 * float(want_norm)
        for k in tree:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       rtol=1e-6)


def test_microbatch_accumulation_matches_full_batch(pair):
    _, _, tm, tree = pair
    batch = batches(tm.cfg.vocab_size, 1, batch=8)[0]
    tokens = torch.as_tensor(batch["tokens"])
    params = {}
    for n_micro in (1, 4):
        tcfg = TrainConfig(optimizer="sgdm", lr=0.1, schedule="constant",
                           grad_clip=0.0, microbatches=n_micro)
        model = fresh_model(tree, tm.cfg)
        state = init_train_state(model, tcfg)
        step = make_train_step(model, tcfg)
        mb = tokens if n_micro == 1 else tokens.reshape(4, 2, -1)
        state, _ = step(state, {"tokens": mb})
        params[n_micro] = state.params
    for name, p in params[1].items():
        np.testing.assert_allclose(params[4][name].numpy(), p.numpy(),
                                   rtol=2e-3, atol=2e-4, err_msg=name)


def test_save_then_resume_continues_identically(pair, tmp_path):
    _, _, tm, tree = pair
    stream = TokenStream(tm.cfg.vocab_size, 2, 10, seed=4)
    tcfg = TrainConfig(optimizer="adamw", lr=1e-3, schedule="constant",
                       checkpoint_dir=str(tmp_path), checkpoint_every=2)
    straight = Trainer(fresh_model(tree, tm.cfg), tcfg, stream,
                       checkpoint=False)
    straight.run(5)
    first = Trainer(fresh_model(tree, tm.cfg), tcfg, stream)
    with pytest.raises(RuntimeError, match="simulated node failure"):
        first.run(5, fail_at_step=3)
    assert first.ckpt.latest_step() == 2
    # a new process: fresh model, resume from step 2, the data from there on
    second = Trainer(fresh_model(tree, tm.cfg), tcfg,
                     ({"tokens": stream.batch_at(i)} for i in range(2, 5)))
    assert second.try_resume() == 2
    second.run(3)
    assert second.state.step == 5
    assert second.state.opt_state["t"] == 5
    for name, p in straight.state.params.items():
        assert torch.equal(second.state.params[name], p), name
    for name, p in second.model.named_parameters():
        assert torch.equal(p.detach(), second.state.params[name]), name


def _run_launcher(*args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", *args],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)


def test_train_launcher_failure_drill_then_resume(tmp_path):
    args = ("--reduced", "--device", "cpu", "--steps", "6", "--batch", "2",
            "--seq", "16", "--checkpoint-every", "2", "--log-every", "1",
            "--checkpoint-dir", str(tmp_path))
    p = _run_launcher(*args, "--simulate-failure", "3")
    assert p.returncode == 42, p.stdout + p.stderr
    assert "FAILURE DRILL" in p.stdout
    p = _run_launcher(*args)
    assert p.returncode == 0, p.stdout + p.stderr
    assert "auto-resumed from checkpoint at step 2" in p.stdout
    assert "done: steps=6" in p.stdout


def test_train_launcher_without_cuda_names_the_flag():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device works")
    with pytest.raises(RuntimeError, match="--device cpu"):
        launch_train.main(["--reduced", "--steps", "1"])


def test_launch_counters_stay_zero_on_cpu_tensors(pair):
    _, _, tm, tree = pair
    rbgp4mm_rhs.launches = rbgp4mm_rhs.launches_dx = 0
    rbgp4_sddmm_rhs.launches = 0
    tr = Trainer(fresh_model(tree, tm.cfg), TrainConfig(lr=1e-2),
                 iter(batches(tm.cfg.vocab_size, 2)), checkpoint=False)
    tr.run(2)
    assert (rbgp4mm_rhs.launches, rbgp4mm_rhs.launches_dx,
            rbgp4_sddmm_rhs.launches) == (0, 0, 0)
