"""The port's training leftovers against the reference, on the CPU:
error-feedback int8 gradient compression and reading the reference's own
snapshots.

``compress_decompress`` (with and without error feedback) equals the
reference's bit for bit in float32 over seeded gradients; a reduced
tinyllama (rbgp4 at 0.75, the reference's weights through
``load_jax_params``) trained 3 steps with ``grad_compression="int8"``
gives the reference's losses within 1e-5 * max|ref loss|; a snapshot the
reference's ``Trainer`` wrote after 2 steps resumes in the port
(``Trainer.load_reference_snapshot``), whose next loss equals the
reference's next loss within the same tolerance.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import TrainConfig as JTrainConfig
from repro.train import Trainer as JTrainer
from repro.train.compress import compress_decompress as j_compress
from repro.train.compress import init_error_feedback as j_init_ef
from repro_torch.configs import TrainConfig
from repro_torch.data import TokenStream
from repro_torch.train import (Trainer, compress_decompress,
                               init_error_feedback, read_reference_snapshot)

from test_torch_model import build_pair
from test_torch_train import fresh_model

torch.set_num_threads(1)
TOL = 1e-5


@pytest.fixture(scope="module")
def pair():
    return build_pair()


def _grads(seed):
    rng = np.random.default_rng(seed)
    return {"a": (rng.standard_normal((7, 5)) * 3).astype(np.float32),
            "b": {"c": rng.standard_normal(11).astype(np.float32),
                  "d": (rng.standard_normal((3, 4, 2)) * 1e-3)
                  .astype(np.float32)}}


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}/{k}"))
        return out
    return {prefix: np.asarray(tree)}


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("feedback", [False, True])
def test_compress_decompress_is_the_reference_bit_for_bit(seed, feedback):
    g = _grads(seed)
    jg = {"a": jnp.asarray(g["a"]),
          "b": {k: jnp.asarray(v) for k, v in g["b"].items()}}
    tg = {"a": torch.tensor(g["a"]),
          "b": {k: torch.tensor(v) for k, v in g["b"].items()}}
    jerr = terr = None
    if feedback:
        jerr, terr = j_init_ef(jg), init_error_feedback(tg)
        for k, v in _leaves(terr).items():
            assert v.dtype == np.float32 and not v.any(), k
    # two rounds, so the second carries the first's residual
    for _ in range(2):
        jout, jerr2 = j_compress(jg, jerr)
        tout, terr2 = compress_decompress(tg, terr)
        want, got = _leaves(jout), _leaves(tout)
        assert set(want) == set(got)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        want_e, got_e = _leaves(jerr2), _leaves(terr2)
        for k in want_e:
            np.testing.assert_array_equal(got_e[k], want_e[k], err_msg=k)
        if feedback:
            jerr, terr = jerr2, terr2


def _batches(vocab, n, seed):
    stream = TokenStream(vocab, 4, 12, seed=seed)
    return [{"tokens": stream.batch_at(i)} for i in range(n)]


def _jloss(jm):
    def loss(params, batch):
        value, (ce, aux) = jm.loss(params, batch, train=True)
        return value, {"ce": ce, "aux": aux}
    return loss


def test_int8_compressed_training_matches_reference(pair):
    jm, jp, tm, tree = pair
    data = _batches(tm.cfg.vocab_size, 3, seed=5)
    kw = dict(optimizer="sgdm", lr=3e-2, schedule="cosine", warmup_steps=1,
              total_steps=3, grad_clip=1.0, grad_compression="int8")
    jhist = JTrainer(_jloss(jm), jp, JTrainConfig(**kw), iter(data),
                     checkpoint=False).run(3)
    tr = Trainer(fresh_model(tree, tm.cfg), TrainConfig(**kw), iter(data),
                 checkpoint=False)
    hist = tr.run(3)
    scale = max(abs(h["loss"]) for h in jhist)
    for h, jh in zip(hist, jhist):
        assert abs(h["loss"] - jh["loss"]) <= TOL * scale, (h, jh)
    # the residual is carried in the state, one float32 tensor a parameter
    assert set(tr.state.ef_error) == set(tr.state.params)
    assert any(e.abs().max() > 0 for e in tr.state.ef_error.values())


def test_int8_residual_survives_the_ports_own_checkpoint(pair, tmp_path):
    _, _, tm, tree = pair
    stream = TokenStream(tm.cfg.vocab_size, 2, 10, seed=6)
    tcfg = TrainConfig(optimizer="sgdm", lr=1e-2, schedule="constant",
                       grad_compression="int8", checkpoint_every=2,
                       checkpoint_dir=str(tmp_path))
    first = Trainer(fresh_model(tree, tm.cfg), tcfg, stream)
    first.run(2)
    second = Trainer(fresh_model(tree, tm.cfg), tcfg, stream)
    assert second.try_resume() == 2
    for name, e in first.state.ef_error.items():
        assert torch.equal(second.state.ef_error[name], e), name


@pytest.mark.parametrize("opt,lr", [("sgdm", 3e-2), ("adamw", 1e-3)])
def test_reference_snapshot_resumes_in_the_port(pair, tmp_path, opt, lr):
    jm, jp, tm, tree = pair
    data = _batches(tm.cfg.vocab_size, 3, seed=7)
    kw = dict(optimizer=opt, lr=lr, schedule="constant", grad_clip=1.0,
              checkpoint_every=100)
    jhist = JTrainer(_jloss(jm), jp, JTrainConfig(**kw), iter(data),
                     checkpoint=False).run(3)
    # the snapshot the reference's Trainer writes at the end of 2 steps
    jdir2 = tmp_path / "ref2"
    JTrainer(_jloss(jm), jp, JTrainConfig(**kw, checkpoint_dir=str(jdir2)),
             iter(data)).run(2)
    (path,) = [os.path.join(jdir2, f) for f in os.listdir(jdir2)
               if f.endswith(".npz")]
    snap, meta = read_reference_snapshot(path)
    assert meta["step"] == 2 and set(snap) == {"params", "opt_state"}
    tr = Trainer(fresh_model(tree, tm.cfg),
                 TrainConfig(**kw, checkpoint_dir=str(tmp_path / "port")),
                 iter(data[2:]), checkpoint=False)
    assert tr.load_reference_snapshot(path) == 2
    if opt == "adamw":
        assert tr.state.opt_state["t"] == 2
    hist = tr.run(1)
    scale = max(abs(h["loss"]) for h in jhist)
    assert abs(hist[0]["loss"] - jhist[2]["loss"]) <= TOL * scale, (
        hist[0]["loss"], jhist[2]["loss"])
    # the master values went into the model's tensors
    for name, p in tr.model.named_parameters():
        assert torch.equal(p.detach(), tr.state.params[name]), name


def test_reference_snapshot_under_another_plan_is_refused(pair, tmp_path):
    jm, jp, tm, tree = pair
    data = _batches(tm.cfg.vocab_size, 1, seed=8)
    from repro.train.checkpoint import CheckpointManager as JManager

    mgr = JManager(str(tmp_path / "ref"), plan_fingerprint="other-plan")
    jtr = JTrainer(_jloss(jm), jp, JTrainConfig(), iter(data),
                   checkpoint=False)
    mgr.save(1, {"params": jtr.state.params,
                 "opt_state": jtr.state.opt_state}, extra={"step": 1})
    path = mgr.path(1)
    tr = Trainer(fresh_model(tree, tm.cfg),
                 TrainConfig(checkpoint_dir=str(tmp_path / "port")),
                 iter(data), plan_fingerprint="this-plan")
    with pytest.raises(RuntimeError, match="other-plan"):
        tr.load_reference_snapshot(path)
