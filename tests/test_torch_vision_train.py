"""Training the port's vision models against the reference, on the CPU.

  * ``GaussianClassImages`` gives the reference's batches, bit for bit;
  * ``kd_loss`` and ``distillation_loss`` equal the reference's within
    1e-6 * max|ref| (float32), at alpha 0 and 0.5, on float32 and bfloat16
    logits;
  * three steps of ``examples/cifar_vgg_rbgp4.py``'s protocol on WRN-10-1
    at batch 8 (``min_dim=32``): a dense teacher, then an unstructured
    (masked) and an RBGP4 (compact, ``auto``) student at 0.75 with KD
    alpha 0.5; SGD momentum 0.9, weight decay 1e-4, the step schedule.
    The port's ``Trainer(loss_fn=classifier_loss(...))`` against the
    reference's ``Trainer`` from the same weights (loaded through
    ``load_jax_vision_params``): every step's loss within 1e-4 relative,
    and the held-out accuracy of each model equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import TrainConfig as JTrainConfig
from repro.data import GaussianClassImages as JImages
from repro.models.vision import VisionConfig as JVisionConfig
from repro.models.vision import WideResNet as JWideResNet
from repro.sparsity import SparsityConfig as JSparsityConfig
from repro.train import Trainer as JTrainer
from repro.train import distillation_loss as j_distillation_loss
from repro.train import kd_loss as j_kd_loss
from repro_torch.bridge import load_jax_vision_params
from repro_torch.configs import TrainConfig
from repro_torch.data import GaussianClassImages
from repro_torch.models.vision import VisionConfig, WideResNet
from repro_torch.sparsity import SparseLinear, SparsityConfig
from repro_torch.train import (Trainer, classifier_loss, distillation_loss,
                               kd_loss)

from test_torch_model import jax_tree_to_numpy

torch.set_num_threads(2)
STEPS, BATCH = 3, 8


def test_gaussian_class_images_are_the_references():
    for seed, batch in ((0, 4), (3, 8)):
        want, got = JImages(10, batch, seed=seed), GaussianClassImages(
            10, batch, seed=seed)
        np.testing.assert_array_equal(got.protos, want.protos)
        for step in (0, 1, 7, 10_000):
            a, b = got.batch_at(step), want.batch_at(step)
            for k in ("images", "labels"):
                assert a[k].dtype == b[k].dtype
                np.testing.assert_array_equal(a[k], b[k])
        it = iter(got)
        np.testing.assert_array_equal(next(it)["images"],
                                      want.batch_at(0)["images"])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("temperature", [1.0, 4.0])
def test_kd_and_distillation_losses_match_the_reference(dtype, temperature):
    rng = np.random.default_rng(4)
    s, t = (rng.standard_normal((16, 10)).astype(np.float32) * 3
            for _ in range(2))
    ts, tt = torch.tensor(s).to(dtype), torch.tensor(t).to(dtype)
    js, jt = (jnp.asarray(a.float().numpy()) for a in (ts, tt))
    want = float(j_kd_loss(js, jt, temperature))
    got = kd_loss(ts, tt, temperature)
    assert got.dtype == torch.float32
    assert abs(float(got) - want) <= 1e-6 * abs(want)
    hard = torch.tensor(1.7)
    for alpha in (0.0, 0.5):
        want = float(j_distillation_loss(js, jt, jnp.asarray(1.7), alpha,
                                         temperature))
        got = float(distillation_loss(ts, tt, hard, alpha, temperature))
        assert abs(got - want) <= 1e-6 * abs(want)


# -- the example's protocol ---------------------------------------------------

def configs(pattern, backend):
    if pattern == "dense":
        return JSparsityConfig(), SparsityConfig()
    kw = dict(pattern=pattern, sparsity=0.75, backend=backend, min_dim=32)
    return JSparsityConfig(**kw), SparsityConfig(**kw)


def tcfg_kw():
    return dict(optimizer="sgdm", lr=0.05, momentum=0.9, weight_decay=1e-4,
                schedule="step", lr_step_epochs=(STEPS // 2, 3 * STEPS // 4),
                lr_step_gamma=0.2)


def j_ce(logits, labels):
    ll = jax.nn.log_softmax(logits)
    return -jnp.mean(jnp.take_along_axis(ll, labels[:, None], 1))


def train_pair(pattern, backend, teacher=None, alpha=0.0):
    """(reference model, params, losses), (port model, losses): the same
    WRN-10-1 weights trained ``STEPS`` steps by each package's Trainer."""
    jsp, sp = configs(pattern, backend)
    jm = JWideResNet(JVisionConfig(name=f"wrn-{pattern}", sparsity=jsp,
                                   depth=10, width=1))
    jp = jm.init(jax.random.PRNGKey(0))
    tm = WideResNet(VisionConfig(name=f"wrn-{pattern}", sparsity=sp,
                                 depth=10, width=1), device="cpu")
    load_jax_vision_params(tm, jax_tree_to_numpy(jp))

    def jloss(p, batch):
        logits = jm.apply(p, batch["images"], train=True)
        hard = j_ce(logits, batch["labels"])
        if teacher is not None and alpha > 0:
            (jt_model, jt_params), _ = teacher
            t_logits = jt_model.apply(jt_params, batch["images"], train=True)
            return j_distillation_loss(logits, t_logits, hard, alpha), {}
        return hard, {}

    jtr = JTrainer(jloss, jp, JTrainConfig(**tcfg_kw()),
                   JImages(10, BATCH, seed=3), checkpoint=False)
    jhist = jtr.run(STEPS)
    t_teacher = teacher[1] if teacher is not None else None
    tr = Trainer(tm, TrainConfig(**tcfg_kw()),
                 GaussianClassImages(10, BATCH, seed=3), checkpoint=False,
                 loss_fn=classifier_loss(t_teacher, alpha))
    hist = tr.run(STEPS)
    return ((jm, jtr.state.full_params()), [h["loss"] for h in jhist]), \
        (tm, [h["loss"] for h in hist])


def accuracy_pair(ref, port, batch) -> tuple[float, float]:
    jm, jp = ref
    want = jm.apply(jp, jnp.asarray(batch["images"]), train=True)
    with torch.no_grad():
        got = port(torch.tensor(batch["images"]), train=True)
    labels = batch["labels"]
    return (float(np.mean(np.argmax(np.asarray(want), -1) == labels)),
            float(np.mean(got.argmax(-1).numpy() == labels)))


def test_kd_protocol_steps_match_the_reference():
    held_out = GaussianClassImages(10, 64, seed=3).batch_at(10_000)
    (t_ref, t_want), (t_port, t_got) = train_pair("dense", "auto")
    teacher = (t_ref, t_port)
    runs = {"dense": ((t_ref, t_want), (t_port, t_got))}
    for pattern, backend in (("unstructured", "auto"), ("rbgp4", "auto")):
        runs[pattern] = train_pair(pattern, backend, teacher, alpha=0.5)
    for name, ((ref, want), (port, got)) in runs.items():
        modes = {m.mode for m in port.modules()
                 if isinstance(m, SparseLinear)}
        assert modes == {"dense": {"dense"}, "unstructured": {"dense",
                                                              "masked"},
                         "rbgp4": {"dense", "compact"}}[name]
        assert len(got) == STEPS and all(np.isfinite(got))
        for a, b in zip(got, want):
            assert abs(a - b) <= 1e-4 * abs(b), (name, got, want)
        acc_ref, acc_port = accuracy_pair(ref, port, held_out)
        assert acc_port == acc_ref, (name, acc_port, acc_ref)
