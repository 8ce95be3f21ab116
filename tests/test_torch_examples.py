"""The port's examples (``repro_torch.examples``) and the launchers'
``--backend``, against the reference's examples and launchers.

  * ``train_sparse_lm.make_plan`` gives the reference example's plan:
    the same ``to_json()`` and ``fingerprint()`` for both profiles at 4
    and 12 layers;
  * quickstart's step functions at small sizes on the CPU, with the
    assertions its ``main`` makes;
  * one step of each other example on ``--device cpu`` at the smallest
    size its functions take (and the failure drill of
    ``train_sparse_lm``: exit code 42, then a resume);
  * ``--backend`` on both launchers: default ``auto``, the reference's
    choices; a 2-step ``--reduced --device cpu --backend xla_masked``
    training run stores masked values.
"""
import importlib.util
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import design_rbgp4 as j_design_rbgp4
from repro.launch import serve as j_serve
from repro.launch import train as j_train
from repro_torch.core import is_ramanujan
from repro_torch.data import GaussianClassImages, TokenStream
from repro_torch.examples import (cifar_vgg_rbgp4, quickstart, serve_lm,
                                  train_sparse_lm)
from repro_torch.launch import serve as t_serve
from repro_torch.launch import train as t_train
from repro_torch.sparsity import CompactWeight, available_backends

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]


def reference_example(name: str):
    spec = importlib.util.spec_from_file_location(
        f"reference_example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("profile", ["uniform", "depth"])
@pytest.mark.parametrize("n_layers", [4, 12])
def test_make_plan_equals_the_reference_examples(profile, n_layers):
    ref = reference_example("train_sparse_lm").make_plan(profile, n_layers)
    got = train_sparse_lm.make_plan(profile, n_layers)
    assert got.to_json() == ref.to_json()
    assert got.fingerprint() == ref.fingerprint()


def test_quickstart_steps_at_small_sizes():
    layout = quickstart.design(256, 256, 0.75)
    want = j_design_rbgp4(256, 256, 0.75)
    assert (layout.spec.g_o, layout.spec.g_i) == (want.g_o, want.g_i)
    rep = quickstart.theory(layout)
    assert all(rep["ramanujan"].values())
    assert rep["ramanujan"]["G_i"] == is_ramanujan(layout.graph_i)
    assert quickstart.kernel_check(layout, "cpu", n=8) < 1e-4
    errs, y_max = quickstart.backends_check("cpu", n=64, rows=4)
    assert list(errs) == available_backends(weight=CompactWeight)
    assert max(errs.values()) < 1e-3 and y_max > 0
    losses = quickstart.regression("cpu", d=64, n=128, steps=60)
    assert all(math.isfinite(v) for v in losses)
    assert losses[-1] < losses[0] / 5
    shapes = {"l0.attn.wq": (256, 256), "l0.mlp.gate": (512, 256),
              "l0.mlp.down": (256, 512)}
    cert = quickstart.plan_section("cpu", shapes=shapes, min_dim=64, n=64)
    assert cert["summary"]["all_ok"]


def test_train_sparse_lm_step_and_failure_drill(tmp_path):
    args = ["--device", "cpu", "--batch", "2", "--seq", "8",
            "--checkpoint-dir", str(tmp_path)]
    with pytest.raises(SystemExit) as e:
        train_sparse_lm.main(args + ["--steps", "3",
                                     "--simulate-failure", "1"])
    assert e.value.code == 42
    # the drill left the checkpoint of step 1 (checkpoints every steps // 2)
    losses = train_sparse_lm.main(args + ["--steps", "3"])
    assert len(losses) == 2 and all(math.isfinite(v) for v in losses)


def test_serve_lm_step():
    model = serve_lm.build("cpu")
    assert set(model.cfg.layer_pattern) == {"swa", "attn"}
    modes = {getattr(m, "mode", None) for m in model.modules()}
    assert "compact" in modes
    prompts = TokenStream(model.cfg.vocab_size, 2, 8, seed=1).batch_at(0)
    outs = serve_lm.generate(model, prompts, 3)
    assert outs.shape == (2, 3)
    assert serve_lm.teacher_forced_agreement(model, prompts, outs) > 0.99
    a = serve_lm.generate(model, prompts, 3, temperature=0.8, seed=4)
    b = serve_lm.generate(model, prompts, 3, temperature=0.8, seed=4)
    assert np.array_equal(a, b)


def test_cifar_vgg_rbgp4_step():
    teacher = cifar_vgg_rbgp4.make_model("dense", 0.0, "cpu")
    hist = cifar_vgg_rbgp4.train_one(teacher, 1, data_seed=3, batch=8)
    student = cifar_vgg_rbgp4.make_model("rbgp4", 0.75, "cpu")
    assert any(getattr(m, "mode", None) == "compact"
               for m in student.modules())
    hist += cifar_vgg_rbgp4.train_one(student, 1, data_seed=3,
                                      teacher=teacher, alpha=0.5, batch=8)
    assert all(math.isfinite(h["loss"]) for h in hist)
    test = GaussianClassImages(10, 16, seed=3).batch_at(10_000)
    assert 0.0 <= cifar_vgg_rbgp4.evaluate(student, test) <= 1.0


@pytest.mark.parametrize("port,ref", [(t_train, j_train), (t_serve, j_serve)],
                         ids=["train", "serve"])
def test_launchers_take_the_references_backend_flag(port, ref):
    got, want = port.build_parser(), ref.build_parser()
    assert got.get_default("backend") == want.get_default("backend") == \
        "auto"
    choices = lambda ap: next(a.choices for a in ap._actions  # noqa: E731
                              if a.dest == "backend")
    assert choices(got) == choices(want) == ["auto"] + available_backends()


def test_train_launcher_backend_xla_masked_stores_masked_values(tmp_path):
    t_train.main(["--reduced", "--device", "cpu", "--steps", "2",
                  "--batch", "2", "--seq", "8", "--backend", "xla_masked",
                  "--checkpoint-dir", str(tmp_path), "--log-every", "1"])
    (ckpt,) = sorted(tmp_path.glob("ckpt_*.npz"))
    names = list(np.load(ckpt).keys())
    assert "params/stack.layers.0.mixer.wq.w" in names
    assert not [n for n in names if n.endswith("w_data")]
