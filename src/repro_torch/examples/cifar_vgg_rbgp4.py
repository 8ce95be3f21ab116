"""The paper's experiment end to end: CIFAR-shaped classification with
predefined sparsity + knowledge distillation (the paper's section 6
protocol), on the port.

The port of the reference's ``examples/cifar_vgg_rbgp4.py``.  CIFAR is not
available offline, so the default trains on deterministic synthetic
class-prototype images (``data.GaussianClassImages``); ``--data-npz``
points the held-out set at a real CIFAR archive (images float32 NHWC in
[0, 1], labels int), as the reference's does.  Protocol: a dense teacher
trained first, then sparse students (unstructured and RBGP4 at
``--sparsity``) trained with KD from the teacher; SGD momentum 0.9,
weight decay 1e-4, step LR schedule.  WRN-10-1 stands in for the paper's
nets; its RBGP4 convs run on the ``rbgp4mm_rhs`` and ``rbgp4_sddmm_rhs``
kernels on the card, the unstructured student in masked storage.

Run:  PYTHONPATH=src python -m repro_torch.examples.cifar_vgg_rbgp4 \
          --steps 80 [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import TrainConfig
from repro_torch.data import GaussianClassImages
from repro_torch.models import VisionConfig, WideResNet
from repro_torch.sparsity import SparsityConfig
from repro_torch.train import Trainer, classifier_loss


def make_model(pattern: str, sparsity: float, device, depth: int = 10,
               width: int = 1) -> WideResNet:
    """WRN-depth-width under ``pattern`` (its weights drawn from seed 0)."""
    sp = (SparsityConfig() if pattern == "dense" else
          SparsityConfig(pattern=pattern, sparsity=sparsity, min_dim=32))
    return WideResNet(VisionConfig(name=f"wrn-{pattern}", sparsity=sp,
                                   depth=depth, width=width), device=device)


def train_one(model: WideResNet, steps: int, data_seed: int, teacher=None,
              alpha: float = 0.0, lr: float = 0.05,
              batch: int = 64) -> list:
    """Train ``model`` in place for ``steps`` steps (KD from ``teacher`` at
    ``alpha``); returns the metrics history."""
    tcfg = TrainConfig(optimizer="sgdm", lr=lr, momentum=0.9,
                       weight_decay=1e-4, schedule="step",
                       lr_step_epochs=(steps // 2, 3 * steps // 4),
                       lr_step_gamma=0.2)
    tr = Trainer(model, tcfg, GaussianClassImages(10, batch, seed=data_seed),
                 checkpoint=False, loss_fn=classifier_loss(teacher, alpha))
    return tr.run(steps)


@torch.no_grad()
def evaluate(model: WideResNet, batch: dict) -> float:
    """Accuracy on ``batch`` (batch-statistics forward, as the reference
    evaluates)."""
    logits = model(batch["images"], train=True)
    labels = torch.as_tensor(np.asarray(batch["labels"]),
                             device=logits.device)
    return float((logits.argmax(-1) == labels).float().mean())


def main(argv=None) -> dict:
    """Run the protocol; returns {pattern: held-out accuracy}."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=80)
    ap.add_argument("--sparsity", type=float, default=0.75)
    ap.add_argument("--kd-alpha", type=float, default=0.5)
    ap.add_argument("--data-npz", default=None,
                    help="optional real CIFAR npz {images, labels}")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)

    # held-out: the same class prototypes (same seed), unseen noise draws
    test = GaussianClassImages(10, 512, seed=3).batch_at(10_000)
    if args.data_npz:
        d = np.load(args.data_npz)
        test = {"images": d["images"][-512:], "labels": d["labels"][-512:]}
        print("using real data from", args.data_npz)

    print(f"1) dense teacher ({args.steps} steps, SGD-m 0.9, wd 1e-4, step "
          f"schedule: the paper's recipe)")
    teacher = make_model("dense", 0.0, args.device)
    train_one(teacher, args.steps, data_seed=3)
    results = {"dense": evaluate(teacher, test)}
    print(f"   dense: test acc {results['dense']:.3f}")

    for pattern in ("unstructured", "rbgp4"):
        print(f"2) {pattern} student @ {args.sparsity:.0%} with KD "
              f"(alpha={args.kd_alpha})")
        model = make_model(pattern, args.sparsity, args.device)
        train_one(model, args.steps, data_seed=3, teacher=teacher,
                  alpha=args.kd_alpha)
        results[pattern] = evaluate(model, test)
        print(f"   {pattern}: test acc {results[pattern]:.3f}")

    print("\nsummary (paper claim: rbgp4 ~ unstructured accuracy at equal "
          "sparsity, with structured-runtime wins):")
    for k, v in results.items():
        print(f"  {k:>13}: {v:.3f}")
    gap = abs(results["rbgp4"] - results["unstructured"])
    print(f"  |rbgp4 - unstructured| = {gap:.3f}")
    return results


if __name__ == "__main__":
    main()
