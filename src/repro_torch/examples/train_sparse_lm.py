"""End-to-end example: train an RBGP4-sparse LM with the port's training
substrate (checkpoints, auto-resume, the failure drill).

The port of the reference's ``examples/train_sparse_lm.py``: a
TinyLlama-family decoder sparsified through the SparsityPlan API.  Two
profiles (``--profile``):

  * ``uniform``: every projection RBGP4-sparse at 75%, a one-rule plan;
  * ``depth`` (default): the shallow half of the layers at 50% with dense
    attention outputs, the deep half at 75% with attention outputs one
    pow-2 step denser (50%).

The plans name the ``xla_masked`` backend (masked storage, the
paper-faithful training path), as the reference's do, and its dense rule
is ``plan.DENSE`` (the reference's ``PatternSpec()``), so ``make_plan``
gives the reference's JSON and fingerprint.  The fingerprint is stamped
into every checkpoint: resuming a directory under the other profile is
refused.

``--size cpu`` (default) is the reduced config at 4 layers and a
vocabulary of 512; ``--size paper`` a ~110M-parameter TinyLlama
(12 x 768) for the card.  A checkpoint is written every
``min(50, steps // 2)`` steps (the reference's 50 for its default 200), so
that ``--simulate-failure`` in a short run leaves one to resume from.

Run:   PYTHONPATH=src python -m repro_torch.examples.train_sparse_lm \
           [--steps 200] [--device cpu]
Drill: add --simulate-failure 50 (exit code 42), rerun to auto-resume.
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile

from repro_torch.configs import (TrainConfig, apply_sparsity, get_config,
                                 reduce_config)
from repro_torch.data import Prefetcher, TokenStream
from repro_torch.models import LMModel
from repro_torch.sparsity import PatternSpec, PlanRule, SparsityPlan
from repro_torch.sparsity.plan import DENSE
from repro_torch.train import Trainer


def make_plan(profile: str, n_layers: int) -> SparsityPlan:
    def spec(sp):
        return PatternSpec(pattern="rbgp4", sparsity=sp,
                           backend="xla_masked", min_dim=64)

    if profile == "uniform":
        return SparsityPlan.uniform(spec(0.75), note="uniform 75%")
    # depth profile: shallow half at 50% with dense attention output
    # projections, deep half at 75% with wo one pow-2 step denser (50%)
    shallow = "|".join(f"l{i}" for i in range(n_layers // 2))
    deep = "|".join(f"l{i}" for i in range(n_layers // 2, n_layers))
    return SparsityPlan(rules=(
        PlanRule(rf"({shallow})\.attn\.wo", DENSE,
                 note="shallow wo: kept dense"),
        PlanRule(rf"({shallow})\..*", spec(0.5), note="shallow half @ 50%"),
        PlanRule(rf"({deep})\.attn\.wo", spec(0.5),
                 note="deep wo: one step denser"),
        PlanRule(rf"({deep})\..*", spec(0.75), note="deep half @ 75%"),
    ))


def config(size: str, profile: str):
    base = get_config("tinyllama-1.1b")
    if size == "cpu":
        cfg = reduce_config(base).with_(n_layers=4, vocab_size=512)
    elif size == "paper":  # ~110M, for the card
        cfg = base.with_(
            name="tinyllama-110m", n_layers=12, d_model=768, n_heads=12,
            n_kv_heads=4, head_dim=64, d_ff=2048, vocab_size=32000,
        )
    else:
        raise ValueError(size)
    return apply_sparsity(cfg, plan=make_plan(profile, cfg.n_layers))


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", default="cpu", choices=["cpu", "paper"])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=5e-2)
    ap.add_argument("--simulate-failure", type=int, default=None)
    ap.add_argument("--profile", default="depth",
                    choices=["uniform", "depth"],
                    help="sparsity plan: one-rule uniform 75%%, or the "
                         "depth-profiled heterogeneous plan")
    ap.add_argument("--checkpoint-dir",
                    default=os.path.join(tempfile.gettempdir(),
                                         "repro_example_lm"))
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    return ap


def main(argv=None) -> list:
    """Train; returns the run's losses.  A simulated failure exits 42."""
    args = build_parser().parse_args(argv)
    cfg = config(args.size, args.profile)
    model = LMModel(cfg, device=args.device, seed=0)
    plan = cfg.sparsity_rules
    print(f"model: {cfg.name} ({model.n_params():,} params, "
          f"{args.profile} plan {plan.fingerprint()}, "
          f"{len(plan.rules)} rules) on {model.device}")
    for r in plan.rules:
        print(f"  {r.spec.pattern}@{r.spec.sparsity:.2f}  {r.note}")

    tcfg = TrainConfig(optimizer="sgdm", lr=args.lr, schedule="cosine",
                       total_steps=args.steps, warmup_steps=args.steps // 10,
                       checkpoint_every=min(50, max(1, args.steps // 2)),
                       checkpoint_dir=args.checkpoint_dir)
    data = Prefetcher(TokenStream(cfg.vocab_size, args.batch, args.seq,
                                  seed=0))
    # the plan fingerprint rides with every checkpoint: resuming this
    # directory under the other --profile refuses instead of mixing masks
    tr = Trainer(model, tcfg, data, plan_fingerprint=plan.fingerprint())
    resumed = tr.try_resume()
    if resumed:
        print(f"auto-resumed from step {resumed}")
    tr.hooks.append(lambda s, m: s % 20 == 0 and print(
        f"step {s:5d} loss {m['loss']:.4f} lr {m['lr']:.2e} "
        f"({m['step_time_s'] * 1e3:.0f} ms)", flush=True))
    try:
        tr.run(args.steps - int(tr.state.step),
               fail_at_step=args.simulate_failure)
    except RuntimeError as e:
        if "simulated node failure" in str(e):
            print(f"FAILURE DRILL: {e}; rerun this command to auto-resume",
                  flush=True)
            sys.exit(42)
        raise
    losses = [h["loss"] for h in tr.history]
    if losses:
        print(f"done: loss {losses[0]:.3f} -> {losses[-1]:.3f} over "
              f"{len(losses)} steps")
    else:
        print("done: nothing to do (already past --steps)")
    return losses


if __name__ == "__main__":
    main()
