"""Training driver of the port: the reference's ``launch/train.py`` for the
options ported so far.

Runs on the card unless ``--device cpu`` is given; without CUDA and without
that flag it exits with an error naming the flag.  Shows the
fault-tolerance contract:

  * checkpoints every --checkpoint-every steps (atomic, async);
  * auto-resumes from the latest checkpoint at startup;
  * ``--simulate-failure N`` stops the process at step N with exit code
    42 (a drill); rerunning the same command resumes and completes;
  * ``--global-batch`` keeps that global batch through gradient
    accumulation over microbatches of ``--batch``;
  * ``--plan plan.json`` (a ``SparsityPlan``) overrides ``--pattern``/
    ``--sparsity``; its fingerprint is stamped into every checkpoint, and
    a resume under another plan is refused;
  * ``--quant int8``, after training, exports a weight-only PTQ snapshot
    to ``<checkpoint-dir>/ptq_int8``: the float32 master values of every
    compact and chain projection as int8 leaf blocks + one f32 scale each
    (``<path>.q_data``, ``<path>.scales``), the other weights as their
    float32 masters, stamped with the fingerprint of the plan with
    ``quant='int8'``, so that int8 and full-precision restores refuse each
    other.

Examples:
  PYTHONPATH=src python -m repro_torch.launch.train --reduced --device cpu \
      --steps 20 --batch 4 --seq 32
  PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \
      --steps 10 --batch 8 --seq 512
  PYTHONPATH=src python -m repro_torch.launch.train --reduced --device cpu \
      --steps 6 --batch 2 --seq 16 --plan plan.json
  PYTHONPATH=src python -m repro_torch.launch.train --reduced --device cpu \
      --steps 6 --batch 2 --seq 16 --quant int8
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
from repro_torch.sparsity import SparsityPlan, quantize_weights
from repro_torch.train import CheckpointManager, Trainer


def build(args):
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduce_config(cfg)
    if args.plan:
        cfg = apply_sparsity(cfg, plan=SparsityPlan.load(args.plan))
    elif args.sparsity > 0:
        cfg = apply_sparsity(cfg, pattern=args.pattern,
                             sparsity=args.sparsity, min_dim=args.min_dim)
    model = LMModel(cfg, device=args.device, seed=args.seed)
    # one device: the global batch is kept by gradient accumulation
    micro = max(1, args.global_batch // max(args.batch, 1))
    tcfg = TrainConfig(
        optimizer=args.optimizer,
        lr=args.lr,
        schedule=args.schedule,
        total_steps=args.steps,
        warmup_steps=min(100, args.steps // 10),
        microbatches=micro if args.global_batch else 1,
        checkpoint_every=args.checkpoint_every,
        checkpoint_dir=args.checkpoint_dir,
    )
    per_step_batch = args.batch * tcfg.microbatches
    data = Prefetcher(TokenStream(cfg.vocab_size, per_step_batch, args.seq,
                                  seed=args.seed))
    return cfg, model, tcfg, data


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--reduced", action="store_true",
                    help="use the CPU-sized reduced config")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--global-batch", type=int, default=0,
                    help="if set, keep this global batch via gradient "
                         "accumulation")
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-2)
    ap.add_argument("--optimizer", default="sgdm", choices=["sgdm", "adamw"])
    ap.add_argument("--schedule", default="cosine",
                    choices=["cosine", "step", "constant"])
    ap.add_argument("--pattern", default="rbgp4")
    ap.add_argument("--sparsity", type=float, default=0.75)
    ap.add_argument("--min-dim", type=int, default=64)
    ap.add_argument("--plan", default="",
                    help="SparsityPlan JSON; overrides --pattern/--sparsity. "
                         "Its fingerprint is stamped into checkpoints and a "
                         "restore under another plan is refused")
    ap.add_argument("--quant", default="", choices=["", "int8"],
                    help="after training, export a weight-only PTQ snapshot "
                         "(compact/chain values -> int8 leaf blocks + per-"
                         "leaf-block f32 scales) to <checkpoint-dir>/"
                         "ptq_<quant>, stamped with the quant-marked plan "
                         "fingerprint so f32<->int8 restores refuse")
    ap.add_argument("--checkpoint-every", type=int, default=25)
    ap.add_argument("--checkpoint-dir",
                    default=os.path.join(tempfile.gettempdir(),
                                         "repro_torch_train_ckpt"))
    ap.add_argument("--simulate-failure", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    cfg, model, tcfg, data = build(args)
    plan = cfg.sparsity_rules
    sp_desc = (f"plan={plan.fingerprint()} ({len(plan.rules)} rules)"
               if cfg.plan is not None else
               f"pattern={cfg.sparsity.pattern}@{cfg.sparsity.sparsity}")
    print(f"arch={cfg.name} params={model.n_params():,} "
          f"device={model.device} micro={tcfg.microbatches} {sp_desc}",
          flush=True)

    trainer = Trainer(model, tcfg, data,
                      plan_fingerprint=plan.fingerprint())
    resumed = trainer.try_resume()
    if resumed is not None:
        print(f"auto-resumed from checkpoint at step {resumed}", flush=True)

    def log_hook(step, metrics):
        if step % args.log_every == 0:
            print(f"step {step:6d} loss {metrics['loss']:.4f} "
                  f"ce {metrics.get('ce', 0):.4f} "
                  f"aux {metrics.get('aux', 0):.4f} lr {metrics['lr']:.2e} "
                  f"gnorm {metrics['grad_norm']:.2f} "
                  f"dt {metrics['step_time_s'] * 1e3:.0f}ms", flush=True)

    trainer.hooks.append(log_hook)
    remaining = args.steps - trainer.state.step
    if remaining <= 0:
        print("nothing to do (already past --steps)")
        return
    try:
        trainer.run(remaining, fail_at_step=args.simulate_failure)
    except RuntimeError as e:
        if "simulated node failure" in str(e):
            print(f"FAILURE DRILL: {e}; checkpoint preserved at "
                  f"{tcfg.checkpoint_dir}; rerun the same command to resume",
                  flush=True)
            sys.exit(42)
        raise
    losses = [h["loss"] for h in trainer.history]
    if trainer.straggler_events:
        print(f"straggler watchdog flagged {len(trainer.straggler_events)} "
              f"slow steps: {trainer.straggler_events[:5]}")
    print(f"done: steps={trainer.state.step} "
          f"first-loss={losses[0]:.4f} last-loss={losses[-1]:.4f}")
    if args.quant:
        export_ptq(model, trainer, plan, args.quant, tcfg.checkpoint_dir)


def export_ptq(model, trainer, plan, quant: str, checkpoint_dir: str) -> str:
    """Quantize the float32 master values into ``model`` (in place) and
    save its state, the other weights as their masters, to
    ``<checkpoint_dir>/ptq_<quant>`` under the quant-marked plan's
    fingerprint.  Returns the snapshot's path."""
    qplan = plan.with_quant(quant)
    masters = trainer.state.params
    quantize_weights(model, values=masters)
    tree = {name: masters.get(name, t)
            for name, t in model.state_dict().items()}
    mgr = CheckpointManager(os.path.join(checkpoint_dir, f"ptq_{quant}"),
                            plan_fingerprint=qplan.fingerprint())
    step = int(trainer.state.step)
    mgr.save(step, tree)
    print(f"PTQ export: {quant} leaf-block weights -> {mgr.path(step)} "
          f"(plan {qplan.fingerprint()})", flush=True)
    return mgr.path(step)


if __name__ == "__main__":
    main()
