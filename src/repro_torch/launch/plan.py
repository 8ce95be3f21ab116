"""Plan compiler driver of the port: solve a sparsity budget for an
architecture, certify it spectrally, and write the files the other
drivers read.

The ``--out`` plan JSON feeds ``repro_torch.launch.train --plan`` and
``repro_torch.launch.serve --plan`` (its fingerprint is stamped into
checkpoints, and the serve engine admits by the weight bytes it frees);
``--report`` is the spectral certification: per layer, each sampled
Ramanujan factor's second singular value against the
``sqrt(d_l-1)+sqrt(d_r-1)`` bound.  The flags, the printed summary and
both files are the reference's (``repro/launch/plan.py``) for the same
arguments.  It runs on the host only: shapes are recorded on ``meta``.
Exit status 1 when a proper Ramanujan factor breaks its bound.

Examples:
  PYTHONPATH=src python -m repro_torch.launch.plan --arch tinyllama-1.1b \\
      --target-density 0.25 --min-dim 64 --out plan.json --report cert.json
  PYTHONPATH=src python -m repro_torch.launch.plan --arch qwen2-moe-a2.7b \\
      --target-density 0.25 --group role   # every layer moves in lockstep
"""
from __future__ import annotations

import argparse
import json
import re
import sys


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--target-density", type=float, default=0.0,
                    help="requested global weight-memory ratio vs dense "
                         "(0.25 = a 75%% reduction)")
    ap.add_argument("--target-flops", type=float, default=0.0,
                    help="alternative: global matmul-FLOP ratio vs dense")
    ap.add_argument("--pattern", default="rbgp4",
                    choices=["rbgp4", "rbgp", "block", "unstructured"])
    ap.add_argument("--backend", default="auto")
    ap.add_argument("--min-dim", type=int, default=256)
    ap.add_argument("--max-steps", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--group", default="path", choices=["path", "role"],
                    help="'role' strips the layer index from paths so "
                         "every layer of a role moves in lockstep (a "
                         "depth-uniform plan)")
    ap.add_argument("--out", default="",
                    help="write the plan JSON here")
    ap.add_argument("--report", default="",
                    help="write the spectral certification JSON here")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    if (args.target_density > 0) == (args.target_flops > 0):
        raise SystemExit("pass exactly one of --target-density/--target-flops")

    from repro_torch.configs import get_config, reduce_config
    from repro_torch.sparsity import (certify, model_matmul_shapes,
                                      plan_density, solve_budget)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduce_config(cfg)
    shapes = model_matmul_shapes(cfg)
    dense_params = sum(m * k * c for m, k, c in shapes.values())
    print(f"arch={cfg.name}: {len(shapes)} projection paths, "
          f"{dense_params / 1e9:.2f}B dense matmul params", flush=True)

    group = None
    if args.group == "role":
        group = lambda path: re.sub(r"^l\d+\.", "l*.", path)
    plan = solve_budget(
        shapes,
        target_density=args.target_density or None,
        target_flops=args.target_flops or None,
        pattern=args.pattern, backend=args.backend,
        min_dim=args.min_dim, max_steps=args.max_steps,
        seed=args.seed, group=group,
    )
    achieved = plan_density(plan, shapes)
    target = args.target_density or args.target_flops
    print(f"plan: {len(plan.rules)} rules, fingerprint {plan.fingerprint()}")
    print(f"density: target {target:.4f} -> achieved {achieved:.4f} "
          f"({1 - achieved:.1%} reduction)")
    for r in plan.rules:
        n_paths = r.match.count("|") + 1 if r.match != ".*" else "rest"
        print(f"  [{n_paths:>4}] sp={r.spec.sparsity:<7.4f} "
              f"pattern={r.spec.pattern:<8} {r.note}")

    report = certify(plan, shapes)
    s = report["summary"]
    print(f"certify: {s['n_factors']} factors "
          f"({s['n_proper_ramanujan']} proper Ramanujan), "
          f"all within bound: {s['all_ok']}")

    if args.out:
        plan.save(args.out)
        print(f"wrote plan to {args.out}")
    if args.report:
        with open(args.report, "w") as f:
            json.dump(report, f, indent=1, sort_keys=True)
        print(f"wrote spectral report to {args.report}")
    if not s["all_ok"]:
        print("FAIL: a proper Ramanujan factor violates the spectral bound",
              file=sys.stderr)
        sys.exit(1)


if __name__ == "__main__":
    main()
