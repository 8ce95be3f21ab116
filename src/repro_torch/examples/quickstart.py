"""Quickstart: the RBGP4 pattern end to end on the port.

The port of the reference's ``examples/quickstart.py``:

  1. design an RBGP4 factorization for a 4096x4096 layer at 93.75%,
  2. check the theory: the factors are Ramanujan, the product's index is
     succinct (paper Fig. 3),
  3. run the ``rbgp4mm`` kernel (its plain version on the CPU) against the
     dense oracle ``kernels.ref.ref_rbgp4mm``,
  4. run one layer through every registered sparse backend that accepts
     its container (``sparsity.api``) and check that they agree,
  5. train a small RBGP4-sparse regression: the mask is fixed, learning
     happens through the sparse connections only,
  6. the SparsityPlan API: lower a uniform config to a plan (the same
     masks), solve a global memory budget into per-layer pow-2
     sparsities, certify the factors spectrally, round-trip through JSON.

Run:  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.core import RBGP4Layout, design_rbgp4, is_ramanujan, \
    second_singular_value
from repro_torch.device import resolve_device
from repro_torch.kernels import RBGP4Op
from repro_torch.kernels import ref as kref
from repro_torch.sparsity import (SparseLinear, SparsityConfig,
                                  SparsityPlan, available_backends, certify,
                                  dense_weight, lower_config, plan_density,
                                  resolve_backend, solve_budget,
                                  sparse_linear)

#: the plan section's (path -> shape) table
PLAN_SHAPES = {
    "l0.attn.wq": (1024, 1024), "l0.mlp.gate": (4096, 1024),
    "l0.mlp.down": (1024, 4096), "l0.attn.wk": (128, 1024),
}


def _gen(device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def design(m: int = 4096, k: int = 4096,
           sparsity: float = 0.9375) -> RBGP4Layout:
    """Step 1: the RBGP4 factorization of an m x k layer."""
    spec = design_rbgp4(m, k, sparsity)
    print(f"RBGP4 factorization of a {m}x{k} layer @ {sparsity:.2%} "
          f"sparsity:")
    print(f"  G_o {spec.g_o} sp={spec.sp_o}   (tile-level sparsity: skip "
          f"whole {spec.tile_m}x{spec.tile_k} tiles)")
    print(f"  G_i {spec.g_i} sp={spec.sp_i}   (intra-tile sparsity)")
    print(f"  G_r*G_b -> dense ({spec.group_rows}, {spec.chunk_cols}) "
          f"blocks")
    return RBGP4Layout(spec)


def theory(layout: RBGP4Layout) -> dict:
    """Step 2: each factor's second singular value against the Ramanujan
    bound, the product's succinct index and the memory it takes."""
    print("\nTheory checks:")
    ok = {}
    for name, g in (("G_o", layout.graph_o), ("G_i", layout.graph_i)):
        lam2 = second_singular_value(g)
        ok[name] = bool(is_ramanujan(g))
        print(f"  {name}: {g.n_left}x{g.n_right} d_l={g.d_left} "
              f"lambda2={lam2:.3f} Ramanujan={ok[name]}")
    s = layout.product_structure().storage_summary()
    print(f"  product: {s['edges']:,} edges, index stored as "
          f"{s['stored_index_edges']} base-graph edges "
          f"({s['index_compression']:.0f}x succinct, paper Fig. 3)")
    mem = layout.memory_bytes()
    print(f"  memory: values {mem['values'] / 1e3:.0f} KB + index "
          f"{mem['index_succinct'] / 1e3:.1f} KB (unstructured would need "
          f"{mem['index_full'] / 1e3:.0f} KB of index)")
    return {"ramanujan": ok, "storage": s, "memory": mem}


def kernel_check(layout: RBGP4Layout, device, n: int = 64) -> float:
    """Step 3: O = W_s @ I on the ``rbgp4mm`` kernel against the dense
    oracle; returns max |kernel - oracle|."""
    device = resolve_device(device)
    print(f"\nrbgp4mm kernel vs oracle ({device.type}):")
    op = RBGP4Op(layout, device)
    w = op.init_data(_gen(device, 0))
    x = torch.randn(layout.k, n, generator=_gen(device, 1), device=device)
    out = op.matmul(w, x)
    want = kref.ref_rbgp4mm(layout, w, x)
    err = float((out - want).abs().max())
    print(f"  O = W_s @ I: out {tuple(out.shape)}, max |kernel - oracle| = "
          f"{err:.2e}")
    return err


def backends_check(device, n: int = 512, rows: int = 8,
                   sparsity: float = 0.75) -> tuple[dict, float]:
    """Step 4: one n x n compact layer through every registered backend
    that accepts its container; returns {name: max |y - dense product|}
    and max |dense product|."""
    device = resolve_device(device)
    print("\nOne layer through every registered backend (sparsity.api):")
    lin = SparseLinear(n, n, SparsityConfig(pattern="rbgp4",
                                            sparsity=sparsity,
                                            backend="auto", min_dim=1),
                       device=device, generator=_gen(device, 5))
    weight = lin.weight()                 # a CompactWeight
    xq = torch.randn(rows, n, generator=_gen(device, 6), device=device)
    y_ref = xq @ dense_weight(weight).T
    errs = {}
    for name in available_backends(weight=weight):
        y = sparse_linear(weight, xq, backend=name)
        errs[name] = float((y - y_ref).abs().max())
        print(f"  backend={name:12s} max err vs dense ref = "
              f"{errs[name]:.2e}")
    print(f"  (auto on {device.type} resolves to "
          f"{resolve_backend(weight).name})")
    return errs, float(y_ref.abs().max())


def regression(device, d: int = 256, n: int = 512, steps: int = 500,
               lr: float = 0.5) -> list:
    """Step 5: fit an RBGP4-sparse target through the same fixed mask
    (masked storage, ``xla_masked``); returns the losses."""
    device = resolve_device(device)
    print("\nTraining through the fixed RBGP4 mask (tiny regression):")
    cfg = SparsityConfig(pattern="rbgp4", sparsity=0.75,
                         backend="xla_masked", min_dim=1)
    lin = SparseLinear(d, d, cfg, device=device, generator=_gen(device, 2))
    # the target is RBGP4-sparse on the same mask (the pattern's seed is
    # the config's), other values: the student can represent it exactly
    target = SparseLinear(d, d, cfg, device=device,
                          generator=_gen(device, 3))
    w_true = dense_weight(target.weight()) / 4.0
    xs = torch.randn(n, d, generator=_gen(device, 4), device=device)
    ys = xs @ w_true.T
    lin.w.requires_grad_(True)
    losses = []
    for _ in range(steps):
        loss = torch.mean((lin(xs) - ys) ** 2)
        (g,) = torch.autograd.grad(loss, lin.w)
        with torch.no_grad():
            lin.w -= lr * g
        losses.append(float(loss.detach()))
    print(f"  mse step 0: {losses[0]:.4f} -> step {steps}: "
          f"{losses[-1]:.4f} ({losses[0] / losses[-1]:.0f}x down; mask "
          f"stayed fixed)")
    return losses


def plan_section(device, shapes: dict = None, target_density: float = 0.25,
                 min_dim: int = 256, n: int = 512) -> dict:
    """Step 6: a config as its one-rule plan (the same masks), a solved
    memory budget, its spectral certificate and its JSON round trip;
    returns the certificate."""
    device = resolve_device(device)
    shapes = PLAN_SHAPES if shapes is None else shapes
    print("\nSparsityPlan: per-layer sparsity as declarative path rules")
    uni_cfg = SparsityConfig(pattern="rbgp4", sparsity=0.75, min_dim=1)
    uniform = lower_config(uni_cfg)
    lin_a = SparseLinear(n, n, uni_cfg, name="layer", device=device)
    lin_b = SparseLinear(n, n, uniform, name="layer", device=device)
    assert (lin_a.pattern.mask() == lin_b.pattern.mask()).all()
    print(f"  uniform plan {uniform.fingerprint()}: masks bit-identical to "
          f"the SparsityConfig path")
    plan = solve_budget(shapes, target_density=target_density,
                        min_dim=min_dim)
    print(f"  budget {target_density} -> achieved "
          f"{plan_density(plan, shapes):.4f}:")
    for r in plan.rules:
        print(f"    {r.spec.pattern}@{r.spec.sparsity:.4f}  <- "
              f"{r.match[:60]}")
    rep = certify(plan, shapes)
    print(f"  certify: {rep['summary']['n_proper_ramanujan']} proper "
          f"Ramanujan factors, all within bound: "
          f"{rep['summary']['all_ok']}")
    restored = SparsityPlan.loads(plan.dumps())
    assert restored.fingerprint() == plan.fingerprint()
    for path, (m, k) in shapes.items():
        assert (restored.pattern_for(path, m, k).mask()
                == plan.pattern_for(path, m, k).mask()).all()
    print("  JSON round trip: fingerprint + masks bit-identical")
    return rep


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    layout = design()
    theory(layout)
    assert kernel_check(layout, device) < 1e-4
    assert max(backends_check(device)[0].values()) < 1e-3
    losses = regression(device)
    assert losses[-1] < losses[0] / 5
    assert plan_section(device)["summary"]["all_ok"]
    print("\nquickstart OK")


if __name__ == "__main__":
    main()
