"""The port's plan compiler against the reference's, on the CPU.

  * ``model_matmul_shapes`` records the reference's table, path for path
    and in the same order, for tinyllama-1.1b and qwen2-moe-a2.7b (full
    width and ``reduce_config``), VGG19-CIFAR, WRN-40-4 and a WRN-10-1;
    recording builds nothing (no parameter, no pattern) and cleans up
    after an error; ``_layer_paths``, which feeds the plan signature,
    names exactly what recording finds in each layer;
  * ``solve_budget``: ``to_json()`` and ``fingerprint()`` equal the
    reference's, exactly, on those tables at ``target_density`` 0.5 and
    0.25 and ``target_flops`` 0.5, on the reference test's
    ``ROUTE_SHAPES`` with dict and callable ``backend``, with
    ``group`` by role, for the ``rbgp4``, ``rbgp``, ``block`` and
    ``unstructured`` patterns (experts kept dense with the warning), and
    its errors carry the reference's messages;
  * ``plan_density`` within 1e-12 relative, ``certify``'s report ``==``
    the reference's (the per-layer seeds included), ``materialize`` the
    reference's masks;
  * ``kernels.perf_model``: with the TPU's constants patched in, every
    ``estimate_*`` within 1e-12 relative of the reference's and the
    reference's ``cost_model="perf_model"`` plans; at the H100's own
    constants, the reference test's properties; ``chip_smoke.py`` takes
    its data-sheet figures from it, and its plan phases find the
    reference's plans and the layouts they hold.

The shape tables are host-only and exact, so the tolerance is "exact"
wherever the output is a plan or a report.
"""
import functools
import re
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import reduce_config as j_reduce_config
from repro.core import design_rbgp as j_design_rbgp
from repro.core import design_rbgp4 as j_design_rbgp4
from repro.kernels import perf_model as j_pm
from repro.models.vision import VisionConfig as JVisionConfig
from repro.sparsity import PatternSpec as JPatternSpec
from repro.sparsity import SparsityConfig as JSparsityConfig
from repro.sparsity import SparsityPlan as JSparsityPlan
from repro.sparsity import certify as j_certify
from repro.sparsity import model_matmul_shapes as j_shapes
from repro.sparsity import plan_density as j_plan_density
from repro.sparsity import solve_budget as j_solve_budget
from repro_torch.configs import get_config, reduce_config
from repro_torch.core import design_rbgp, design_rbgp4
from repro_torch.kernels import perf_model as pm
from repro_torch.models.moe import StackedExperts
from repro_torch.models.transformer import DecoderLayer, _layer_paths
from repro_torch.models.vision import VisionConfig
from repro_torch.sparsity import (PatternSpec, SparseLinear, SparsityConfig,
                                  SparsityPlan, certify, model_matmul_shapes,
                                  plan_density, recording_active,
                                  recording_shapes, solve_budget)

torch.set_num_threads(1)

LM_ARCHS = ("tinyllama-1.1b", "qwen2-moe-a2.7b")
VISION_ARCHS = ("vgg19-cifar", "wrn40-4-cifar")
# the reference test's synthetic table (tests/test_sparsity_plan.py:659)
ROUTE_SHAPES = {
    "l1.moe.experts.in": (512, 1024, 8),
    "l1.moe.experts.out": (1024, 512, 4),
    "l1.attn.wq": (1024, 1024, 1),
    "l1.attn.wo": (1024, 1024, 1),
}
# the reference test's perf-model table (tests/test_sparsity_plan.py:264)
PM_SHAPES = {"l0.attn.wq": (2048, 2048, 1), "l0.mlp.up": (5632, 2048, 2),
             "l0.mlp.down": (2048, 5632, 1), "head": (512, 128, 1)}
TPU_CONSTANTS = dict(PEAK_FLOPS=197e12, HBM_BW=819e9, MMA_ROWS=16, MMA_K=128)


def _configs(name: str):
    """(reference config, port config) of a table name: an arch, an arch
    + '/reduced', or 'wrn10-1' (a reduced WRN: reduce_config has no
    vision branch)."""
    if name == "wrn10-1":
        return (JVisionConfig("wrn10-1", depth=10, width=1),
                VisionConfig("wrn10-1", depth=10, width=1))
    arch, _, reduced = name.partition("/")
    jcfg, cfg = j_get_config(arch), get_config(arch)
    if reduced:
        jcfg, cfg = j_reduce_config(jcfg), reduce_config(cfg)
    return jcfg, cfg


@functools.lru_cache(maxsize=None)
def _tables(name: str):
    jcfg, cfg = _configs(name)
    return j_shapes(jcfg), model_matmul_shapes(cfg)


TABLES = (LM_ARCHS + tuple(f"{a}/reduced" for a in LM_ARCHS) + VISION_ARCHS
          + ("wrn10-1",))


# ---------------------------------------------------------------------------
# shape recording
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", TABLES)
def test_model_matmul_shapes_equal_the_reference(name):
    want, got = _tables(name)
    assert list(got.items()) == list(want.items())


def test_recording_builds_nothing_and_is_not_reentrant():
    with recording_shapes() as shapes:
        lin = SparseLinear(2048, 5632, name="l0.mlp.gate", device="cuda")
        se = StackedExperts(60, 2048, 1408, name="l0.moe", device="cuda")
        with pytest.raises(RuntimeError, match="not reentrant"):
            with recording_shapes():
                pass
        assert recording_active()
    # no pattern, no storage, no weight: nothing touched the (absent) card
    assert lin.pattern is None and lin.mode == "dense"
    assert list(lin.parameters()) == [] and list(se.parameters()) == []
    assert shapes == {"l0.mlp.gate": (5632, 2048, 1),
                      "l0.moe.experts.in": (1408, 2048, 120),
                      "l0.moe.experts.out": (2048, 1408, 60)}
    assert not recording_active()


def test_recording_clears_after_an_error():
    with pytest.raises(ValueError, match="two shapes"):
        with recording_shapes():
            SparseLinear(64, 64, name="x")
            SparseLinear(64, 128, name="x")
    assert not recording_active()
    # and a full-width table records again afterwards
    assert len(model_matmul_shapes(get_config("tinyllama-1.1b"))) == 154


@pytest.mark.parametrize("name", LM_ARCHS + tuple(f"{a}/reduced"
                                                  for a in LM_ARCHS))
def test_layer_paths_are_what_recording_finds(name):
    """``_layer_paths`` (the plan signature's source) and the shapes
    recording gives for the same layer must not drift."""
    _, cfg = _configs(name)
    for i in range(cfg.n_layers):
        with recording_shapes() as shapes:
            DecoderLayer(cfg, i, device="meta")
        recorded = sorted((p, m, k) for p, (m, k, _) in shapes.items())
        assert _layer_paths(cfg, i) == recorded, (name, i)


# ---------------------------------------------------------------------------
# the budget solver
# ---------------------------------------------------------------------------

def _both(shapes_j, shapes_t, **kw):
    """Solve with both packages; either both raise the same message, or
    both give plans whose JSON and fingerprint are equal."""
    try:
        want = j_solve_budget(shapes_j, **kw)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            solve_budget(shapes_t, **kw)
        assert str(got.value) == str(e)
        return None, None
    got = solve_budget(shapes_t, **kw)
    assert got.to_json() == want.to_json()
    assert got.dumps() == want.dumps()
    assert got.fingerprint() == want.fingerprint()
    return want, got


TARGETS = {"density-0.5": dict(target_density=0.5, min_dim=64),
           "density-0.25": dict(target_density=0.25, min_dim=64),
           "flops-0.5": dict(target_flops=0.5, min_dim=64)}


@pytest.mark.parametrize("target", list(TARGETS))
@pytest.mark.parametrize("name", LM_ARCHS + VISION_ARCHS)
def test_solve_budget_equals_the_reference(name, target):
    shapes_j, shapes_t = _tables(name)
    want, got = _both(shapes_j, shapes_t, **TARGETS[target])
    assert got is not None
    d_j, d_t = j_plan_density(want, shapes_j), plan_density(got, shapes_t)
    assert abs(d_t - d_j) <= 1e-12 * abs(d_j)
    assert certify(got, shapes_t) == j_certify(want, shapes_j)


@pytest.mark.parametrize("name", [f"{a}/reduced" for a in LM_ARCHS]
                         + ["wrn10-1"])
def test_solve_budget_equals_the_reference_reduced(name):
    shapes_j, shapes_t = _tables(name)
    for kw in TARGETS.values():
        want, got = _both(shapes_j, shapes_t, **kw)
        if got is not None:
            assert certify(got, shapes_t) == j_certify(want, shapes_j)


def _route(path: str) -> str:
    return "xla_compact" if "experts" in path else "xla_masked"


@pytest.mark.parametrize("backend", [
    "auto", "xla_masked",
    {r"\.experts": "xla_compact", r"attn\.": "xla_masked"},
    {r"\.experts$": "xla_masked"},
    _route,
], ids=["auto", "masked", "dict", "dict-coupled", "callable"])
def test_solve_budget_backend_routing_equals_the_reference(backend):
    want, got = _both(ROUTE_SHAPES, ROUTE_SHAPES, target_density=0.25,
                      min_dim=64, backend=backend)
    assert certify(got, ROUTE_SHAPES) == j_certify(want, ROUTE_SHAPES)
    # equal-step layers with different backends: separate rules
    shapes = {"a.x": (512, 512), "b.x": (512, 512)}
    route = lambda p: "xla_compact" if p.startswith("a") else "xla_masked"
    want, got = _both(shapes, shapes, target_density=0.5, min_dim=64,
                      backend=route)
    assert len([r for r in got.rules if r.spec.is_sparse]) == 2


@pytest.mark.parametrize("name", ["tinyllama-1.1b", "qwen2-moe-a2.7b/reduced"])
def test_solve_budget_group_by_role_equals_the_reference(name):
    shapes_j, shapes_t = _tables(name)
    role = lambda path: re.sub(r"^l\d+\.", "l*.", path)
    want, got = _both(shapes_j, shapes_t, target_density=0.25, min_dim=64,
                      group=role)
    assert certify(got, shapes_t) == j_certify(want, shapes_j)


@pytest.mark.parametrize("pattern", ["rbgp4", "rbgp", "block",
                                     "unstructured"])
def test_solve_budget_patterns_equal_the_reference(pattern):
    shapes_j, shapes_t = _tables("tinyllama-1.1b/reduced")
    want, got = _both(shapes_j, shapes_t, target_density=0.5, min_dim=64,
                      pattern=pattern)
    assert got is not None
    assert certify(got, shapes_t) == j_certify(want, shapes_j)
    d_j, d_t = j_plan_density(want, shapes_j), plan_density(got, shapes_t)
    assert abs(d_t - d_j) <= 1e-12 * abs(d_j)


@pytest.mark.parametrize("pattern", ["block", "unstructured"])
def test_solve_budget_keeps_experts_dense_with_the_warning(pattern):
    """Patterns without stacked storage leave the expert paths dense, with
    the reference's warning, and the plan builds a StackedExperts."""
    for shapes in (ROUTE_SHAPES, _tables("qwen2-moe-a2.7b/reduced")[1]):
        with pytest.warns(UserWarning) as w_ref:
            want = j_solve_budget(shapes, target_density=0.9,
                                  pattern=pattern, min_dim=64)
        with pytest.warns(UserWarning,
                          match="no stacked expert storage") as w_got:
            got = solve_budget(shapes, target_density=0.9, pattern=pattern,
                               min_dim=64)
        assert [str(w.message) for w in w_got] == \
            [str(w.message) for w in w_ref]
        assert got.to_json() == want.to_json()
        assert got.fingerprint() == want.fingerprint()
    assert got.resolve("l0.moe.experts.in").pattern == "dense"
    se = StackedExperts(8, 64, 64, got, name="l0.moe", device="cpu")
    assert se.storage == "dense"


ERRORS = {
    "neither target": dict(),
    "both targets": dict(target_density=0.5, target_flops=0.5),
    "target out of range": dict(target_density=1.5),
    "unreachable": dict(target_density=0.5, min_dim=256),
    "perf_model needs flops": dict(target_density=0.5,
                                   cost_model="perf_model"),
    "perf_model needs compact": dict(target_flops=0.5,
                                     cost_model="perf_model",
                                     pattern="block"),
    "unknown cost model": dict(target_flops=0.5, cost_model="wat"),
}
MATCH = {"neither target": "exactly one", "both targets": "exactly one",
         "target out of range": "target must be in",
         "unreachable": "unreachable",
         "perf_model needs flops": "target_flops",
         "perf_model needs compact": "compact executors",
         "unknown cost model": "cost_model"}


@pytest.mark.parametrize("case", list(ERRORS))
def test_solve_budget_errors_are_the_references(case):
    shapes = {"a": (64, 64)} if case == "unreachable" else {"a": (512, 512)}
    with pytest.raises(ValueError, match=MATCH[case]) as want:
        j_solve_budget(shapes, **ERRORS[case])
    with pytest.raises(ValueError, match=MATCH[case]) as got:
        solve_budget(shapes, **ERRORS[case])
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="empty shape table"):
        solve_budget({}, target_density=0.5)


# ---------------------------------------------------------------------------
# density, certification, materialization
# ---------------------------------------------------------------------------

def test_certify_covers_realized_per_layer_seeds():
    """The reference test's plans (tests/test_sparsity_plan.py:209):
    masked rules certify each layer's own seed, compact rules the shared
    one; the two reports equal the reference's."""
    shapes = {"l0.a": (256, 256), "l5.a": (256, 256), "fc": (256, 256)}
    for backend, seeds in (("xla_masked", (1000, 6000, 0)),
                           ("auto", (0, 0, 0))):
        plan = SparsityPlan.uniform(
            PatternSpec("rbgp4", 0.5, backend=backend, min_dim=1))
        jplan = JSparsityPlan.uniform(
            JPatternSpec("rbgp4", 0.5, backend=backend, min_dim=1))
        rep = certify(plan, shapes)
        assert rep == j_certify(jplan, shapes)
        assert tuple(rep["layers"][p]["seed"] for p in ("l0.a", "l5.a",
                                                        "fc")) == seeds
        assert rep["summary"]["all_ok"]


def test_certify_and_density_of_chains_and_masked_patterns():
    """Deep chains (the chain layout's own samples), an rbgp chain that
    fits RBGP4, unstructured (no factors) and a dense path."""
    shapes = {"l0.attn.wq": (256, 256, 1), "l1.mlp.up": (512, 256, 2),
              "fc": (256, 512, 1), "tiny": (32, 32, 1)}
    ram = ("ramanujan", 0, 0, -1.0)
    specs = [dict(pattern="rbgp", sparsity=0.875, min_dim=64,
                  factors=(("complete", 2, 2, 0.0), ram, ram, ram,
                           ("complete", 2, 2, 0.0))),
             dict(pattern="rbgp", sparsity=0.75, min_dim=64),
             dict(pattern="unstructured", sparsity=0.75, min_dim=64)]
    for spec in specs:
        for backend in ("auto", "xla_masked"):
            plan = SparsityPlan.uniform(PatternSpec(backend=backend, **spec))
            jplan = JSparsityPlan.uniform(JPatternSpec(backend=backend,
                                                       **spec))
            rep = certify(plan, shapes)
            assert rep == j_certify(jplan, shapes), (spec, backend)
            d_j = j_plan_density(jplan, shapes)
            assert abs(plan_density(plan, shapes) - d_j) <= 1e-12 * d_j


def test_materialize_gives_the_references_masks():
    shapes_j, shapes_t = _tables("tinyllama-1.1b/reduced")
    want = j_solve_budget(shapes_j, target_density=0.25, min_dim=64)
    got = solve_budget(shapes_t, target_density=0.25, min_dim=64)
    inst_j, inst_t = want.materialize(shapes_j), got.materialize(shapes_t)
    assert list(inst_t) == list(inst_j)
    for path in inst_t:
        a, b = inst_t[path], inst_j[path]
        assert (a.name, a.nnz, a.sparsity) == (b.name, b.nnz, b.sparsity)
        np.testing.assert_array_equal(a.mask(), b.mask())


def test_default_backend_differs_but_plans_name_theirs():
    """The one deliberate default difference: the port's
    ``SparsityConfig.backend`` is ``auto`` (compact storage for the
    kernels), the reference's ``xla_masked``.  The plan compiler never
    leans on either default: ``solve_budget`` writes every rule's backend
    (the keep-dense rule is the reference's ``PatternSpec()``), so plans,
    reports and fingerprints agree; a plan built on the defaults would
    not, and that is what a caller must spell out."""
    assert SparsityConfig().backend == "auto"
    assert JSparsityConfig().backend == "xla_masked"
    shapes = {"l0.a": (256, 256), "l3.b": (512, 256)}
    want, got = _both(shapes, shapes, target_density=0.5, min_dim=64)
    assert got.rules[-1].spec.to_json() == JPatternSpec().to_json()
    assert all(r.spec.backend == "auto" for r in got.rules[:-1])
    assert certify(got, shapes) == j_certify(want, shapes)
    # the defaults: one masked rule (per-layer seeds) against one compact
    default = certify(SparsityPlan.uniform(PatternSpec("rbgp4", 0.5,
                                                       min_dim=1)), shapes)
    j_default = j_certify(JSparsityPlan.uniform(JPatternSpec(
        "rbgp4", 0.5, min_dim=1)), shapes)
    assert default["layers"]["l0.a"]["seed"] == 0
    assert j_default["layers"]["l0.a"]["seed"] == 1000


# ---------------------------------------------------------------------------
# the perf model
# ---------------------------------------------------------------------------

@pytest.fixture
def tpu_constants(monkeypatch):
    for name, value in TPU_CONSTANTS.items():
        monkeypatch.setattr(pm, name, value)


def _close(a: float, b: float) -> None:
    assert abs(a - b) <= 1e-12 * max(abs(b), 1e-300), (a, b)


def _same_estimate(got, want) -> None:
    for field in ("flops", "bytes_w", "bytes_i", "bytes_o", "u_rows",
                  "u_contract", "t_compute_s", "t_memory_s", "t_total_s",
                  "bytes_total"):
        _close(getattr(got, field), getattr(want, field))


ESTIMATE_SHAPES = [(2048, 2048, 0.5), (5632, 2048, 0.875), (2048, 1408, 0.875),
                   (64, 576, 0.75), (512, 4608, 0.9375)]


@pytest.mark.parametrize("n", [8, 2048, 262144])
def test_perf_model_estimates_equal_the_reference_at_tpu_constants(
        tpu_constants, n):
    for m, k, sp in ESTIMATE_SHAPES:
        spec, j_spec = design_rbgp4(m, k, sp), j_design_rbgp4(m, k, sp)
        for kw in ({}, dict(w_bytes_per_el=1), dict(bytes_per_el=4,
                                                    block_n=128)):
            _same_estimate(pm.estimate_rbgp4mm(spec, n, **kw),
                           j_pm.estimate_rbgp4mm(j_spec, n, **kw))
        dims = types.SimpleNamespace(
            m=spec.m, tile_m=spec.tile_m, tile_k=spec.tile_k,
            group_rows=spec.group_rows, chunk_cols=spec.chunk_cols,
            d_o=spec.d_o, d_i=spec.d_i)
        _same_estimate(pm.estimate_rbgp4mm_dims(dims, n),
                       j_pm.estimate_rbgp4mm_dims(dims, n))
        _same_estimate(pm.estimate_chainmm(dims, n, w_bytes_per_el=1),
                       j_pm.estimate_chainmm(dims, n, w_bytes_per_el=1))
        _same_estimate(pm.estimate_dense(m, k, n),
                       j_pm.estimate_dense(m, k, n))
        _same_estimate(pm.estimate_unstructured(m, k, n, sp),
                       j_pm.estimate_unstructured(m, k, n, sp))
    ram = ("ramanujan", 0, 0, -1.0)
    factors = (("complete", 4, 4, 0.0), ram, ram, ram,
               ("complete", 8, 8, 0.0))
    _same_estimate(
        pm.estimate_chain_spec(design_rbgp(2048, 2048, 0.875,
                                           factors=factors), n),
        j_pm.estimate_chain_spec(j_design_rbgp(2048, 2048, 0.875,
                                               factors=factors), n))


@pytest.mark.parametrize("pattern", ["rbgp4", "rbgp"])
def test_perf_model_plans_equal_the_reference_at_tpu_constants(
        tpu_constants, pattern):
    tables = [(PM_SHAPES, PM_SHAPES), _tables("tinyllama-1.1b/reduced")]
    if pattern == "rbgp4":
        tables.append(_tables("tinyllama-1.1b"))
    for shapes_j, shapes_t in tables:
        _both(shapes_j, shapes_t, target_flops=0.5, min_dim=64,
              cost_model="perf_model", pattern=pattern)


def test_perf_model_at_h100_constants_meets_the_modeled_target():
    """The reference test's properties (tests/test_sparsity_plan.py:259)
    at the H100 data-sheet constants: deterministic, the modeled time
    ratio meets the target, and the same refusals."""
    assert (pm.PEAK_FLOPS, pm.HBM_BW, pm.MMA_ROWS, pm.MMA_K) == \
        (989e12, 3.35e12, 16, 16)
    p1 = solve_budget(PM_SHAPES, target_flops=0.5, cost_model="perf_model")
    p2 = solve_budget(PM_SHAPES, target_flops=0.5, cost_model="perf_model")
    assert p1.fingerprint() == p2.fingerprint()
    assert p1.to_json() == p2.to_json()

    def modeled(plan):
        tot_s = tot_d = 0.0
        for path, (m, k, c) in PM_SHAPES.items():
            spec = plan.resolve(path, m, k)
            dense = pm.estimate_dense(m, k, 2048).t_total_s * c
            tot_d += dense
            if spec.applies_to(m, k) and spec.is_sparse:
                tot_s += pm.estimate_rbgp4mm(
                    design_rbgp4(m, k, spec.sparsity, seed=0),
                    2048).t_total_s * c
            else:
                tot_s += dense
        return tot_s / tot_d

    assert modeled(p1) <= 0.5
    for kw, match in ((dict(target_density=0.5), "target_flops"),
                      (dict(target_flops=0.5, pattern="block"),
                       "compact executors")):
        with pytest.raises(ValueError, match=match):
            solve_budget(PM_SHAPES, cost_model="perf_model", **kw)
    # a full-width table solves too, and its modeled time meets the target
    shapes = _tables("tinyllama-1.1b")[1]
    plan = solve_budget(shapes, target_flops=0.5, min_dim=64,
                        cost_model="perf_model")
    assert certify(plan, shapes)["summary"]["all_ok"]


# ---------------------------------------------------------------------------
# what the card's smoke run takes from the plan compiler
# ---------------------------------------------------------------------------

def test_chip_smoke_reads_the_data_sheet_from_the_perf_model():
    """One source for the card's data-sheet figures: every bound
    ``chip_smoke.py`` prints divides by the perf model's constants."""
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke

    assert chip_smoke.HBM_BYTES_PER_S == pm.HBM_BW == 3.35e12
    assert chip_smoke.BF16_FLOPS == pm.PEAK_FLOPS == 989e12


def test_chip_smoke_plan_layouts_and_their_bodies():
    """The plan phases' layouts of the four budget plans: the 10 that no
    earlier phase holds, the compact projections each run trains, and the
    one layout whose bodies leave the tensor cores (qwen2-moe's
    ``experts.out`` at 0.875: dX at transposed G 8, dW at C 8)."""
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke

    plans = {}
    for arch in chip_smoke.PLAN_ARCHS:
        cfg, shapes, plan = chip_smoke.budget_plan(arch)
        want, _ = _both(_tables(arch)[0], _tables(arch)[0],
                        target_density=0.25, min_dim=64)
        assert plan.fingerprint() == want.fingerprint()
        plans[arch] = dict(layouts=chip_smoke.plan_layouts(arch, shapes,
                                                           plan))
    held = chip_smoke.held_layouts()
    new = [(a, e["m"], e["k"], e["sparsity"]) for a, p in plans.items()
           for e in p["layouts"] if (e["m"], e["k"], e["sparsity"])
           not in held]
    assert len(new) == 10
    assert chip_smoke.fma_layouts(plans) == [
        ("qwen2-moe-a2.7b", 2048, 1408, 0.875, "dX", 8, 16),
        ("qwen2-moe-a2.7b", 2048, 1408, 0.875, "dW", 16, 8)]
    assert [chip_smoke.n_plan_compact(plans, a) for a in
            chip_smoke.PLAN_ARCHS] == [110, 0, 9, 23]
