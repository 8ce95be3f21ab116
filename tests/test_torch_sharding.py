"""The port's sharding rules equal the reference's.

The reference's specs come from a subprocess on 8 forced host devices
(``XLA_FLAGS=--xla_force_host_platform_device_count=8``, latched at jax's
first import, as ``tests/test_sharding.py`` does), over three meshes:
(2, 2, 2) ``pod/data/model``, (1, 4) and (2, 2) ``data/model``.  For
every parameter of every reduced language model (and tinyllama's and
qwen2-moe's masked and int8 trees, and tinyllama's under a deep-chain
plan, in chain and int8 storage), the port's ``param_spec`` equals the
reference's ``PartitionSpec``; so do ``dp_axes``, ``batch_specs``,
``cache_specs`` (the scan offset), ``page_pool_specs`` and the
activation-constraint resolution of ``parallel.shard`` (the constraint the
reference's ``shard`` asks for).  The port's
parameter names map onto the reference's paths (``reference_path``, the
map the weight bridge loads by) with the reference's shapes.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.configs import get_config, list_archs, reduce_config
from repro_torch.models import LMModel
from repro_torch.parallel import (activation_mesh, batch_specs, cache_specs,
                                  dp_axes, page_pool_specs, param_spec,
                                  port_spec, reference_path, shard)

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
MESHES = {"pod2-data2-model2": {"pod": 2, "data": 2, "model": 2},
          "data1-model4": {"data": 1, "model": 4},
          "data2-model2": {"data": 2, "model": 2}}
# (arch, storage): every reduced LM in compact storage, two in the masked
# and int8 storages, and tinyllama under the deep-chain plan (chain storage
# and its int8 form)
TREES = ([(a, "auto") for a in list_archs(lm_only=True)]
         + [(a, s) for a in ("tinyllama-1.1b", "qwen2-moe-a2.7b")
            for s in ("xla_masked", "int8")]
         + [("tinyllama-1.1b", s) for s in ("chain", "chain-int8")])
CHAIN_TREES = [f"{a}|{s}" for a, s in TREES if s.startswith("chain")]
# the deep-chain plan of tests/test_torch_chain_model.py
CHAIN = dict(pattern="rbgp", sparsity=0.875, backend="auto",
             factors=[["complete", 2, 2, 0.0], ["ramanujan", 0, 0, -1.0],
                      ["ramanujan", 0, 0, -1.0], ["ramanujan", 0, 0, -1.0],
                      ["complete", 2, 2, 0.0]], min_dim=64)
CONSTRAINTS = [((8, 4, 16), ("dp", None, "tp")),
               ((8, 3, 4), ("dp", "tp", None)),
               ((6, 8, 8), ("dp", "tp", "tp")),
               ((2, 16), ("tp", "dp")),
               ((4, 4, 2, 8), (None, "dp", "tp", None))]

CHILD = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, jax.numpy as jnp
from jax.sharding import AxisType
from repro.configs import apply_sparsity, get_config, reduce_config
from repro.models import LMModel
from repro.parallel.constrain import activation_mesh, shard
from repro.parallel.sharding import (batch_specs, cache_specs, dp_axes,
                                     page_pool_specs, param_spec)
from repro.sparsity import PatternSpec, PlanRule, SparsityPlan
from repro.sparsity import quantize_weights
from repro.utils import path_str

req = json.loads(sys.argv[1])
def mesh(sizes):
    return jax.make_mesh(tuple(sizes.values()), tuple(sizes),
                         axis_types=(AxisType.Auto,) * len(sizes))
def spec(s):
    return [list(a) if isinstance(a, tuple) else a for a in s]
def flat(tree):
    return {path_str(p): list(l.shape) for p, l in
            jax.tree_util.tree_flatten_with_path(tree)[0]}
def specs(tree):
    return {path_str(p): spec(l.spec) for p, l in
            jax.tree_util.tree_flatten_with_path(tree)[0]}
meshes = {k: mesh(v) for k, v in req["meshes"].items()}
out = {"trees": {}, "dp_axes": {}, "pools": {}, "caches": {}, "batch": {},
       "constraints": {}}
chain = dict(req["chain"], factors=tuple(map(tuple,
                                              req["chain"]["factors"])))
for arch, storage in req["trees"]:
    cfg = reduce_config(get_config(arch), sparsity_backend="auto")
    if storage.startswith("chain"):
        cfg = apply_sparsity(cfg, plan=SparsityPlan(
            rules=(PlanRule(".*", PatternSpec(**chain)),)))
    elif storage != "auto":
        cfg = apply_sparsity(cfg, pattern="rbgp4", sparsity=0.5,
                             backend="auto" if storage == "int8" else storage,
                             min_dim=64)
    m = LMModel(cfg)
    init = m.init
    if storage.endswith("int8"):
        init = lambda k: quantize_weights(m.init(k))
    shapes = flat(jax.eval_shape(init, jax.random.PRNGKey(0)))
    out["trees"][f"{arch}|{storage}"] = {
        "shapes": shapes,
        "specs": {k: {p: spec(param_spec(p, tuple(s), me))
                      for p, s in shapes.items()}
                  for k, me in meshes.items()}}
for k, me in meshes.items():
    d = dp_axes(me)
    out["dp_axes"][k] = list(d) if isinstance(d, tuple) else d
    for arch in ("tinyllama-1.1b", "qwen2-moe-a2.7b", "gemma3-4b"):
        m = LMModel(reduce_config(get_config(arch)))
        pools = jax.eval_shape(lambda: m.init_pages(9, 4, jnp.float32))
        out["pools"][f"{k}|{arch}"] = {"shapes": flat(pools),
            "specs": specs(page_pool_specs(pools, me))}
        for lc in (False, True):
            for B, L in ((8, 16), (1, 8192)):
                c = jax.eval_shape(lambda: m.init_cache(B, L, jnp.float32))
                out["caches"][f"{k}|{arch}|{lc}|{B}x{L}"] = {
                    "shapes": flat(c),
                    "specs": specs(cache_specs(c, me, long_context=lc))}
    batch = {"tokens": jax.ShapeDtypeStruct((8, 16), jnp.int32),
             "odd": jax.ShapeDtypeStruct((3, 5), jnp.int32),
             "mask": jax.ShapeDtypeStruct((4,), jnp.float32)}
    for bs in (True, False):
        out["batch"][f"{k}|{bs}"] = {
            "shapes": flat(batch),
            "specs": specs(batch_specs(batch, me, batch_sharded=bs))}
    # the constraint shard() asks for (the NamedSharding it hands to
    # with_sharding_constraint), not the layout XLA reports back, which
    # drops axes of size 1
    asked = []
    real = jax.lax.with_sharding_constraint
    jax.lax.with_sharding_constraint = lambda x, s: asked.append(s) or x
    for i, (shape, sp) in enumerate(req["constraints"]):
        with activation_mesh(me):
            shard(jnp.ones(shape), *sp)
        out["constraints"][f"{k}|{i}"] = spec(asked[-1].spec)
    jax.lax.with_sharding_constraint = real
print("SPECS-JSON", json.dumps(out))
"""


def canon(spec):
    return [list(a) if isinstance(a, tuple) else a for a in spec]


def nest(flat: dict):
    """{'a/0/b': shape} -> nested dicts and lists, leaves shape tuples."""
    root: dict = {}
    for path, shape in flat.items():
        node, parts = root, path.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = tuple(shape)

    def lists(node):
        if isinstance(node, dict):
            if node and all(k.isdigit() for k in node):
                return [lists(node[str(i)]) for i in range(len(node))]
            return {k: lists(v) for k, v in node.items()}
        return node
    return lists(root)


def flat_specs(tree, path=""):
    if isinstance(tree, tuple) and not any(isinstance(a, (dict, list))
                                           for a in tree):
        return {path: canon(tree)}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out = {}
    for k, v in items:
        out.update(flat_specs(v, f"{path}/{k}" if path else str(k)))
    return out


@pytest.fixture(scope="module")
def ref():
    req = {"meshes": MESHES, "trees": TREES, "chain": CHAIN,
           "constraints": [[list(s), list(sp)] for s, sp in CONSTRAINTS]}
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu")
    p = subprocess.run([sys.executable, "-c", CHILD, json.dumps(req)],
                       cwd=ROOT, env=env, capture_output=True, text=True,
                       timeout=600)
    assert p.returncode == 0, p.stdout[-2000:] + p.stderr[-4000:]
    line = next(l for l in p.stdout.splitlines()
                if l.startswith("SPECS-JSON "))
    return json.loads(line.split(" ", 1)[1])


@pytest.mark.parametrize("tree", [f"{a}|{s}" for a, s in TREES])
def test_param_specs_equal_the_reference_on_every_path(ref, tree):
    got = ref["trees"][tree]
    for mesh_name, sizes in MESHES.items():
        for path, shape in got["shapes"].items():
            want = got["specs"][mesh_name][path]
            assert canon(param_spec(path, tuple(shape), sizes)) == want, \
                (mesh_name, path, shape)


@pytest.mark.parametrize("arch", list_archs(lm_only=True))
def test_port_names_map_onto_the_reference_paths_and_specs(ref, arch):
    """Every port parameter names a reference leaf of its shape (a scanned
    leaf with the leading period dim), and ``port_spec`` is that leaf's
    spec over the port tensor's dims."""
    got = ref["trees"][f"{arch}|auto"]
    model = LMModel(reduce_config(get_config(arch)), device="meta")
    names = {n: tuple(t.shape) for n, t in model.state_dict().items()}
    seen = set()
    for name, shape in names.items():
        path, scanned = reference_path(model.cfg, name)
        assert path in got["shapes"], (name, path)
        seen.add(path)
        ref_shape = tuple(got["shapes"][path])
        assert (ref_shape[1:] if scanned else ref_shape) == shape, name
        for mesh_name, sizes in MESHES.items():
            want = got["specs"][mesh_name][path]
            assert canon(port_spec(model.cfg, name, shape, sizes)) == \
                (want[1:] if scanned else want), (mesh_name, name)
    assert seen == set(got["shapes"])


@pytest.mark.parametrize("tree", CHAIN_TREES)
def test_chain_tree_names_map_onto_the_reference_paths_and_specs(ref, tree):
    """The chain model's port names (``w_data``, or ``q_data`` and
    ``scales``) name the reference's chain leaves, and ``port_spec`` is
    their spec: wq, gate and up split their rows, wo and down their stored
    columns."""
    from repro_torch.configs import apply_sparsity
    from repro_torch.sparsity import (PatternSpec, PlanRule, SparsityPlan,
                                      quantize_weights)

    arch, storage = tree.split("|")
    got = ref["trees"][tree]
    spec = dict(CHAIN, factors=tuple(map(tuple, CHAIN["factors"])))
    cfg = apply_sparsity(reduce_config(get_config(arch)), plan=SparsityPlan(
        rules=(PlanRule(".*", PatternSpec(**spec)),)))
    model = LMModel(cfg, device="cpu")
    if storage.endswith("int8"):
        quantize_weights(model)
    names = {n: tuple(t.shape) for n, t in model.state_dict().items()}
    assert any(n.endswith(".mixer.wq.q_data" if storage.endswith("int8")
                          else ".mixer.wq.w_data") for n in names)
    seen = set()
    for name, shape in names.items():
        path, scanned = reference_path(model.cfg, name)
        seen.add(path)
        assert (tuple(got["shapes"][path])[1:] if scanned
                else tuple(got["shapes"][path])) == shape, name
        for mesh_name, sizes in MESHES.items():
            want = got["specs"][mesh_name][path]
            assert canon(port_spec(model.cfg, name, shape, sizes)) == \
                (want[1:] if scanned else want), (mesh_name, name)
    assert seen == set(got["shapes"])


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_dp_axes_and_batch_specs_equal_the_reference(ref, mesh_name):
    sizes = MESHES[mesh_name]
    d = dp_axes(sizes)
    assert canon([d])[0] == ref["dp_axes"][mesh_name]
    for bs in (True, False):
        want = ref["batch"][f"{mesh_name}|{bs}"]
        tree = nest(want["shapes"])
        assert flat_specs(batch_specs(tree, sizes, batch_sharded=bs)) == \
            want["specs"]


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_cache_and_pool_specs_equal_the_reference(ref, mesh_name):
    """The scanned caches' leading period dim shifts every spec by one;
    the pools shard only their heads dim."""
    sizes = MESHES[mesh_name]
    n = 0
    for key, want in ref["caches"].items():
        if not key.startswith(mesh_name + "|"):
            continue
        lc = key.split("|")[2] == "True"
        tree = nest(want["shapes"])
        assert flat_specs(cache_specs(tree, sizes, long_context=lc)) == \
            want["specs"], key
        n += 1
    for key, want in ref["pools"].items():
        if key.startswith(mesh_name + "|"):
            assert flat_specs(page_pool_specs(nest(want["shapes"]),
                                              sizes)) == want["specs"], key
            n += 1
    assert n == 15


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_constraint_resolution_equals_the_reference(ref, mesh_name):
    assert shard((4, 4), "dp") is None   # no mesh installed
    with activation_mesh(MESHES[mesh_name]):
        for i, (shape, sp) in enumerate(CONSTRAINTS):
            assert canon(shard(shape, *sp)) == \
                ref["constraints"][f"{mesh_name}|{i}"], (shape, sp)
