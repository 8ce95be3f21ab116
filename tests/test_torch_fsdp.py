"""FSDP over the data axes on four gloo processes (CPU).

``shard_module`` cuts every weight whose spec has a data entry (the
reference's ``'F'``: "data", or "pod" and "data" flattened pod-major) to
this data rank's share; the reads gather it whole (``gather_on_use``),
whose backward is the ordered reduce-scatter.  One child run spawns four
ranks on a ``file://`` store:

  * ``reduce_scatter_ordered`` of random float32 and bfloat16 tensors,
    along each dim, is bit-equal to this rank's chunk of ``gather_sum``
    (the rank-ordered float32 sum every sum over ranks takes);
  * for every reduced language model that ``shard_module`` takes (compact
    storage; tinyllama and qwen2-moe masked too), on the meshes
    {"data": 2, "model": 2}, {"data": 4, "model": 1} and {"pod": 2,
    "data": 2, "model": 1}, every parameter's placement equals the
    reference's ``param_spec`` of its path (imported here, on a stand-in
    mesh of the axis sizes), data entries included; a dim the axes do not
    divide stays whole; each rank holds exactly its spec share of every
    weight (the unsharded model's tensor cut by ``rank_slices``, each cut
    the contiguous share of its axis coordinate) and of its float32
    master and momentum;
  * the reference's ``jax.grad`` of reduced tinyllama (compact) and
    qwen2-moe (compact experts) at (data, model) = (4, 1): each rank's
    sgdm momentum after one step (no clip, no decay: the mean of the data
    shards' gradients) equals its share of the mean of the reference's
    four shards' gradients, through the bridge's cuts, within 1e-4 *
    max|ref|.

The reference runs here, in the test process; the ranks import only torch
and the port.
"""
import json
import os
import pickle
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.models import LMModel as JLMModel
from repro.parallel.sharding import param_spec as j_param_spec
from repro.utils import merge_trees, split_trainable

from test_torch_model import jax_tree_to_numpy
from test_torch_serve_sharded import run_ranks
from test_torch_train_sharded import batch_of, reference_config

ROOT = Path(__file__).resolve().parents[1]
JAX_RTOL = 1e-4
MESHES = {"data2-model2": {"data": 2, "model": 2},
          "data4-model1": {"data": 4, "model": 1},
          "pod2-data2-model1": {"pod": 2, "data": 2, "model": 1}}
# every arch shard_module takes (the recurrent ones it refuses)
ARCHS = ["tinyllama-1.1b", "gemma-7b", "gemma3-4b", "deepseek-7b",
         "pixtral-12b", "deepseek-v2-236b", "qwen2-moe-a2.7b",
         "musicgen-medium"]
TREES = [(a, "auto") for a in ARCHS] + [
    (a, "xla_masked") for a in ("tinyllama-1.1b", "qwen2-moe-a2.7b")]
GRAD_CASES = [("tinyllama-1.1b", "auto"), ("qwen2-moe-a2.7b", "auto")]
N_RS = 6   # random tensors a dtype for the reduce-scatter check

CHILD = r'''
import json, os, pickle, sys
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def config(arch, storage):
    from repro_torch.configs import apply_sparsity, get_config, reduce_config
    return apply_sparsity(reduce_config(get_config(arch)), pattern="rbgp4",
                          sparsity=0.5, backend=storage, min_dim=64)


def mesh_of(sizes):
    from torch.distributed.device_mesh import DeviceMesh
    shape = tuple(sizes.values())
    return DeviceMesh("cpu", torch.arange(4).reshape(shape),
                      mesh_dim_names=tuple(sizes))


def cut(full, where):
    for dim, index in where or ():
        full = full.index_select(dim, torch.as_tensor(list(index)))
    return full


def rank_main(rank, world, store, work):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=120))
    from repro_torch.bridge import load_jax_params
    from repro_torch.configs import TrainConfig
    from repro_torch.data import host_shard
    from repro_torch.models import LMModel
    from repro_torch.parallel import (COLLECTIVES, MeshAxis, gather_sum,
                                      reduce_scatter_ordered, shard_module)
    from repro_torch.train import init_train_state, make_train_step

    with open(os.path.join(work, "cases.pkl"), "rb") as f:
        cases = pickle.load(f)
    res = {"rs": [], "placements": {}, "grads": {}}

    # the ordered reduce-scatter against gather_sum's chunk
    world_axis = MeshAxis(None, rank, world)
    # the shapes alike on every rank, the values a rank's own
    shapes = torch.Generator().manual_seed(100)
    values = torch.Generator().manual_seed(200 + rank)
    for dtype in (torch.float32, torch.bfloat16):
        for i in range(cases["__n_rs__"]):
            shape = [int(n) for n in torch.randint(1, 5, (3,),
                                                   generator=shapes)]
            dim = i % 3
            shape[dim] *= world
            t = (torch.randn(shape, generator=values)
                 * 10 ** (i % 4)).to(dtype)
            w = shape[dim] // world
            want = gather_sum(t, world_axis).narrow(dim, rank * w, w)
            got = reduce_scatter_ordered(t, world_axis, dim)
            res["rs"].append([str(dtype), shape, dim,
                              bool(torch.equal(got, want)),
                              list(got.shape) == list(want.shape)])

    # placements, shares, masters and momentum
    tc = TrainConfig(optimizer="sgdm", lr=0.05, momentum=0.9,
                     weight_decay=0.0, schedule="constant", grad_clip=0.0)
    for arch, storage in cases["__trees__"]:
        cfg = config(arch, storage)
        full = LMModel(cfg, device="cpu", seed=0).state_dict()
        for mname, sizes in cases["__meshes__"].items():
            mesh = mesh_of(sizes)
            m = shard_module(LMModel(cfg, device="cpu", seed=0), mesh)
            coords = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
            state = m.state_dict()
            st = init_train_state(m, tc)
            out = {}
            for name, p in m.placements.items():
                local = state[name]
                held = bool(torch.equal(cut(full[name],
                                            m.rank_slices.get(name)),
                                        local))
                master = st.params.get(name)
                mom = st.opt_state["m"].get(name)
                out[name] = {
                    "spec": [list(a) if isinstance(a, tuple) else a
                             for a in p.spec],
                    "cut": [list(c) for c in p.cut or ()],
                    "shape": list(local.shape),
                    "full": list(full[name].shape),
                    "held": held,
                    "state": None if master is None else [
                        list(master.shape), list(mom.shape),
                        bool(torch.equal(master, local.float()))]}
            res["placements"][f"{arch}|{storage}|{mname}"] = {
                "coords": coords, "leaves": out,
                "data_rank": m.data_axis.rank}

    # one sgdm step at (4, 1) against the reference's jax.grad
    for key, c in cases["__grads__"].items():
        cfg = config(c["arch"], c["storage"])
        mesh = mesh_of({"data": 4, "model": 1})
        m = shard_module(LMModel(cfg, device="cpu", seed=0), mesh)
        load_jax_params(m, c["tree"])
        batch = {k: torch.as_tensor(v) for k, v in c["batch"].items()}
        lo, n = host_shard(batch["tokens"].shape[0], m.data_axis.rank, 4)
        st = init_train_state(m, tc)
        from repro_torch.parallel import reset_collectives
        reset_collectives()
        make_train_step(m, tc)(st, {k: v[lo:lo + n]
                                    for k, v in batch.items()})
        jg = {k: torch.as_tensor(v) for k, v in c["jax_grads"].items()}
        scale = max(float(v.abs().max()) for v in jg.values())
        errs = {k: float((v - cut(jg[k], m.rank_slices.get(k))).abs().max())
                / scale for k, v in st.opt_state["m"].items()}
        worst = max(errs, key=errs.get)
        res["grads"][key] = {
            "err": errs[worst], "worst": worst,
            "names": sorted(errs) == sorted(jg),
            "n_fsdp": sum(p.data_split for p in m.placements.values()),
            "collectives": dict(COLLECTIVES)}
    with open(os.path.join(work, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    dist.destroy_process_group()


if __name__ == "__main__":
    work = sys.argv[1]
    mp.spawn(rank_main, args=(4, os.path.join(work, "store"), work),
             nprocs=4)
'''


def jax_grads(arch, storage, batch, dp=4):
    """The reference's weights (numpy) and the mean of its ``jax.grad`` of
    the loss over ``dp`` equal shards of ``batch``, by the port's
    names."""
    from repro_torch.bridge import flatten_jax_tree
    from repro_torch.configs import get_config, reduce_config

    cfg = reference_config(arch, storage, {})
    jm = JLMModel(cfg)
    params = jm.init(jax.random.PRNGKey(0))
    train, static = split_trainable(params)

    def loss_fn(t, b):
        return jm.loss(merge_trees(t, static), b, train=True)[0]

    grad = jax.jit(jax.grad(loss_fn))
    shards = [{k: jnp.asarray(v.reshape(dp, -1, *v.shape[1:])[i])
               for k, v in batch.items()} for i in range(dp)]
    grads = jax.tree_util.tree_map(lambda *g: sum(g) / dp,
                                   *[grad(train, b) for b in shards])
    return jax_tree_to_numpy(params), flatten_jax_tree(
        reduce_config(get_config(arch)), jax_tree_to_numpy(grads))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    work = tmp_path_factory.mktemp("fsdp")
    cases = {"__n_rs__": N_RS, "__trees__": TREES, "__meshes__": MESHES,
             "__grads__": {}}
    for arch, storage in GRAD_CASES:
        batch = batch_of(arch, {})
        tree, grads = jax_grads(arch, storage, batch)
        cases["__grads__"][f"{arch}|{storage}"] = dict(
            arch=arch, storage=storage, batch=batch, tree=tree,
            jax_grads=grads)
    with open(work / "cases.pkl", "wb") as f:
        pickle.dump(cases, f)
    (work / "child.py").write_text(CHILD)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    out, err, rc = run_ranks([sys.executable, str(work / "child.py"),
                              str(work)], env, timeout=300)
    assert rc == 0, out[-3000:] + err[-6000:]
    res = []
    for r in range(4):
        with open(work / f"rank{r}.json") as f:
            res.append(json.load(f))
    return res


@pytest.mark.parametrize("dtype", ["torch.float32", "torch.bfloat16"])
def test_ordered_reduce_scatter_is_gather_sums_chunk_bit_for_bit(ranks,
                                                                 dtype):
    for r, res in enumerate(ranks):
        got = [x for x in res["rs"] if x[0] == dtype]
        assert len(got) == N_RS
        for _, shape, dim, equal, same_shape in got:
            assert same_shape and equal, (r, dtype, shape, dim)


def reference_spec(path: str, scanned: bool, shape, sizes) -> list:
    """The reference's ``param_spec`` of a leaf (a scanned one with its
    leading period dim, dropped from the result) on a stand-in mesh of
    the axis sizes, canonical (tuples as lists)."""
    mesh = types.SimpleNamespace(axis_names=tuple(sizes), shape=sizes)
    spec = tuple(j_param_spec(path, (1, *shape) if scanned
                              else tuple(shape), mesh))
    if scanned:
        spec = spec[1:]
    return [list(a) if isinstance(a, tuple) else a for a in spec]


def _names(ax) -> list:
    return [] if ax is None else ([ax] if isinstance(ax, str) else ax)


PLACEMENT_KEYS = [(f"{a}|{s}", m) for a, s in TREES for m in MESHES]


@pytest.mark.parametrize("tree,mesh_name", PLACEMENT_KEYS,
                         ids=[f"{t}-{m}" for t, m in PLACEMENT_KEYS])
def test_placements_equal_the_reference_and_each_rank_holds_its_share(
        ranks, tree, mesh_name):
    """Every placement, data entries included, is the reference's spec;
    each cut is the contiguous share of the rank's coordinate along the
    axes its dim names (pod-major for the flattened data axes), a dim no
    axis cuts is whole, and the rank holds exactly that share of the
    weight, its master and its momentum."""
    from repro_torch.configs import get_config, reduce_config
    from repro_torch.parallel import reference_path

    arch, storage = tree.split("|")
    cfg = reduce_config(get_config(arch))
    sizes = MESHES[mesh_name]
    n_data = 0
    for r, res in enumerate(ranks):
        got = res["placements"][f"{tree}|{mesh_name}"]
        coords = got["coords"]
        for name, leaf in got["leaves"].items():
            path, scanned = reference_path(cfg, name)
            want = reference_spec(path, scanned, leaf["full"], sizes)
            assert leaf["spec"] == want, (r, name, leaf["spec"], want)
            cuts = {d: (lo, hi) for d, lo, hi in leaf["cut"]}
            for d, (ax, n_full) in enumerate(zip(leaf["spec"],
                                                 leaf["full"])):
                axes = _names(ax)
                if not axes:
                    assert d not in cuts and leaf["shape"][d] == n_full, \
                        (r, name, d)
                    continue
                n = int(np.prod([sizes[a] for a in axes]))
                idx = 0
                for a in axes:
                    idx = idx * sizes[a] + coords[a]
                w = n_full // n
                assert n_full % n == 0 and leaf["shape"][d] == w, \
                    (r, name, d, leaf["shape"], n_full, n)
                if n > 1:
                    assert cuts[d] == (idx * w, (idx + 1) * w), \
                        (r, name, d, cuts[d], idx, w)
                n_data += any(a in ("pod", "data") for a in axes) and n > 1
            assert leaf["held"], (r, name)
            if leaf["state"] is not None:
                master, mom, equal = leaf["state"]
                assert master == mom == leaf["shape"] and equal, (r, name)
    # the data axes cut something on every mesh (each has data size > 1)
    assert n_data > 0


@pytest.mark.parametrize("case", [f"{a}|{s}" for a, s in GRAD_CASES])
def test_fsdp_step_matches_the_references_jax_grad_at_data_4(ranks, case):
    for r, res in enumerate(ranks):
        got = res["grads"][case]
        assert got["names"], r
        assert got["n_fsdp"] > 0, r
        assert got["collectives"]["gather_on_use"] > 0, r
        assert got["collectives"]["reduce_scatter"] > 0, r
        assert got["err"] <= JAX_RTOL, (r, got["worst"], got["err"])
