"""Sharded training on four gloo processes (CPU), float32.

One child run spawns four ranks on a ``file://`` store.  For every
architecture and storage that ``shard_module`` takes -- tinyllama in
compact, masked and chain storage and under a plan that routes the
attention to the ``xla_compact`` backend and the MLP to ``pallas`` (the
shares keep their layers' backends), qwen2-moe's expert-parallel experts,
deepseek-v2's MLA, pixtral-12b with patch embeddings, musicgen-medium's
codebooks, a vocabulary of 1024 (tinyllama dense, gemma-7b's tied head)
so that the vocabulary-parallel embedding, head and cross-entropy train
(musicgen's 3 codebooks put a codebook's boundary inside a rank's head
rows), and gemma3-4b at 2 q heads, which model 4 does not divide -- and
on
the meshes (data, model) = (1, 4) and (2, 2), each rank runs the port's
``make_train_step`` on ``shard_module``'s share of a reduced model, fed
its data rank's rows of the global batch (``host_shard``).  At (2, 2) the
weights the spec cuts over "data" are FSDP'd: each rank holds its data
share of them (and of their masters and momentum), gathered whole where
they are read, their gradients reduce-scattered in rank order:

  * after one step of sgdm (momentum buffer = the step's gradient: no
    clip, no weight decay), every rank's gradient of each share equals
    that share of the unsharded model's gradient within 1e-5 * max|ref|.
    The unsharded model takes the same global batch as one microbatch a
    data rank (``microbatches``): its gradient is the mean of the data
    shards' gradients, which is the global batch's for the models without
    MoE, and what the reference's expert-parallel path takes for a MoE
    (one routing group and one load-balance loss a data shard,
    averaged).  gemma-7b's tied table is read twice (the embedding and
    the head), so under FSDP its share's gradient is two ordered
    reduce-scatters added together, which round differently from the
    unsharded model's one sum of the two reads: it is held to the same
    1e-5 * max|ref|, not to the bit;
  * for tinyllama in masked and compact storage, qwen2-moe's
    expert-parallel experts, deepseek-v2's MLA and musicgen's codebooks
    (the compact shares' dX on ``RankSlice.transpose``, ``to_ranks`` in
    the MoE and MLA layers, the vocabulary-parallel cross-entropy across a
    codebook's boundary), the shares also equal the reference's
    ``jax.grad`` through the bridge, within 1e-4 * max|ref|: of the
    global batch at data 1, the mean of the two halves' at data 2 (one
    routing group a data shard, as above);
  * before the step, one backward of the sharded loss leaves no trainable
    share without a gradient (``.grad`` None would mean a collective
    without a backward);
  * two steps with clip 1.0 give the unsharded run's losses within 1e-5
    relative, and every tensor the spec does not split over "model",
    gathered whole over the data ranks where FSDP cut it, is equal on all
    four ranks after them.

The reference runs here, in the test process; the ranks import only torch
and the port.
"""
import json
import os
import pickle
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import apply_sparsity as j_apply_sparsity
from repro.configs import get_config as j_get_config
from repro.configs import reduce_config as j_reduce_config
from repro.models import LMModel as JLMModel
from repro.utils import merge_trees, split_trainable

from test_torch_model import jax_tree_to_numpy
from test_torch_serve_sharded import run_ranks

ROOT = Path(__file__).resolve().parents[1]
RTOL, JAX_RTOL, LOSS_RTOL = 1e-5, 1e-4, 1e-5
B, S = 4, 8
MESHES = [(1, 4), (2, 2)]
# (name, arch, storage, config fields replaced)
CASES = [
    ("tinyllama-compact", "tinyllama-1.1b", "auto", {}),
    ("tinyllama-masked", "tinyllama-1.1b", "xla_masked", {}),
    ("tinyllama-chain", "tinyllama-1.1b", "chain", {}),
    # a plan's per-layer backends: attention on the plain-torch gather of
    # the shares' cut tables, the MLP on the kernels' plain versions
    ("tinyllama-routed", "tinyllama-1.1b", "routed", {}),
    ("tinyllama-dense-vocab", "tinyllama-1.1b", "dense",
     {"vocab_size": 1024}),
    ("gemma-7b-tied", "gemma-7b", "auto", {"vocab_size": 1024}),
    # 2 q heads over model 4: every rank runs both (wq's rows gathered)
    ("gemma3-4b-q-gather", "gemma3-4b", "auto",
     {"n_heads": 2, "n_kv_heads": 1}),
    ("qwen2-moe-compact", "qwen2-moe-a2.7b", "auto", {}),
    ("deepseek-v2-compact", "deepseek-v2-236b", "auto", {}),
    ("pixtral-compact", "pixtral-12b", "auto", {}),
    # 3 codebooks of 128: a rank's head rows cross a codebook at model 4
    ("musicgen-compact", "musicgen-medium", "auto", {"n_codebooks": 3}),
]
JAX_CASES = ("tinyllama-masked", "tinyllama-compact", "qwen2-moe-compact",
             "deepseek-v2-compact", "musicgen-compact")
CHAIN = dict(pattern="rbgp", sparsity=0.875, backend="auto",
             factors=(("complete", 2, 2, 0.0), ("ramanujan", 0, 0, -1.0),
                      ("ramanujan", 0, 0, -1.0), ("ramanujan", 0, 0, -1.0),
                      ("complete", 2, 2, 0.0)), min_dim=64)

CHILD = r'''
import hashlib, json, os, pickle, sys
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def config(arch, storage, fields, chain):
    from repro_torch.configs import apply_sparsity, get_config, reduce_config
    from repro_torch.sparsity import PatternSpec, PlanRule, SparsityPlan
    cfg = reduce_config(get_config(arch))
    if storage == "dense":
        cfg = apply_sparsity(cfg, pattern="dense")
    elif storage == "chain":
        cfg = apply_sparsity(cfg, plan=SparsityPlan(
            rules=(PlanRule(".*", PatternSpec(**chain)),)))
    elif storage == "routed":
        cfg = apply_sparsity(cfg, plan=SparsityPlan(rules=tuple(
            PlanRule(rf"l\d+\.{part}\..*", PatternSpec(
                pattern="rbgp4", sparsity=0.5, backend=b, min_dim=64))
            for part, b in (("attn", "xla_compact"), ("mlp", "pallas")))))
    else:
        cfg = apply_sparsity(cfg, pattern="rbgp4", sparsity=0.5,
                             backend=storage, min_dim=64)
    return cfg.with_(**fields)


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
    from repro_torch.launch.mesh import make_serve_mesh
    from repro_torch.models import LMModel
    from repro_torch.parallel import gather_cat, gather_sum, shard_module
    from repro_torch.parallel.sharding import data_axis
    from repro_torch.sparsity import get_backend
    from repro_torch.train import init_train_state, make_train_step

    with open(os.path.join(work, "cases.pkl"), "rb") as f:
        cases = pickle.load(f)
    res = {}

    def model_of(c, cfg):
        m = LMModel(cfg, device="cpu", seed=0)
        if c["tree"] is not None:
            load_jax_params(m, c["tree"])
        return m

    def run(c, dims):
        cfg = config(c["arch"], c["storage"], c["fields"], cases["__chain__"])
        dp = dims[0]
        batch = {k: torch.as_tensor(v) for k, v in c["batch"].items()}
        tc = dict(optimizer="sgdm", lr=0.05, momentum=0.9, weight_decay=0.0,
                  schedule="constant")
        mesh = make_serve_mesh(*dims)
        d = mesh.get_local_rank("data")
        lo, n = host_shard(batch["tokens"].shape[0], d, dp)
        local = {k: v[lo:lo + n] for k, v in batch.items()}
        micro = batch if dp == 1 else {
            k: v.reshape(dp, -1, *v.shape[1:]) for k, v in batch.items()}
        out = {}

        # the unsharded model's gradient: one microbatch a data shard
        ref = model_of(c, cfg)
        tcfg = TrainConfig(grad_clip=0.0, microbatches=dp, **tc)
        st = init_train_state(ref, tcfg)
        make_train_step(ref, tcfg)(st, micro)
        want = st.opt_state["m"]
        scale = max(float(g.abs().max()) for g in want.values())

        m = shard_module(model_of(c, cfg), mesh)
        tcfg = TrainConfig(grad_clip=0.0, **tc)
        st = init_train_state(m, tcfg)
        # the backend each compact share runs on, and the calls of
        # xla_compact in one forward and backward
        xc = get_backend("xla_compact")
        calls = []
        xc.linear = lambda w, x: (calls.append(1),
                                  type(xc).linear(xc, w, x))[1]
        loss, _ = m.loss(local, train=True)
        loss.backward()
        del xc.linear
        out["xla_compact_calls"] = len(calls)
        out["share_backends"] = sorted({
            (lin.name.split(".")[1], lin.backend_name)
            for lin in m.modules() if getattr(lin, "share", None) is not None})
        out["none_grads"] = [k for k, p in m.named_parameters()
                             if p.requires_grad and p.grad is None]
        for p in m.parameters():
            p.grad = None
        make_train_step(m, tcfg)(st, local)
        got = st.opt_state["m"]
        errs = {k: float((g - cut(want[k], m.rank_slices.get(k))).abs().max())
                / scale for k, g in got.items()}
        out["grad_err"] = max(errs.values())
        out["worst"] = max(errs, key=errs.get)
        out["names"] = sorted(got) == sorted(want)
        out["n_split"] = sum(p.model_split for p in m.placements.values())
        if c["jax_grads"] is not None:
            jg = {k: torch.as_tensor(v)
                  for k, v in c["jax_grads"][dp].items()}
            jscale = max(float(g.abs().max()) for g in jg.values())
            out["jax_err"] = max(
                float((g - cut(jg[k], m.rank_slices.get(k))).abs().max())
                for k, g in got.items()) / jscale
            out["jax_names"] = sorted(got) == sorted(jg)

        # two steps with clipping: losses, and the replicated tensors equal
        # on every rank
        tcfg = TrainConfig(grad_clip=1.0, microbatches=dp, **tc)
        ref = model_of(c, cfg)
        st, step = init_train_state(ref, tcfg), make_train_step(ref, tcfg)
        want_losses = [float(step(st, micro)[1]["loss"]) for _ in range(2)]
        tcfg = TrainConfig(grad_clip=1.0, **tc)
        m = shard_module(model_of(c, cfg), mesh)
        st, step = init_train_state(m, tcfg), make_train_step(m, tcfg)
        dax = data_axis(mesh)
        losses = []
        for _ in range(2):
            l = step(st, local)[1]["loss"].reshape(1)
            losses.append(float(gather_sum(l, dax)[0]) / dax.size)
        out["loss_err"] = max(abs(a - b) / abs(b)
                              for a, b in zip(losses, want_losses))

        def whole(k, t):
            # a tensor not split over "model" is cut, if at all, over the
            # data axes only
            for dim, _, _ in m.placements[k].cut or ():
                t = gather_cat(t.contiguous(), m.data_axis, dim)
            return t

        with torch.no_grad():
            out["replicated"] = {
                k: hashlib.sha1(whole(k, t.detach()).contiguous().numpy()
                                .tobytes()).hexdigest()
                for k, t in m.state_dict().items()
                if k in m.placements and not m.placements[k].model_split
                and t.is_floating_point()}
        out["n_fsdp"] = sum(p.data_split for p in m.placements.values())
        return out

    for c in cases["__cases__"]:
        for dims in cases["__meshes__"]:
            res[f"{c['name']}|{dims[0]}x{dims[1]}"] = run(c, dims)
    with open(os.path.join(work, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    dist.destroy_process_group()


if __name__ == "__main__":
    work = sys.argv[1]
    mp.spawn(rank_main, args=(4, os.path.join(work, "store"), work),
             nprocs=4)
'''


def reference_config(arch, storage, fields):
    cfg = j_reduce_config(j_get_config(arch))
    cfg = j_apply_sparsity(cfg, pattern="rbgp4", sparsity=0.5,
                           backend=storage, min_dim=64)
    return cfg.with_(**fields)


def batch_of(arch, fields, seed=1):
    from repro_torch.configs import get_config, reduce_config

    cfg = reduce_config(get_config(arch)).with_(**fields)
    rng = np.random.default_rng(seed)
    tail = (cfg.n_codebooks,) if cfg.n_codebooks > 1 else ()
    batch = {"tokens": rng.integers(0, cfg.vocab_size,
                                    (B, S) + tail).astype(np.int32)}
    if cfg.frontend == "vision":
        batch["patch_embeds"] = rng.standard_normal(
            (B, cfg.n_patches, cfg.d_model)).astype(np.float32)
    return batch


def jax_case(arch, storage, fields, batch):
    """The reference's weights (numpy tree) and, by data-axis size, its
    ``jax.grad`` of the loss flattened to the port's names: of the global
    batch for 1, the mean of the data shards' for more."""
    from repro_torch.bridge import flatten_jax_tree
    from repro_torch.configs import get_config, reduce_config

    cfg = reference_config(arch, storage, fields)
    jm = JLMModel(cfg)
    params = jm.init(jax.random.PRNGKey(0))
    train, static = split_trainable(params)

    def loss_fn(t, b):
        return jm.loss(merge_trees(t, static), b, train=True)[0]

    grad = jax.jit(jax.grad(loss_fn))
    port_cfg = reduce_config(get_config(arch)).with_(**fields)
    by_dp = {}
    for dp in sorted({d for d, _ in MESHES}):
        shards = [{k: jnp.asarray(v.reshape(dp, -1, *v.shape[1:])[i])
                   for k, v in batch.items()} for i in range(dp)]
        grads = jax.tree_util.tree_map(
            lambda *g: sum(g) / dp, *[grad(train, b) for b in shards])
        by_dp[dp] = flatten_jax_tree(port_cfg, jax_tree_to_numpy(grads))
    return jax_tree_to_numpy(params), by_dp


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    work = tmp_path_factory.mktemp("train_sharded")
    cases = {"__meshes__": MESHES, "__chain__": CHAIN, "__cases__": []}
    for name, arch, storage, fields in CASES:
        batch = batch_of(arch, fields)
        tree = grads = None
        if name in JAX_CASES:
            tree, grads = jax_case(arch, storage, fields, batch)
        cases["__cases__"].append(dict(
            name=name, arch=arch, storage=storage, fields=fields,
            batch=batch, tree=tree, jax_grads=grads))
    with open(work / "cases.pkl", "wb") as f:
        pickle.dump(cases, f)
    (work / "child.py").write_text(CHILD)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    out, err, rc = run_ranks([sys.executable, str(work / "child.py"),
                              str(work)], env, timeout=600)
    assert rc == 0, out[-3000:] + err[-6000:]
    res = []
    for r in range(4):
        with open(work / f"rank{r}.json") as f:
            res.append(json.load(f))
    return res


KEYS = [f"{c[0]}|{d[0]}x{d[1]}" for c in CASES for d in MESHES]


@pytest.mark.parametrize("key", KEYS)
def test_every_share_gets_the_unsharded_models_gradient(ranks, key):
    for r, res in enumerate(ranks):
        got = res[key]
        assert got["names"], (r, key)
        assert got["n_split"] > 0, (r, key)
        assert got["none_grads"] == [], (r, got["none_grads"])
        assert got["grad_err"] <= RTOL, (r, got["worst"], got["grad_err"])
        # the spec's data entries cut weights (FSDP; at data 1 the cut is
        # the whole and the gathers run over a group of one)
        assert got["n_fsdp"] > 0, (r, key)


@pytest.mark.parametrize("dims", MESHES)
def test_tinyllama_shares_match_the_references_jax_grad(ranks, dims):
    key = f"{JAX_CASES[0]}|{dims[0]}x{dims[1]}"
    for r, res in enumerate(ranks):
        assert res[key]["jax_names"], r
        assert res[key]["jax_err"] <= JAX_RTOL, (r, res[key]["jax_err"])


JAX_KEYS = [f"{c}|{d[0]}x{d[1]}" for c in JAX_CASES[1:] for d in MESHES]


@pytest.mark.parametrize("key", JAX_KEYS)
def test_shares_match_the_references_jax_grad(ranks, key):
    """Compact shares (dX on ``RankSlice.transpose``), MoE and MLA
    (``to_ranks``) and codebooks (a vocabulary-parallel loss across a
    codebook's boundary) against the reference's ``jax.grad``."""
    for r, res in enumerate(ranks):
        assert res[key]["jax_names"], r
        assert res[key]["jax_err"] <= JAX_RTOL, (r, res[key]["jax_err"])


@pytest.mark.parametrize("dims", MESHES)
def test_routed_shares_run_their_layers_backends(ranks, dims):
    """Under the attention -> xla_compact, MLP -> pallas plan every compact
    share keeps its layer's backend, and the attention shares' products
    run on the plain-torch gather of their cut tables (their gradients
    are held by the tests above)."""
    key = f"tinyllama-routed|{dims[0]}x{dims[1]}"
    for r, res in enumerate(ranks):
        assert res[key]["share_backends"] == [["attn", "xla_compact"],
                                              ["mlp", "pallas"]], r
        assert res[key]["xla_compact_calls"] > 0, r
        plain = f"tinyllama-compact|{dims[0]}x{dims[1]}"
        assert res[plain]["xla_compact_calls"] == 0, r


@pytest.mark.parametrize("key", KEYS)
def test_two_clipped_steps_match_and_keep_replicas_equal(ranks, key):
    for r, res in enumerate(ranks):
        assert res[key]["loss_err"] <= LOSS_RTOL, (r, res[key]["loss_err"])
    want = ranks[0][key]["replicated"]
    assert want
    for r, res in enumerate(ranks[1:], 1):
        assert res[key]["replicated"] == want, (r, key)
