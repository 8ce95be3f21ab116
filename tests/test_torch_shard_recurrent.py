"""The sharded recurrent mixers (Mamba, RWKV-6) on four gloo processes (CPU).

``shard_module`` splits a Mamba mixer over its d_inner channels and an
RWKV block over its heads (``parallel.RecurrentShard``): each rank runs
the conv, the scan, the decay and the gates on its channels, its
projections cut by the reference's rules and its per-channel tensors
held whole.  One child run spawns four ranks on a ``file://`` store, for
reduced rwkv6-7b (d_model 64, 4 heads of 16; its two layers one scanned
period of the reference's) and reduced jamba (cut to 4 layers: three
Mamba layers and the attention layer, MoE on the odd ones; d_inner 128,
d_state 4, one kv head, 8 experts), rbgp4 compact, on the meshes
(data, model) = (1, 4) and (2, 2).  Each rank shards the model first and
then loads the reference's weights through the bridge (its
``rank_slices``).  Held:

  * after a prefill and two ``decode_step``s, every rank's logits within
    1e-5 * max|ref| of the reference's single-device model, and the
    caches, gathered whole over the model ranks, within the same of the
    reference's; a rank's held cache is its channels (Mamba's ``conv``
    (B, d_conv - 1, d_inner / n) and ``h`` (B, d_inner / n, d_state),
    RWKV's ``state`` (B, H / n, hs, hs), ``x_tm`` and ``x_cm`` whole);
  * at (1, 4) the ranks whose ``in`` rows are all of z (the spec cuts
    the concatenated [x; z] in contiguous rows) still give the right
    logits: the case a wrong channel slice fails;
  * after one sgdm step (momentum buffer = the step's gradient), every
    share's gradient within 1e-4 * max|ref| of the reference's
    ``jax.grad`` through the bridge (the mean of the data halves' at
    data 2), the per-channel tensors the spec replicates included, each
    the sum of the model ranks' parts;
  * after two clipped steps, every tensor the spec does not split over
    "model" (gathered whole over the data ranks where FSDP cut it) is
    equal on all four ranks;
  * every parameter's placement equals the reference's ``param_spec``;
  * in the test process, ``port_cache_specs`` of the recurrent caches
    equals the reference's ``cache_specs`` (standard and long-context
    cells, meshes (1, 4), (2, 2) and (4, 4)).

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
from repro.parallel import sharding as j_sharding

from test_torch_archs import jax_cache_by_layer
from test_torch_fsdp import reference_spec
from test_torch_serve_sharded import run_ranks
from test_torch_train_sharded import batch_of, jax_case, reference_config

ROOT = Path(__file__).resolve().parents[1]
RTOL, JAX_RTOL = 1e-5, 1e-4
MESHES = [(1, 4), (2, 2)]
# (name, arch, config fields replaced)
CASES = [("rwkv", "rwkv6-7b", {}),
         ("jamba", "jamba-1.5-large-398b", {"n_layers": 4})]
KEYS = [f"{c[0]}|{d[0]}x{d[1]}" for c in CASES for d in MESHES]
PROMPT, N_DECODE, CACHE_LEN = 6, 2, 16

CHILD = r'''
import hashlib, json, os, pickle, sys
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def config(arch, fields):
    from repro_torch.configs import apply_sparsity, get_config, reduce_config
    return apply_sparsity(reduce_config(get_config(arch)), pattern="rbgp4",
                          sparsity=0.5, backend="auto",
                          min_dim=64).with_(**fields)


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
    from repro_torch.parallel import gather_cat, shard_module
    from repro_torch.parallel.comm import MeshAxis

    with open(os.path.join(work, "cases.pkl"), "rb") as f:
        cases = pickle.load(f)

    def sharded(c, cfg, mesh):
        m = shard_module(LMModel(cfg, device="cpu", seed=0), mesh)
        load_jax_params(m, c["tree"])
        return m

    def run(c, dims):
        from repro_torch.train import init_train_state, make_train_step

        cfg = config(c["arch"], c["fields"])
        mesh = make_serve_mesh(*dims)
        model_ax = MeshAxis.of(mesh, "model")
        out = {}
        m = sharded(c, cfg, mesh)
        out["placements"] = {
            k: {"spec": [list(a) if isinstance(a, tuple) else a
                         for a in p.spec],
                "cut": [list(x) for x in p.cut or ()]}
            for k, p in m.placements.items()}
        out["full_shapes"] = {k: list(t.shape) for k, t in LMModel(
            cfg, device="meta").state_dict().items()}
        out["shards"] = {
            str(i): [lyr.kind, [t.lo, t.hi]]
            for i, lyr in enumerate(m.stack.layers)
            for t in [lyr.rwkv.tp if lyr.kind == "rwkv" else
                      getattr(lyr.mixer, "tp", None)]
            if lyr.kind in ("rwkv", "mamba")}

        # a prefill and two decode steps: logits, held and whole caches
        toks = torch.as_tensor(c["tokens"])
        B = toks.shape[0]
        whole = LMModel(cfg, device="meta").init_cache(B, cases["__len__"],
                                                       torch.float32)
        cache = m.init_cache(B, cases["__len__"], torch.float32)
        with torch.no_grad():
            logits = [m.prefill(toks[:, :cases["__prompt__"]], cache)[0]]
            for i in range(cases["__decode__"]):
                p = cases["__prompt__"] + i
                logits.append(m.decode_step(toks[:, p:p + 1], cache, p)[0])
        out["logits"] = [l.numpy().tolist() for l in logits]
        out["held"], out["cache"] = {}, {}
        for i, (layer, full) in enumerate(zip(cache, whole)):
            for name, t in layer.items():
                out["held"][f"{i}.{name}"] = list(t.shape)
                for d, (a, w) in enumerate(zip(t.shape, full[name].shape)):
                    if a != w:
                        t = gather_cat(t.contiguous(), model_ax, d)
                out["cache"][f"stack.layers.{i}.{name}"] = t.numpy().tolist()

        # one sgdm step on this data rank's rows (serving left the weights
        # as they were): the shares' gradients
        batch = {k: torch.as_tensor(v) for k, v in c["batch"].items()}
        dp = dims[0]
        lo, n = host_shard(batch["tokens"].shape[0],
                           mesh.get_local_rank("data"), dp)
        local = {k: v[lo:lo + n] for k, v in batch.items()}
        tc = dict(optimizer="sgdm", lr=0.05, momentum=0.9, weight_decay=0.0,
                  schedule="constant")
        tcfg = TrainConfig(grad_clip=0.0, **tc)
        st = init_train_state(m, tcfg)
        make_train_step(m, tcfg)(st, local)
        got = st.opt_state["m"]
        jg = {k: torch.as_tensor(v) for k, v in c["jax_grads"][dp].items()}
        scale = max(float(g.abs().max()) for g in jg.values())
        errs = {k: float((g - cut(jg[k], m.rank_slices.get(k))).abs().max())
                / scale for k, g in got.items()}
        out["jax_err"] = max(errs.values())
        out["jax_worst"] = max(errs, key=errs.get)
        out["jax_names"] = sorted(got) == sorted(jg)
        out["recurrent_errs"] = {
            k: e for k, e in errs.items()
            if any(s in k for s in (".rwkv.", ".mixer.conv", ".mixer.dt",
                                    ".mixer.a_log", ".mixer.d"))}

        # two clipped steps: the tensors not split over "model" stay
        # equal on every rank
        tcfg = TrainConfig(grad_clip=1.0, **tc)
        m = sharded(c, cfg, mesh)
        st, step = init_train_state(m, tcfg), make_train_step(m, tcfg)
        for _ in range(2):
            step(st, local)

        def whole_t(k, t):
            for dim, _, _ in m.placements[k].cut or ():
                t = gather_cat(t.contiguous(), m.data_axis, dim)
            return t

        with torch.no_grad():
            out["replicated"] = {
                k: hashlib.sha1(whole_t(k, t.detach()).contiguous().numpy()
                                .tobytes()).hexdigest()
                for k, t in m.state_dict().items()
                if k in m.placements and not m.placements[k].model_split
                and t.is_floating_point()}
        return out

    res = {}
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


def reference_serving(arch, fields, tokens):
    """The reference's single-device model (the weights ``jax_case``
    draws): the logits of a prefill of ``PROMPT`` tokens and ``N_DECODE``
    decode steps, and its cache after them by the port's names."""
    from repro_torch.configs import get_config, reduce_config

    cfg = reference_config(arch, "auto", fields)
    jm = JLMModel(cfg)
    params = jm.init(jax.random.PRNGKey(0))
    B = tokens.shape[0]
    cache = jm.init_cache(B, CACHE_LEN, jnp.float32)
    want, cache = jax.jit(jm.prefill)(
        params, {"tokens": jnp.asarray(tokens[:, :PROMPT])}, cache)
    logits = [np.asarray(want)]
    decode = jax.jit(jm.decode_step)
    for i in range(N_DECODE):
        p = PROMPT + i
        want, cache = decode(params, jnp.asarray(tokens[:, p:p + 1]), cache,
                             p)
        logits.append(np.asarray(want))
    port_cfg = reduce_config(get_config(arch)).with_(**fields)
    return logits, jax_cache_by_layer(port_cfg, cache)


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    work = tmp_path_factory.mktemp("shard_recurrent")
    cases = {"__meshes__": MESHES, "__prompt__": PROMPT,
             "__decode__": N_DECODE, "__len__": CACHE_LEN, "__cases__": []}
    ref = {}
    for name, arch, fields in CASES:
        batch = batch_of(arch, fields)
        tree, grads = jax_case(arch, "auto", fields, batch)
        tokens = np.random.default_rng(7).integers(
            0, 997, (2, PROMPT + N_DECODE)).astype(np.int32)
        ref[name] = reference_serving(arch, fields, tokens)
        cases["__cases__"].append(dict(name=name, arch=arch, fields=fields,
                                       batch=batch, tree=tree,
                                       jax_grads=grads, tokens=tokens))
    with open(work / "cases.pkl", "wb") as f:
        pickle.dump(cases, f)
    (work / "child.py").write_text(CHILD)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    out, err, rc = run_ranks([sys.executable, str(work / "child.py"),
                              str(work)], env, timeout=300)
    assert rc == 0, out[-3000:] + err[-6000:]
    ranks = []
    for r in range(4):
        with open(work / f"rank{r}.json") as f:
            ranks.append(json.load(f))
    return ref, ranks


def close(got, want) -> tuple[float, float]:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max()), float(np.abs(want).max())


@pytest.mark.parametrize("key", KEYS)
def test_logits_and_whole_caches_match_the_reference(both, key):
    ref, ranks = both
    want_logits, want_cache = ref[key.split("|")[0]]
    for r, res in enumerate(ranks):
        got = res[key]
        for i, (g, w) in enumerate(zip(got["logits"], want_logits)):
            err, scale = close(g, w)
            assert err <= RTOL * scale, (r, key, "logits", i, err, scale)
        assert set(got["cache"]) == set(want_cache), (r, key)
        for name, g in got["cache"].items():
            err, scale = close(g, want_cache[name])
            assert err <= RTOL * max(scale, 1e-30), (r, key, name, err)


@pytest.mark.parametrize("key", KEYS)
def test_a_rank_holds_its_channels_of_each_recurrent_cache(both, key):
    from repro_torch.configs import get_config, reduce_config

    _, ranks = both
    name, mesh = key.split("|")
    arch, fields = {c[0]: (c[1], c[2]) for c in CASES}[name]
    cfg = reduce_config(get_config(arch)).with_(**fields)
    n = int(mesh.split("x")[1])
    B = 2
    for r, res in enumerate(ranks):
        got = res[key]
        assert got["shards"], (r, key)
        for i, (kind, (lo, hi)) in got["shards"].items():
            held = {k.split(".", 1)[1]: v for k, v in got["held"].items()
                    if k.split(".")[0] == i}
            if kind == "mamba":
                di = cfg.mamba.expand * cfg.d_model
                assert hi - lo == di // n and lo == (r % n) * (di // n)
                assert held == {"conv": [B, cfg.mamba.d_conv - 1, di // n],
                                "h": [B, di // n, cfg.mamba.d_state]}, held
            else:
                hs = cfg.rwkv.head_size
                H = cfg.d_model // hs
                assert hi - lo == cfg.d_model // n
                assert held == {"x_tm": [B, 1, cfg.d_model],
                                "x_cm": [B, 1, cfg.d_model],
                                "state": [B, H // n, hs, hs]}, held


def test_the_ranks_whose_in_rows_are_all_z_give_the_right_logits(both):
    """At (1, 4) ``in``'s 256 rows of [x; z] split 64 a rank: ranks 2 and
    3 hold no row of x, yet their channels of x are 64-127 and 96-127 of
    the gathered output's first half, and their logits are right."""
    ref, ranks = both
    want_logits, _ = ref["jamba"]
    key = "jamba|1x4"
    for r in (2, 3):
        got = ranks[r][key]
        (dim, lo, hi), = [c for c in got["placements"][
            "stack.layers.0.mixer.in.w_data"]["cut"] if c[0] == 0]
        assert (lo, hi) == (64 * r, 64 * (r + 1)) and lo >= 128, (lo, hi)
        assert got["shards"]["0"][1] == [32 * r, 32 * (r + 1)]
        for g, w in zip(got["logits"], want_logits):
            err, scale = close(g, w)
            assert err <= RTOL * scale, (r, err, scale)


@pytest.mark.parametrize("key", KEYS)
def test_shares_match_the_references_jax_grad(both, key):
    _, ranks = both
    for r, res in enumerate(ranks):
        got = res[key]
        assert got["jax_names"], (r, key)
        assert got["recurrent_errs"], (r, key)
        assert got["jax_err"] <= JAX_RTOL, (r, key, got["jax_worst"],
                                            got["jax_err"])


@pytest.mark.parametrize("key", KEYS)
def test_two_clipped_steps_keep_the_replicas_equal(both, key):
    _, ranks = both
    want = ranks[0][key]["replicated"]
    assert any(".rwkv." in k or ".mixer.a_log" in k for k in want), key
    for r, res in enumerate(ranks[1:], 1):
        assert res[key]["replicated"] == want, (r, key)


@pytest.mark.parametrize("key", KEYS)
def test_placements_equal_the_references_param_spec(both, key):
    from repro_torch.configs import get_config, reduce_config
    from repro_torch.parallel import reference_path

    _, ranks = both
    name, mesh = key.split("|")
    arch, fields = {c[0]: (c[1], c[2]) for c in CASES}[name]
    cfg = reduce_config(get_config(arch)).with_(**fields)
    dp, tp = map(int, mesh.split("x"))
    sizes = {"data": dp, "model": tp}
    for r, res in enumerate(ranks):
        got = res[key]
        n_model = 0
        for leaf, p in got["placements"].items():
            path, scanned = reference_path(cfg, leaf)
            want = reference_spec(path, scanned, got["full_shapes"][leaf],
                                  sizes)
            assert p["spec"] == want, (r, leaf, p["spec"], want)
            n_model += "model" in p["spec"]
        assert n_model > 0, (r, key)


CACHE_MESHES = [{"data": 1, "model": 4}, {"data": 2, "model": 2},
                {"data": 4, "model": 4}]


@pytest.mark.parametrize("long_context", [False, True])
@pytest.mark.parametrize("arch,fields", [(c[1], c[2]) for c in CASES])
def test_cache_placements_equal_the_references_cache_specs(
        monkeypatch, arch, fields, long_context):
    """The reference's ``cache_specs`` (its ``NamedSharding`` stood in by
    the spec it wraps, on a stand-in mesh of the axis sizes) against
    ``port_cache_specs`` on the port's per-layer cache, leaf by leaf; a
    long-context cell at 8192 tokens, batch 1."""
    from repro_torch.configs import get_config, reduce_config
    from repro_torch.models import LMModel
    from repro_torch.parallel.sharding import port_cache_specs, reference_path

    monkeypatch.setattr(j_sharding, "NamedSharding",
                        lambda mesh, spec: tuple(spec))
    jm = JLMModel(reference_config(arch, "auto", fields))
    cfg = reduce_config(get_config(arch)).with_(**fields)
    B, L = (1, 8192) if long_context else (8, 16)
    jcache = jax.eval_shape(lambda: jm.init_cache(B, L, jnp.float32))
    cache = LMModel(cfg, device="meta").init_cache(B, L)
    n = 0
    for sizes in CACHE_MESHES:
        mesh = types.SimpleNamespace(axis_names=tuple(sizes), shape=sizes)
        want = j_sharding.cache_specs(jcache, mesh, long_context=long_context)
        # every leaf's spec as {"/"-path: spec}
        flat = {}
        for path, spec in jax.tree_util.tree_flatten_with_path(
                want, is_leaf=lambda x: isinstance(x, tuple))[0]:
            flat["/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                          for k in path)] = tuple(spec)
        got = port_cache_specs(cfg, cache, sizes, long_context=long_context)
        for i, layer in enumerate(got):
            for leaf, spec in layer.items():
                path, scanned = reference_path(cfg,
                                               f"stack.layers.{i}.{leaf}")
                w = flat[path[len("stack/"):]]
                assert tuple(spec) == (w[1:] if scanned else w), \
                    (sizes, i, leaf, spec, w)
                n += 1
    assert n > 0
