"""Sharded and disaggregated serving on four gloo processes (CPU).

One child run spawns four ranks on a ``file://`` store and serves every
case below; each rank writes what it saw, and the tests read it.  The
reference's five cases of ``tests/test_serve_sharded.py``, and int8:

  * tinyllama at dp 2 x tp 2, compact and masked, single-shot and chunked
    (chunk counts; never more than one chunk a step);
  * qwen2-moe at tp 2 x ep 2: pools split on the heads dim only, 2 of 8
    experts a rank;
  * preemption under pool pressure, with ``preempt_log`` equal across
    (2, 2), (1, 4) and (4, 1);
  * disaggregation, prefill on ranks 0-1 and decode on 2-3: one handoff a
    request, single-shot and chunked;
  * prefix sharing on both engines;
  * seeded faults, and a snapshot restored into a new sharded engine;
  * int8 storage (tinyllama, qwen2-moe);
  * MLA (deepseek-v2 at tp 2 x ep 2, its latent pools whole on every
    rank), codebooks (musicgen-medium, 3 codebooks over 4 ranks, so a
    rank's head rows cross a codebook boundary) and chain storage
    (tinyllama under the deep-chain plan at tp 4, sub-chunks of its
    slots), on the sharded and the disaggregated engine;
  * the recurrent kinds (rwkv6-7b, jamba), refused by both engines with
    the reference's message before anything is cut (the model left
    whole; ``shard_module`` takes them, tests/test_torch_shard_recurrent.py).

  * FSDP (the weights cut over "data" as well, gathered on use):
    qwen2-moe at dp 2 x tp 2 on the sharded engine, and tinyllama on the
    disaggregated engine with both roles at dp 2 x tp 2 on all four
    ranks, and with each role at dp 2 on two ranks of its own.

Every engine's greedy streams equal ``run_sequential`` over the same
sharded model, token for token.  And for nine archs in the storages
(dense, masked, compact, chain, int8), the sharded model's first prefill
(pixtral-12b's with patch embeddings) and 4 decode logits are within
1e-5 * max|ref| of the reference's single-device ``LMModel`` on the same
bridged parameters (``load_jax_params`` loading each rank's share), and
every rank holds 1/n of the elements of each tensor the spec splits, n
the product of the sizes of the axes its spec names (over "model", and
over "data" where FSDP cuts it).  The reference runs here, in the test
process; the ranks import only torch and the port.
"""
import json
import os
import pickle
import signal
import subprocess
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
from repro.serve import ShardedContinuousEngine as JShardedEngine
from repro.sparsity import PatternSpec as JPatternSpec
from repro.sparsity import PlanRule as JPlanRule
from repro.sparsity import SparsityPlan as JSparsityPlan
from repro.sparsity import quantize_weights as j_quantize_weights

from test_torch_quant_model import quant_tree_to_numpy

ROOT = Path(__file__).resolve().parents[1]
RTOL = 1e-5
N_PROMPT, N_DECODE = 7, 4
# (name, arch, storage, mesh dims, config fields replaced on both sides):
# a vocabulary of 1024 splits over "model" (the reduced 997 does not), so
# the vocabulary-parallel embedding and (tied) head run; gemma3 keeps one
# period of its 5 swa : 1 attn pattern, its 2 kv heads gathered over 4
LOGIT_CASES = [
    ("tinyllama-dense", "tinyllama-1.1b", "dense", (2, 2),
     {"vocab_size": 1024}),
    ("tinyllama-masked", "tinyllama-1.1b", "xla_masked", (2, 2), {}),
    ("tinyllama-compact", "tinyllama-1.1b", "auto", (2, 2), {}),
    ("tinyllama-int8", "tinyllama-1.1b", "int8", (2, 2), {}),
    ("qwen2-moe-masked", "qwen2-moe-a2.7b", "xla_masked", (1, 2, 2), {}),
    ("qwen2-moe-compact", "qwen2-moe-a2.7b", "auto", (1, 2, 2), {}),
    ("qwen2-moe-int8", "qwen2-moe-a2.7b", "int8", (1, 2, 2), {}),
    ("gemma-7b-compact", "gemma-7b", "auto", (2, 2), {"vocab_size": 1024}),
    ("gemma3-4b-compact", "gemma3-4b", "auto", (1, 4), {"n_layers": 6}),
    ("deepseek-7b-dense", "deepseek-7b", "dense", (1, 4),
     {"vocab_size": 1024}),
    # MLA (a head a rank), codebooks (a head share of 96 rows over
    # codebooks of 128), the patch frontend and chain storage
    ("deepseek-v2-compact", "deepseek-v2-236b", "auto", (1, 2, 2), {}),
    ("deepseek-v2-masked", "deepseek-v2-236b", "xla_masked", (1, 2, 2), {}),
    ("deepseek-v2-int8", "deepseek-v2-236b", "int8", (1, 2, 2), {}),
    ("musicgen-compact", "musicgen-medium", "auto", (1, 4),
     {"n_codebooks": 3}),
    ("musicgen-int8", "musicgen-medium", "int8", (1, 4), {"n_codebooks": 3}),
    ("pixtral-compact", "pixtral-12b", "auto", (2, 2), {"vocab_size": 1024}),
    ("pixtral-int8", "pixtral-12b", "int8", (2, 2), {"vocab_size": 1024}),
    ("tinyllama-chain", "tinyllama-1.1b", "chain", (1, 4), {}),
    ("tinyllama-chain-int8", "tinyllama-1.1b", "chain-int8", (1, 4), {}),
]
ENGINE_CASES = ["tp-compact", "tp-masked", "moe-ep", "preempt", "disagg",
                "prefix", "faults-snapshot", "int8", "mla", "codebooks",
                "chain", "recurrent", "fsdp"]
# the deep-chain plan of tests/test_torch_chain_model.py (a 4 x 4 leaf)
CHAIN = dict(pattern="rbgp", sparsity=0.875, backend="auto",
             factors=(("complete", 2, 2, 0.0), ("ramanujan", 0, 0, -1.0),
                      ("ramanujan", 0, 0, -1.0), ("ramanujan", 0, 0, -1.0),
                      ("complete", 2, 2, 0.0)), min_dim=64)
RECURRENT = ["rwkv6-7b", "jamba-1.5-large-398b"]

CHILD = r'''
import json, os, pickle, sys
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def config(arch, storage, fields, chain=None):
    from repro_torch.configs import apply_sparsity, get_config, reduce_config
    from repro_torch.sparsity import PatternSpec, PlanRule, SparsityPlan
    cfg = reduce_config(get_config(arch))
    if storage == "dense":
        cfg = apply_sparsity(cfg, pattern="dense")
    elif storage.startswith("chain"):
        cfg = apply_sparsity(cfg, plan=SparsityPlan(
            rules=(PlanRule(".*", PatternSpec(**chain)),)))
    else:
        cfg = apply_sparsity(cfg, pattern="rbgp4", sparsity=0.5,
                             backend="auto" if storage == "int8" else storage,
                             min_dim=64)
    return cfg.with_(**fields)


def workload(shapes, vocab, seed=0, n_codebooks=1):
    rng = np.random.default_rng(seed)
    tail = (n_codebooks,) if n_codebooks > 1 else ()
    return [{"rid": i,
             "prompt": rng.integers(0, vocab, (s,) + tail).astype(np.int32),
             "max_new_tokens": g, "sampling": None}
            for i, (s, g) in enumerate(shapes)]


def rank_main(rank, world, store, work):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=120))
    from repro_torch.bridge import flatten_jax_tree, load_jax_params
    from repro_torch.launch.mesh import make_serve_mesh
    from repro_torch.models import LMModel
    from repro_torch.parallel import COLLECTIVES, reset_collectives
    from repro_torch.serve import run_sequential
    from repro_torch.serve.distributed import (DisaggregatedEngine,
                                               ShardedContinuousEngine)
    from repro_torch.sparsity import quantize_weights

    with open(os.path.join(work, "cases.pkl"), "rb") as f:
        cases = pickle.load(f)
    res = {}

    def build(name, dims):
        c = cases[name]
        cfg = config(c["arch"], c["storage"], c["fields"], cases["__chain__"])
        model = LMModel(cfg, device="cpu", seed=0)
        if c["storage"].endswith("int8"):
            quantize_weights(model)
        from repro_torch.parallel import shard_module
        shard_module(model, make_serve_mesh(*dims))
        load_jax_params(model, c["tree"])
        return model, c

    def streams(eng, wl, model):
        for r in wl:
            eng.submit(r["prompt"], r["max_new_tokens"])
        out = eng.drain()
        ref = run_sequential(model, wl, cache_len=eng.gather_tokens)
        return (sorted(out) == sorted(r["rid"] for r in wl) and all(
            np.array_equal(out[r["rid"]], ref[r["rid"]]) for r in wl))

    def logits_case(name):
        c = cases[name]
        model, _ = build(name, tuple(c["dims"]))
        reset_collectives()
        toks = c["tokens"]
        cache = model.init_cache(1, 16, torch.float32)
        got = [model.prefill(toks[:, :N_PROMPT], cache,
                             patch_embeds=c["patch_embeds"])[0]]
        for i in range(N_DECODE):
            p = N_PROMPT + i
            got.append(model.decode_step(toks[:, p:p + 1], cache, p)[0])
        got = torch.cat(got).numpy()
        want = c["logits"]
        err = float(np.abs(got - want).max() / np.abs(want).max())
        full = flatten_jax_tree(model.cfg, c["tree"])
        sizes = dict(zip(model.mesh.mesh_dim_names, model.mesh.mesh.shape))
        state = model.state_dict()
        split = {k: p for k, p in model.placements.items()
                 if p.model_split or p.data_split}
        share = {k: [state[k].numel(), int(np.prod(full[k].shape)),
                     int(np.prod([sizes[a] for ax in p.spec if ax
                                  for a in ([ax] if isinstance(ax, str)
                                            else ax)]))]
                 for k, p in split.items()}
        return {"err": err, "collectives": dict(COLLECTIVES),
                "share": share,
                "n_fsdp": sum(p.data_split for p in split.values()),
                "kept_whole": [k for k, p in split.items() if p.cut is None],
                "cut": sum(p.cut is not None for p in split.values())}

    def engine_case(name):
        out = {}
        if name in ("tp-compact", "tp-masked"):
            model, _ = build("tinyllama-" + name[3:], (2, 2))
            wl = workload([(4, 3), (12, 6), (8, 2), (16, 4)],
                          model.cfg.vocab_size)
            mesh = model.mesh
            eng = ShardedContinuousEngine(model, mesh, page_size=4,
                                          max_slots=3, max_request_len=40)
            out["single"] = streams(eng, wl, model)
            eng = ShardedContinuousEngine(model, mesh, page_size=4,
                                          max_slots=3, max_request_len=40,
                                          prefill_chunk=5)
            out["chunked"] = streams(eng, wl, model)
            out["chunks"] = eng.stats["prefill_chunks"]
            out["want_chunks"] = sum(-(-r["prompt"].shape[0] // 5)
                                     for r in wl)
            out["max_chunks_a_step"] = max(t["prefill_chunks"]
                                           for t in eng.step_trace)
            out["chunk_beside_decode"] = any(
                t["prefill_chunks"] == 1 and t["decode_rows"] > 0
                for t in eng.step_trace)
        elif name == "moe-ep":
            model, _ = build("qwen2-moe-compact", (1, 2, 2))
            eng = ShardedContinuousEngine(model, model.mesh, page_size=4,
                                          max_slots=2, max_request_len=32)
            out["pool_specs"] = [[list(s) for s in layer.values()]
                                 for layer in eng.kv.specs]
            out["pool_heads"] = [tuple(p["k"].shape)
                                 for p in eng.kv.pools][:1]
            ffn = model.stack.layers[0].ffn
            out["experts"] = [ffn.tp.lo, ffn.tp.hi,
                              ffn.experts.gate["w_data"].shape[0]]
            out["streams"] = streams(eng, workload(
                [(4, 3), (8, 4), (6, 2)], model.cfg.vocab_size, seed=2),
                model)
        elif name == "preempt":
            traces = {}
            for dims in ((2, 2), (1, 4), (4, 1)):
                model, _ = build("tinyllama-compact", dims)
                wl = workload([(4, 8), (12, 10), (8, 9), (16, 6), (6, 10)],
                              model.cfg.vocab_size)
                eng = ShardedContinuousEngine(
                    model, model.mesh, page_size=4, max_slots=4,
                    max_request_len=40, reserve="prompt", n_blocks=11)
                tag = "x".join(map(str, dims))
                out[tag] = {"streams": streams(eng, wl, model),
                            "preemptions": eng.stats["preemptions"],
                            "resumed": eng.stats["resumed_prefills"],
                            "whole": eng.kv.allocator.n_free
                            == eng.kv.allocator.n_total}
                traces[tag] = [list(t) for t in eng.preempt_log]
            out["traces"] = traces
        elif name == "disagg":
            c = cases["tinyllama-compact"]
            cfg = config(c["arch"], c["storage"], c["fields"])
            wl = workload([(4, 3), (12, 6), (8, 2), (16, 4)],
                          cfg.vocab_size, seed=1)
            for chunk in (0, 5):
                m2 = LMModel(cfg, device="cpu", seed=0)
                pm = make_serve_mesh(1, 2, ranks=[0, 1])
                dm = make_serve_mesh(1, 2, ranks=[2, 3])
                eng = DisaggregatedEngine(m2, dm, pm, page_size=4,
                                          max_slots=3, max_request_len=40,
                                          prefill_chunk=chunk)
                load_jax_params(m2, c["tree"])
                ok = streams(eng, wl, m2)
                out[f"chunk{chunk}"] = {
                    "streams": ok, "handoffs": eng.stats["handoffs"],
                    "max_chunks_a_step": max(t["prefill_chunks"]
                                             for t in eng.step_trace),
                    "role": [eng.in_prefill, eng.in_decode],
                    "pools": len(eng.kv.pools)}
        elif name == "prefix":
            os.environ["REPRO_SERVE_CHECKS"] = "1"
            model, c = build("tinyllama-compact", (2, 2))
            rng = np.random.default_rng(0)
            V = model.cfg.vocab_size
            base = rng.integers(1, V, size=16).astype(np.int32)
            tail = rng.integers(1, V, size=9).astype(np.int32)
            wl = [{"rid": 0, "prompt": base.copy(), "max_new_tokens": 4},
                  {"rid": 1, "prompt": base.copy(), "max_new_tokens": 4},
                  {"rid": 2, "prompt": base[:8].copy(), "max_new_tokens": 4},
                  {"rid": 3, "prompt": np.concatenate([base[:12], tail]),
                   "max_new_tokens": 4}]
            for chunk in (0, 5):
                eng = ShardedContinuousEngine(
                    model, model.mesh, page_size=4, max_slots=1,
                    max_request_len=32, prefill_chunk=chunk,
                    prefix_cache=True)
                ok = streams(eng, wl, model)
                eng.kv.allocator.check_invariants()
                out[f"sharded{chunk}"] = [ok, eng.stats["prefix_hits"],
                                          eng.stats["prefix_cow_copies"]]
                m2 = LMModel(model.cfg, device="cpu", seed=0)
                eng = DisaggregatedEngine(
                    m2, make_serve_mesh(1, 2, ranks=[2, 3]),
                    make_serve_mesh(1, 2, ranks=[0, 1]), page_size=4,
                    max_slots=1, max_request_len=32, prefill_chunk=chunk,
                    prefix_cache=True)
                load_jax_params(m2, c["tree"])
                ok = streams(eng, wl, m2)
                eng.kv.allocator.check_invariants()
                out[f"disagg{chunk}"] = [ok, eng.stats["prefix_hits"],
                                         eng.stats["shared_prefills"]]
            os.environ.pop("REPRO_SERVE_CHECKS")
        elif name == "faults-snapshot":
            from repro_torch.serve import FaultSchedule, restore_engine
            model, _ = build("tinyllama-compact", (2, 2))
            wl = workload([(4, 8), (12, 10), (8, 9), (16, 6), (6, 10)],
                          model.cfg.vocab_size, seed=4)
            kw = dict(page_size=4, max_slots=3, max_request_len=40)
            eng = ShardedContinuousEngine(
                model, model.mesh, faults=FaultSchedule.random(
                    0, horizon=16, n_events=6), **kw)
            out["faults"] = [streams(eng, wl, model),
                             eng.stats["fault_events"]]
            # a snapshot after 4 steps (each rank its own file), restored
            # into a new sharded engine over the same sharded model
            eng = ShardedContinuousEngine(model, model.mesh, **kw)
            for r in wl:
                eng.submit(r["prompt"], r["max_new_tokens"])
            for _ in range(4):
                eng.step()
            path = os.path.join(work, f"snap{rank}.npz")
            eng.snapshot(path)
            eng = restore_engine(path, model, mesh=model.mesh)
            got = eng.drain()
            ref = run_sequential(model, wl, cache_len=eng.gather_tokens)
            out["snapshot"] = [eng.kind, all(np.array_equal(
                got[r["rid"]], ref[r["rid"]]) for r in wl)]
        elif name == "int8":
            for case, dims in (("tinyllama-int8", (2, 2)),
                               ("qwen2-moe-int8", (1, 2, 2))):
                model, _ = build(case, dims)
                eng = ShardedContinuousEngine(model, model.mesh, page_size=4,
                                              max_slots=3,
                                              max_request_len=40)
                out[case] = streams(eng, workload(
                    [(4, 3), (12, 6), (8, 2), (16, 4)],
                    model.cfg.vocab_size, seed=3), model)
        elif name in ("mla", "codebooks", "chain"):
            case = {"mla": "deepseek-v2-compact",
                    "codebooks": "musicgen-compact",
                    "chain": "tinyllama-chain"}[name]
            model, c = build(case, tuple(cases[case]["dims"]))
            wl = workload([(4, 3), (12, 6), (8, 2), (16, 4)],
                          model.cfg.vocab_size, seed=5,
                          n_codebooks=model.cfg.n_codebooks)
            for chunk in (0, 5):
                eng = ShardedContinuousEngine(
                    model, model.mesh, page_size=4, max_slots=3,
                    max_request_len=40, prefill_chunk=chunk)
                out[f"sharded{chunk}"] = streams(eng, wl, model)
                m2 = LMModel(model.cfg, device="cpu", seed=0)
                if c["storage"].endswith("int8"):
                    quantize_weights(m2)
                eng = DisaggregatedEngine(
                    m2, make_serve_mesh(1, 2, ranks=[2, 3]),
                    make_serve_mesh(1, 2, ranks=[0, 1]), page_size=4,
                    max_slots=3, max_request_len=40, prefill_chunk=chunk)
                load_jax_params(m2, c["tree"])
                out[f"disagg{chunk}"] = [streams(eng, wl, m2),
                                         eng.stats["handoffs"]]
            out["pools"] = {k: list(v.shape)
                            for k, v in eng.kv.pools[0].items()} \
                if eng.kv.pools else None
        elif name == "fsdp":
            model, _ = build("qwen2-moe-compact", (2, 2))
            eng = ShardedContinuousEngine(model, model.mesh, page_size=4,
                                          max_slots=3, max_request_len=40)
            reset_collectives()
            out["moe"] = streams(eng, workload(
                [(4, 3), (12, 6), (8, 2), (16, 4)], model.cfg.vocab_size,
                seed=6), model)
            out["moe_collectives"] = dict(COLLECTIVES)
            c = cases["tinyllama-compact"]
            cfg = config(c["arch"], c["storage"], c["fields"])
            wl = workload([(4, 3), (12, 6), (8, 2), (16, 4)],
                          cfg.vocab_size, seed=7)
            for tag, dm, pm in (
                    ("both", lambda: make_serve_mesh(2, 2),
                     lambda: make_serve_mesh(2, 2)),
                    ("apart", lambda: make_serve_mesh(2, 1, ranks=[2, 3]),
                     lambda: make_serve_mesh(2, 1, ranks=[0, 1]))):
                m2 = LMModel(cfg, device="cpu", seed=0)
                eng = DisaggregatedEngine(m2, dm(), pm(), page_size=4,
                                          max_slots=3, max_request_len=40,
                                          prefill_chunk=5)
                load_jax_params(m2, c["tree"])
                reset_collectives()
                out[tag] = [streams(eng, wl, m2), eng.stats["handoffs"],
                            COLLECTIVES["gather_on_use"]]
        elif name == "recurrent":
            # both engines refuse before they cut anything: the model is
            # left whole (model.mesh unset)
            for arch in cases["__recurrent__"]:
                cfg = config(arch, "auto", {})
                got = []
                for make in (lambda m: ShardedContinuousEngine(
                                 m, make_serve_mesh(2, 2), page_size=4,
                                 max_slots=2, max_request_len=16),
                             lambda m: DisaggregatedEngine(
                                 m, make_serve_mesh(1, 2, ranks=[0, 1]),
                                 make_serve_mesh(1, 2, ranks=[2, 3]),
                                 page_size=4, max_slots=2,
                                 max_request_len=16)):
                    m = LMModel(cfg, device="cpu", seed=0)
                    try:
                        make(m)
                        got.append([None, m.mesh is None])
                    except NotImplementedError as e:
                        got.append([str(e), m.mesh is None])
                out[arch] = got
        return out

    N_PROMPT, N_DECODE = cases["__n__"]
    # an exception ends this rank, and mp.spawn then ends the others: no
    # rank waits in a collective its peers never reach
    for name in cases["__logits__"]:
        res[name] = logits_case(name)
    for name in cases["__engines__"]:
        res[name] = engine_case(name)
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
    if storage == "dense":
        cfg = j_apply_sparsity(cfg, pattern="dense")
    elif storage.startswith("chain"):
        cfg = j_apply_sparsity(cfg, plan=JSparsityPlan(
            rules=(JPlanRule(".*", JPatternSpec(**CHAIN)),)))
    else:
        cfg = j_apply_sparsity(
            cfg, pattern="rbgp4", sparsity=0.5,
            backend="auto" if storage == "int8" else storage, min_dim=64)
    return cfg.with_(**fields)


def reference_case(arch, storage, fields, seed=0):
    """The reference's tree (numpy, as ``load_jax_params`` takes it), the
    tokens, the patch embeddings of a vision model (else None) and the
    logits at the prefill's last position and the 4 decode positions (one
    causal forward over all of them; a MoE model's prefill and decode
    steps, which route at full capacity)."""
    cfg = reference_config(arch, storage, fields)
    jm = JLMModel(cfg)
    params = jm.init(jax.random.PRNGKey(seed))
    if storage.endswith("int8"):
        params = j_quantize_weights(params)
    rng = np.random.default_rng(seed + 1)
    tail = (cfg.n_codebooks,) if cfg.n_codebooks > 1 else ()
    toks = rng.integers(0, cfg.vocab_size,
                        (1, N_PROMPT + N_DECODE) + tail).astype(np.int32)
    patches = None
    batch = {"tokens": jnp.asarray(toks)}
    if cfg.frontend == "vision":
        patches = rng.standard_normal(
            (1, cfg.n_patches, cfg.d_model)).astype(np.float32)
        batch["patch_embeds"] = jnp.asarray(patches)
    if cfg.moe is None:
        logits = jm.forward(params, batch)[0]
        return (quant_tree_to_numpy(params), toks, patches,
                np.asarray(logits)[0, N_PROMPT - 1:])
    # the training forward routes at a capacity and may drop tokens;
    # serving routes at full capacity: the prefill and decode steps
    cache = jm.init_cache(1, 16, jnp.float32)
    out, cache = jax.jit(jm.prefill)(
        params, {"tokens": jnp.asarray(toks[:, :N_PROMPT])}, cache)
    logits = [np.asarray(out)]
    decode = jax.jit(jm.decode_step)
    for i in range(N_DECODE):
        p = N_PROMPT + i
        out, cache = decode(params, jnp.asarray(toks[:, p:p + 1]), cache, p)
        logits.append(np.asarray(out))
    return quant_tree_to_numpy(params), toks, patches, np.concatenate(logits)


def reference_refusal(arch):
    """The reference's sharded engine's message for a recurrent arch."""
    cfg = reference_config(arch, "auto", {})
    jm = JLMModel(cfg)
    mesh = jax.make_mesh((1, 1), ("data", "model"), devices=jax.devices()[:1])
    with pytest.raises(NotImplementedError) as err:
        JShardedEngine(jm, jm.init(jax.random.PRNGKey(0)), mesh, page_size=4,
                       max_slots=2, max_request_len=16)
    return str(err.value)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    work = tmp_path_factory.mktemp("sharded")
    cases = {"__n__": (N_PROMPT, N_DECODE),
             "__logits__": [c[0] for c in LOGIT_CASES],
             "__engines__": ENGINE_CASES, "__chain__": CHAIN,
             "__recurrent__": RECURRENT}
    for name, arch, storage, dims, fields in LOGIT_CASES:
        tree, toks, patches, logits = reference_case(arch, storage, fields)
        cases[name] = dict(arch=arch, storage=storage, dims=dims,
                           fields=fields, tree=tree, tokens=toks,
                           patch_embeds=patches, logits=logits)
    with open(work / "cases.pkl", "wb") as f:
        pickle.dump(cases, f)
    (work / "child.py").write_text(CHILD)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    out, err, rc = run_ranks([sys.executable, str(work / "child.py"),
                              str(work)], env, timeout=480)
    assert rc == 0, out[-3000:] + err[-6000:]
    out = []
    for r in range(4):
        with open(work / f"rank{r}.json") as f:
            out.append(json.load(f))
    return out


def run_ranks(cmd, env, timeout=300):
    """Run ``cmd`` (which spawns the ranks) in a session of its own, and on
    a timeout end the whole session, the ranks included."""
    p = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                         stderr=subprocess.PIPE, text=True,
                         start_new_session=True)
    try:
        out, err = p.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(p.pid, signal.SIGKILL)
        out, err = p.communicate()
        return out, err + f"\ntimed out after {timeout} s", -1
    return out, err, p.returncode


def case(ranks, name):
    return [res[name] for res in ranks]


@pytest.mark.parametrize("name", [c[0] for c in LOGIT_CASES])
def test_sharded_logits_match_the_reference_single_device_model(ranks,
                                                                 name):
    for r, res in enumerate(case(ranks, name)):
        assert res["err"] <= RTOL, (r, res["err"])
        assert res["collectives"]["all_gather"] > 0


@pytest.mark.parametrize("name", [c[0] for c in LOGIT_CASES])
def test_every_rank_holds_its_share_of_each_split_tensor(ranks, name):
    """1/n of the elements of every tensor the spec splits, n the product
    of the sizes of the axes it names (over "model", and over the data
    axes where FSDP cuts it): the sharding is real, and nothing it splits
    stays whole."""
    for r, res in enumerate(case(ranks, name)):
        assert res["cut"] > 0 and not res["kept_whole"], (r,
                                                         res["kept_whole"])
        assert res["n_fsdp"] > 0, r
        for k, (local, full, n) in res["share"].items():
            assert local * n == full, (r, k, local, full, n)


def test_tp_engine_streams_compact_and_masked_single_and_chunked(ranks):
    for name in ("tp-compact", "tp-masked"):
        for r, res in enumerate(case(ranks, name)):
            assert res["single"] and res["chunked"], (name, r)
            assert res["chunks"] == res["want_chunks"]
            assert res["max_chunks_a_step"] <= 1
            assert res["chunk_beside_decode"]


def test_tp_ep_moe_pools_split_on_heads_and_experts_over_ranks(ranks):
    for r, res in enumerate(case(ranks, "moe-ep")):
        assert res["streams"], r
        found = False
        for layer in res["pool_specs"]:
            for spec in layer:
                assert all(a in (None, "model") for a in spec), spec
                if "model" in spec:
                    found = True
                    assert spec[0] is None and spec.index("model") == 2
        assert found
        assert res["pool_heads"][0][2] == 1      # 4 kv heads over 4
        assert res["experts"] == [2 * r, 2 * r + 2, 2]


def test_preemption_streams_and_victims_equal_across_meshes(ranks):
    for r, res in enumerate(case(ranks, "preempt")):
        for tag in ("2x2", "1x4", "4x1"):
            assert res[tag]["streams"], (r, tag)
            assert res[tag]["preemptions"] >= 2 and res[tag]["resumed"] >= 2
            assert res[tag]["whole"]
        t = res["traces"]
        assert t["2x2"] == t["1x4"] == t["4x1"] and t["2x2"], t


def test_disaggregated_engine_hands_off_once_a_request(ranks):
    for r, res in enumerate(case(ranks, "disagg")):
        for chunk in ("chunk0", "chunk5"):
            got = res[chunk]
            assert got["streams"], (r, chunk)
            assert got["handoffs"] == 4
            assert got["max_chunks_a_step"] <= 1
            assert got["role"] == [r < 2, r >= 2]
            assert got["pools"] == (0 if r < 2 else 2)


def test_prefix_sharing_on_both_engines(ranks):
    for r, res in enumerate(case(ranks, "prefix")):
        for chunk in (0, 5):
            ok, hits, cow = res[f"sharded{chunk}"]
            assert ok and hits > 0 and cow >= 2, (r, chunk)
            ok, hits, shared = res[f"disagg{chunk}"]
            assert ok and hits > 0 and shared > 0, (r, chunk)


def test_faults_and_a_restored_snapshot_keep_the_sequential_streams(
        ranks):
    for r, res in enumerate(case(ranks, "faults-snapshot")):
        ok, events = res["faults"]
        assert ok and events > 0, (r, events)
        assert res["snapshot"] == ["sharded", True], r


def test_int8_sharded_streams_equal_the_sequential_path(ranks):
    for r, res in enumerate(case(ranks, "int8")):
        assert res["tinyllama-int8"] and res["qwen2-moe-int8"], r


@pytest.mark.parametrize("name", ["mla", "codebooks", "chain"])
def test_mla_codebook_and_chain_streams_on_both_engines(ranks, name):
    """The sharded engine (single-shot and chunked) and the disaggregated
    engine (prefill on ranks 0-1, decode on 2-3) keep the sequential
    streams over the same sharded model; an MLA layer's pools hold the
    whole latent on each decode rank."""
    for r, res in enumerate(case(ranks, name)):
        for chunk in (0, 5):
            assert res[f"sharded{chunk}"], (name, r, chunk)
            ok, handoffs = res[f"disagg{chunk}"]
            assert ok and handoffs == 4, (name, r, chunk, handoffs)
        assert (res["pools"] is None) == (r < 2), (r, res["pools"])
        if name == "mla" and r >= 2:
            # deepseek-v2 reduced: kv_lora_rank 32, rope_head_dim 8, pages
            # of 4 slots
            p = res["pools"]
            n_blocks = p["pos"][0]
            assert p == {"ckv": [n_blocks, 4, 32], "krope": [n_blocks, 4, 8],
                         "pos": [n_blocks, 4]}, p


@pytest.mark.parametrize("tag", ["moe", "both", "apart"])
def test_fsdp_streams_on_both_engines_at_data_2(ranks, tag):
    """The weights cut over "data" (FSDP) and gathered on use: qwen2-moe's
    sharded engine at (2, 2), and the disaggregated engine with both roles
    at (2, 2) on all four ranks ("both") and each role at (2, 1) on two
    ranks of its own ("apart"), keep the sequential streams; every rank
    gathers, so the roles' gathers run in lockstep."""
    for r, res in enumerate(case(ranks, "fsdp")):
        if tag == "moe":
            assert res["moe"], r
            assert res["moe_collectives"]["gather_on_use"] > 0, r
            continue
        ok, handoffs, gathers = res[tag]
        assert ok and handoffs == 4, (tag, r, handoffs)
        assert gathers > 0, (tag, r)


@pytest.mark.parametrize("arch", RECURRENT)
def test_recurrent_kinds_keep_the_reference_refusal(ranks, arch):
    """The sharded and the disaggregated engine refuse a recurrent model
    with the reference's message, and leave it uncut (``shard_module``
    itself takes the recurrent mixers)."""
    want = reference_refusal(arch)
    assert "static engine" in want
    for r, res in enumerate(case(ranks, "recurrent")):
        assert res[arch] == [[want, True], [want, True]], (r, res[arch],
                                                           want)
