"""The reduced qwen2-moe-a2.7b model of the port against the reference's,
on the CPU: the reference's layer grouping (MoE cadence and dense
``first_dense`` layers), the weight bridge's MoE leaves, logits and aux
loss, paged decode, and greedy streams against the JAX engine and the
port's own ``run_sequential``.

The reduced config (2 layers, d_model 64, 8 experts of width 64, top-2,
one shared expert) with rbgp4 at 0.75 and ``min_dim=64``: every
projection compact, the experts stacked.  The JAX ``LMModel.init``
weights go through ``load_jax_params``.  Tolerance: 1e-4 * max|ref|
(float32; summation order), with the smallest top-k router margin
asserted to be at least ``MARGIN`` (see ``test_torch_moe.py``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import apply_sparsity as j_apply_sparsity
from repro.configs import get_config as j_get_config
from repro.configs import reduce_config as j_reduce_config
from repro.models import LMModel as JLMModel
from repro.models.transformer import Stack as JStack
from repro.serve import ContinuousEngine as JContinuousEngine
from repro_torch.bridge import flatten_jax_tree, load_jax_params
from repro_torch.configs import apply_sparsity, get_config, reduce_config
from repro_torch.data import RequestStream
from repro_torch.models import LMModel, jax_stack_split
from repro_torch.serve import ContinuousEngine, run_sequential

from test_torch_model import jax_tree_to_numpy
from test_torch_moe import RTOL, SP, assert_close, topk_margins

torch.set_num_threads(1)


# -- the layer grouping and the weight bridge ------------------------------------

def split_cases():
    out = []
    for name in ("tinyllama-1.1b", "qwen2-moe-a2.7b"):
        out += [(name, {}, None), (name, {"reduced": True}, None)]
    out += [("tinyllama-1.1b", {"layer_pattern": ("swa", "attn"),
                                "n_layers": 7}, None),
            ("qwen2-moe-a2.7b", {}, dict(first_dense=1)),
            ("qwen2-moe-a2.7b", {"n_layers": 9},
             dict(first_dense=1, every_n_layers=2)),
            ("qwen2-moe-a2.7b", {"layer_pattern": ("swa", "attn", "attn"),
                                 "n_layers": 14},
             dict(first_dense=2, every_n_layers=2))]
    return out


def config_pair(name, kw, moe_kw):
    kw = dict(kw)
    reduced = kw.pop("reduced", False)
    jcfg, cfg = j_get_config(name), get_config(name)
    if reduced:
        jcfg, cfg = j_reduce_config(jcfg), reduce_config(cfg)
    if moe_kw:
        kw_j = dict(kw, moe=dataclasses.replace(jcfg.moe, **moe_kw))
        kw = dict(kw, moe=dataclasses.replace(cfg.moe, **moe_kw))
        return jcfg.with_(**kw_j), cfg.with_(**kw)
    return jcfg.with_(**kw), cfg.with_(**kw)


@pytest.mark.parametrize("name,kw,moe_kw", split_cases())
def test_jax_stack_split_is_the_reference_stacks(name, kw, moe_kw):
    jcfg, cfg = config_pair(name, kw, moe_kw)
    st = JStack(jcfg)
    assert jax_stack_split(cfg) == (st.n_head, st.period, st.n_full,
                                    st.tail_start)
    assert [cfg.is_moe_layer(i) for i in range(cfg.n_layers)] == \
        [jcfg.is_moe_layer(i) for i in range(jcfg.n_layers)]


def build_moe_pair(moe_kw=None, n_layers=None, seed=0):
    jcfg = j_apply_sparsity(j_reduce_config(j_get_config("qwen2-moe-a2.7b")),
                            backend="auto", **SP)
    cfg = apply_sparsity(reduce_config(get_config("qwen2-moe-a2.7b")), **SP)
    if moe_kw:
        jcfg = jcfg.with_(moe=dataclasses.replace(jcfg.moe, **moe_kw))
        cfg = cfg.with_(moe=dataclasses.replace(cfg.moe, **moe_kw))
    if n_layers:
        jcfg, cfg = jcfg.with_(n_layers=n_layers), cfg.with_(
            n_layers=n_layers)
    jm = JLMModel(jcfg)
    jp = jm.init(jax.random.PRNGKey(seed))
    tm = LMModel(cfg, device="cpu")
    tree = jax_tree_to_numpy(jp)
    load_jax_params(tm, tree)
    return jm, jp, tm, tree


@pytest.fixture(scope="module")
def pair():
    return build_moe_pair()


def test_bridge_names_every_moe_leaf(pair):
    jm, jp, tm, tree = pair
    flat = flatten_jax_tree(tm.cfg, tree)
    assert set(flat) == set(tm.state_dict())
    assert "stack.layers.1.ffn.experts.down.w_data" in flat
    assert flat["stack.layers.0.ffn.experts.gate.w_data"].shape == \
        tuple(tm.stack.layers[0].ffn.experts.gate["w_data"].shape)
    n_jax = sum(int(np.prod(l.shape)) for l in jax.tree_util.tree_leaves(jp))
    assert tm.n_params() == n_jax
    assert tm.stack.layers[0].ffn.router.dtype == torch.float32


def test_first_dense_and_cadence_split_loads_and_matches():
    """Two dense layers first, then MoE on every other layer: the
    reference keeps a head layer, scanned periods and a tail layer, and
    the bridge puts every leaf back in its layer."""
    jm, jp, tm, _ = build_moe_pair(dict(first_dense=2, every_n_layers=2),
                                   n_layers=6, seed=1)
    assert [l.is_moe for l in tm.stack.layers] == [False, False, True,
                                                   False, True, False]
    # a head layer, two scanned periods of two layers, a tail layer
    assert jax_stack_split(tm.cfg) == (1, 2, 2, 5)
    tokens = np.random.default_rng(3).integers(0, 997, (2, 9))
    jl, jaux = jm.forward(jp, {"tokens": jnp.asarray(tokens, jnp.int32)})
    with topk_margins(tm):
        tl, taux = tm.forward(tokens)
    assert_close(tl.numpy(), jl)
    assert abs(float(taux) - float(jaux)) <= RTOL * abs(float(jaux))


# -- the reduced qwen2-moe model ---------------------------------------------

def test_reduced_logits_and_aux_match_reference(pair):
    jm, jp, tm, _ = pair
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, tm.cfg.vocab_size, (2, 11)).astype(np.int32)
    jl, jaux = jm.forward(jp, {"tokens": jnp.asarray(tokens)})
    with topk_margins(tm):
        tl, taux = tm.forward(tokens)
    assert_close(tl.numpy(), jl)
    assert abs(float(taux) - float(jaux)) <= RTOL * abs(float(jaux))
    jcache = jm.init_cache(2, 16, jnp.float32)
    want, _ = jm.prefill(jp, {"tokens": jnp.asarray(tokens)}, jcache)
    with topk_margins(tm):
        got, _ = tm.prefill(tokens, tm.init_cache(2, 16, torch.float32))
    assert_close(got.numpy(), want)


def test_reduced_paged_decode_matches_reference(pair):
    jm, jp, tm, _ = pair
    page, n_blocks = 4, 9
    jpages = jm.init_pages(n_blocks, page, jnp.float32)
    tpages = tm.init_pages(n_blocks, page, torch.float32)
    bt = np.array([[1, 2, -1], [3, 4, 5], [-1, -1, -1]], np.int32)
    pos = np.array([0, 5, 0], np.int32)
    rng = np.random.default_rng(1)
    decode = jax.jit(jm.decode_step_paged)
    with topk_margins(tm):
        for _ in range(4):
            toks = rng.integers(0, tm.cfg.vocab_size, (3, 1)).astype(
                np.int32)
            want, jpages = decode(jp, jnp.asarray(toks), jpages,
                                  jnp.asarray(bt), jnp.asarray(pos))
            got, tpages = tm.decode_step_paged(toks, tpages, bt, pos)
            assert_close(got.numpy()[:2], np.asarray(want)[:2])
            pos = pos + np.array([1, 1, 0], np.int32)


def test_greedy_streams_match_reference_engine_and_sequential(pair):
    jm, jp, tm, _ = pair
    reqs = RequestStream(tm.cfg.vocab_size, 6, prompt_lens=(4, 8, 12),
                         gen_lens=(2, 4, 6, 8), seed=0).requests()
    jeng = JContinuousEngine(jm, jp, page_size=4, max_slots=3,
                             max_request_len=20)
    eng = ContinuousEngine(tm, page_size=4, max_slots=3, max_request_len=20)
    for r in reqs:
        jeng.submit(r["prompt"], r["max_new_tokens"])
        eng.submit(r["prompt"], r["max_new_tokens"])
    want = jeng.drain()
    with topk_margins(tm):
        got = eng.drain()
        seq = run_sequential(tm, reqs, cache_len=eng.gather_tokens)
    assert set(got) == set(want) == {r["rid"] for r in reqs}
    for r in reqs:
        rid = r["rid"]
        np.testing.assert_array_equal(got[rid], np.asarray(want[rid]))
        np.testing.assert_array_equal(got[rid], seq[rid])
        assert len(got[rid]) == r["max_new_tokens"]
