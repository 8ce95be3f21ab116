"""The port's LMModel computes the reference's function on the same weights.

Reduced tinyllama with rbgp4 at 0.75 (``min_dim=64``: wq/wo/gate/up/down
compact, wk/wv dense): the JAX ``LMModel.init(PRNGKey(0))`` parameters go
through ``load_jax_params``, then prefill logits and four paged decode
steps are compared.  Tolerance: 1e-4 * max|ref| (float32 throughout, the
gap being summation order across a dozen matmuls).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import apply_sparsity as j_apply_sparsity
from repro.configs import get_config as j_get_config
from repro.configs import reduce_config as j_reduce_config
from repro.models import LMModel as JLMModel
from repro.sparsity import ChainWeight as JChain
from repro.sparsity import CompactWeight as JCompact
from repro.sparsity import DenseWeight as JDense
from repro_torch.bridge import load_jax_params
from repro_torch.configs import apply_sparsity, get_config, reduce_config
from repro_torch.models import LMModel
from repro_torch.models import attention as tattn
from repro_torch.sparsity import CompactWeight, DenseWeight

torch.set_num_threads(1)
RTOL = 1e-4


def jax_tree_to_numpy(node):
    """JAX params -> nested dicts/lists of numpy arrays (containers become
    their field dicts), the form ``load_jax_params`` takes."""
    if isinstance(node, (JCompact, JChain)):
        return {"w_data": np.asarray(node.w_data),
                "b": jax_tree_to_numpy(node.b)}
    if isinstance(node, JDense):
        return {"w": np.asarray(node.w), "b": jax_tree_to_numpy(node.b)}
    if isinstance(node, dict):
        return {k: jax_tree_to_numpy(v) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [jax_tree_to_numpy(v) for v in node]
    if node is None:
        return None
    return np.asarray(node)


def build_pair(sparsity=0.75):
    jcfg = j_apply_sparsity(j_reduce_config(j_get_config("tinyllama-1.1b")),
                            pattern="rbgp4", sparsity=sparsity,
                            backend="auto", min_dim=64)
    jm = JLMModel(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    cfg = apply_sparsity(reduce_config(get_config("tinyllama-1.1b")),
                         pattern="rbgp4", sparsity=sparsity, min_dim=64)
    tm = LMModel(cfg, device="cpu")
    tree = jax_tree_to_numpy(jp)
    load_jax_params(tm, tree)
    return jm, jp, tm, tree


@pytest.fixture(scope="module")
def pair():
    return build_pair()


def assert_close(got, want, rtol=RTOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want).max()
    assert err <= rtol * np.abs(want).max(), (err, np.abs(want).max())


def test_storage_kinds_follow_the_reference(pair):
    _, jp, tm, _ = pair
    layer = tm.stack.layers[0]
    jl = jp["stack"]["scan"]["j0"]
    for name, mod in [("wq", layer.mixer.wq), ("wk", layer.mixer.wk),
                      ("wv", layer.mixer.wv), ("wo", layer.mixer.wo)]:
        want = (CompactWeight if isinstance(jl["mixer"][name], JCompact)
                else DenseWeight)
        assert isinstance(mod.weight(), want), name
    assert isinstance(layer.mixer.wk.weight(), DenseWeight)
    assert isinstance(layer.ffn.down.weight(), CompactWeight)
    n_jax = sum(int(np.prod(l.shape)) for l in jax.tree_util.tree_leaves(jp))
    assert tm.n_params() == n_jax


def test_prefill_logits_match_reference(pair):
    jm, jp, tm, _ = pair
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, tm.cfg.vocab_size, (2, 11)).astype(np.int32)
    jcache = jm.init_cache(2, 16, jnp.float32)
    want, jcache = jm.prefill(jp, {"tokens": jnp.asarray(tokens)}, jcache)
    tcache = tm.init_cache(2, 16, torch.float32)
    got, tcache = tm.prefill(tokens, tcache)
    assert_close(got.numpy(), want)
    # the filled caches agree too (scanned (T, B, L, ...) vs per layer)
    for i in range(tm.cfg.n_layers):
        for name in ("k", "v"):
            assert_close(tcache[i][name].numpy(),
                         np.asarray(jcache["scan"]["j0"][name][i]))
        np.testing.assert_array_equal(
            tcache[i]["pos"].numpy(), np.asarray(jcache["scan"]["j0"]["pos"][i]))


def test_paged_decode_steps_match_reference(pair):
    jm, jp, tm, _ = pair
    page, n_blocks = 4, 9
    jpages = jm.init_pages(n_blocks, page, jnp.float32)
    tpages = tm.init_pages(n_blocks, page, torch.float32)
    # row 0 starts at position 0 in blocks [1, 2]; row 1 at position 5 in
    # blocks [3, 4, 5] (slots 0-4 empty); row 2 is an inactive slot
    bt = np.array([[1, 2, -1], [3, 4, 5], [-1, -1, -1]], np.int32)
    pos = np.array([0, 5, 0], np.int32)
    rng = np.random.default_rng(1)
    decode = jax.jit(jm.decode_step_paged)
    for _ in range(4):
        toks = rng.integers(0, tm.cfg.vocab_size, (3, 1)).astype(np.int32)
        want, jpages = decode(jp, jnp.asarray(toks), jpages,
                              jnp.asarray(bt), jnp.asarray(pos))
        got, tpages = tm.decode_step_paged(toks, tpages, bt, pos)
        assert_close(got.numpy()[:2], np.asarray(want)[:2])
        pos = pos + np.array([1, 1, 0], np.int32)
    for i in range(tm.cfg.n_layers):
        np.testing.assert_array_equal(
            tpages[i]["pos"].numpy()[1:],
            np.asarray(jpages["scan"]["j0"]["pos"][i])[1:])


def test_load_jax_params_rejects_a_wrong_shape(pair):
    _, _, tm, tree = pair
    bad = dict(tree, head=tree["head"][:, :-1])
    with pytest.raises(ValueError, match="head"):
        load_jax_params(tm, bad)
    layer = tree["stack"]["scan"]["j0"]
    bad_w = dict(layer["mixer"]["wq"], w_data=layer["mixer"]["wq"]["w_data"][..., :-1])
    bad_stack = {**tree["stack"], "scan": {"j0": {
        **layer, "mixer": {**layer["mixer"], "wq": bad_w}}}}
    with pytest.raises(ValueError, match="wq"):
        load_jax_params(tm, dict(tree, stack=bad_stack))
    with pytest.raises(ValueError, match="missing"):
        load_jax_params(tm, {k: v for k, v in tree.items() if k != "head"})


def test_chunked_attention_matches_single_pass(monkeypatch):
    """Prefill attention past CHUNK_THRESHOLD keys runs the online-softmax
    path; shrunk thresholds make it run here and agree with one pass."""
    _, _, tm, _ = build_pair(sparsity=0.5)
    tokens = np.random.default_rng(2).integers(0, 997, (1, 9)).astype(np.int32)
    want, _ = tm.prefill(tokens, tm.init_cache(1, 12, torch.float32))
    monkeypatch.setattr(tattn, "CHUNK_THRESHOLD", 8)
    monkeypatch.setattr(tattn, "KV_CHUNK", 5)
    got, _ = tm.prefill(tokens, tm.init_cache(1, 12, torch.float32))
    assert_close(got.numpy(), want.numpy(), rtol=1e-5)


def test_sliding_window_layers_match_reference():
    """'swa' layers (window 16 in the reduced config) on a prompt longer
    than the window."""
    jcfg = j_apply_sparsity(j_reduce_config(j_get_config("tinyllama-1.1b")),
                            pattern="rbgp4", sparsity=0.75, backend="auto",
                            min_dim=64).with_(layer_pattern=("swa", "attn"))
    jm = JLMModel(jcfg)
    jp = jm.init(jax.random.PRNGKey(3))
    cfg = apply_sparsity(reduce_config(get_config("tinyllama-1.1b")),
                         pattern="rbgp4", sparsity=0.75,
                         min_dim=64).with_(layer_pattern=("swa", "attn"))
    tm = LMModel(cfg, device="cpu")
    load_jax_params(tm, jax_tree_to_numpy(jp))
    tokens = np.random.default_rng(3).integers(0, 997, (1, 24)).astype(np.int32)
    want, _ = jm.prefill(jp, {"tokens": jnp.asarray(tokens)},
                         jm.init_cache(1, 30, jnp.float32))
    got, _ = tm.prefill(tokens, tm.init_cache(1, 30, torch.float32))
    assert_close(got.numpy(), want)
