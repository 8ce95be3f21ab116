"""DeepSeek-V2's multi-head latent attention (MLA) and its MoE layers, the
port against the reference, on the CPU.

The reduced deepseek-v2-236b (3 layers: dense layer 0, then MoE with 8
experts, top-2, one shared; MLA with kv rank 32, q rank 32, rope 8, nope
16, v 16), the reference's weights through ``load_jax_params``.  MLA's
formulation follows the query length, and its three forms sum in
different orders, so each is held against the reference's own: a decode
step (S == 1) the absorbed form, contiguous and paged; a prefill the
naive form; a prefill past ``CHUNK_THRESHOLD`` keys the chunked online
softmax (the thresholds shrunk on both sides).  Tolerances: 1e-5 *
max|ref| for logits and caches, 1e-4 for the loss and gradients; every
routed comparison asserts top-k router margins of at least 1e-4
(``test_torch_moe.topk_margins``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattn
from repro_torch.models import attention as tattn
from repro_torch.serve import ContinuousEngine, run_sequential
from repro_torch.data import RequestStream

from test_torch_archs import (FWD_RTOL, arch_batch, assert_caches_close,
                              assert_close, build_arch_pair,
                              check_forward_and_two_sgd_steps,
                              check_prefill_decode, jax_cache_by_layer)
from test_torch_moe import topk_margins

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def pair():
    return build_arch_pair("deepseek-v2-236b")


def test_mla_layers_and_parameters_are_the_reference_layout(pair):
    _, jp, tm, _ = pair
    cfg = tm.cfg
    assert [l.kind for l in tm.stack.layers] == ["mla"] * 3
    assert [l.is_moe for l in tm.stack.layers] == [False, True, True]
    mla = tm.stack.layers[0].mixer
    m = cfg.mla
    assert tuple(mla.wk_b.shape) == (cfg.n_heads, m.kv_lora_rank,
                                     m.nope_head_dim)
    assert tuple(mla.wv_b.shape) == (cfg.n_heads, m.kv_lora_rank,
                                     m.v_head_dim)
    np.testing.assert_array_equal(
        mla.wk_b.numpy(), np.asarray(jp["stack"]["head"][0]["mixer"]["wk_b"]))
    cache = tm.init_cache(2, 8, torch.float32)
    assert set(cache[0]) == {"ckv", "krope", "pos"}
    assert tuple(cache[0]["ckv"].shape) == (2, 8, m.kv_lora_rank)


def test_prefill_and_contiguous_decode_match_reference(pair):
    jm, jp, tm, _ = pair
    batch = arch_batch(tm.cfg, seed=4)
    with topk_margins(tm):
        check_prefill_decode(jm, jp, tm, batch)


def test_forward_loss_and_gradients_of_two_sgd_steps_match_reference(pair):
    jm, jp, tm, _ = pair
    batch = arch_batch(tm.cfg, seed=2)
    with topk_margins(tm):
        check_forward_and_two_sgd_steps(jm, jp, tm, batch)


def test_paged_decode_matches_reference_and_the_contiguous_decode(pair):
    """The absorbed form through the page pools (``paged_cache_update``
    over the ``ckv``/``krope``/``pos`` leaves): the reference's paged
    decode, and the port's own contiguous decode of the same rows."""
    jm, jp, tm, _ = pair
    page, n_blocks = 4, 9
    jpages = jm.init_pages(n_blocks, page, jnp.float32)
    tpages = tm.init_pages(n_blocks, page, torch.float32)
    assert set(tpages[0]) == {"ckv", "krope", "pos"}
    # row 0 from position 0 in blocks [1, 2]; row 1 from position 0 in
    # blocks [3, 4, 5]; row 2 an inactive slot
    bt = np.array([[1, 2, -1], [3, 4, 5], [-1, -1, -1]], np.int32)
    pos = np.zeros(3, np.int32)
    cache = tm.init_cache(2, 12, torch.float32)
    rng = np.random.default_rng(5)
    decode = jax.jit(jm.decode_step_paged)
    with topk_margins(tm):
        for i in range(6):
            toks = rng.integers(0, tm.cfg.vocab_size, (3, 1)).astype(
                np.int32)
            want, jpages = decode(jp, jnp.asarray(toks), jpages,
                                  jnp.asarray(bt), jnp.asarray(pos))
            got, tpages = tm.decode_step_paged(toks, tpages, bt, pos)
            assert_close(got.numpy()[:2], np.asarray(want)[:2], FWD_RTOL,
                         f"paged step {i}")
            contig, cache = tm.decode_step(toks[:2], cache, i)
            assert_close(contig.numpy(), got.numpy()[:2], FWD_RTOL,
                         f"contiguous step {i}")
            pos = pos + np.array([1, 1, 0], np.int32)
    # the pools, the trash block 0 aside
    want = jax_cache_by_layer(tm.cfg, jpages)
    for i in range(tm.cfg.n_layers):
        for name in ("ckv", "krope", "pos"):
            got = tpages[i][name].numpy()[1:]
            ref = want[f"stack.layers.{i}.{name}"][1:]
            if name == "pos":
                np.testing.assert_array_equal(got, ref)
            else:
                assert_close(got, ref, FWD_RTOL, f"layer {i} {name}")


def test_chunked_prefill_branch_matches_reference(pair, monkeypatch):
    """Past CHUNK_THRESHOLD keys the prefill runs the online softmax over
    key chunks; shrunk thresholds on both sides make it run here."""
    jm, jp, tm, _ = pair
    batch = arch_batch(tm.cfg, B=1, S=11, seed=6)
    single, _ = tm.prefill(batch["tokens"], tm.init_cache(1, 11,
                                                          torch.float32))
    for mod in (jattn, tattn):
        monkeypatch.setattr(mod, "CHUNK_THRESHOLD", 8)
        monkeypatch.setattr(mod, "KV_CHUNK", 5)
    jcache = jm.init_cache(1, 11, jnp.float32)
    want, jcache = jax.jit(jm.prefill)(
        jp, {"tokens": jnp.asarray(batch["tokens"])}, jcache)
    tcache = tm.init_cache(1, 11, torch.float32)
    with topk_margins(tm):
        got, tcache = tm.prefill(batch["tokens"], tcache)
    assert_close(got.numpy(), want, FWD_RTOL, "chunked prefill")
    assert_caches_close(tm, tcache, jcache, "chunked prefill")
    assert_close(got.numpy(), single.numpy(), FWD_RTOL, "single pass")


def test_prefill_chunks_match_single_shot_prefill(pair):
    """``prefill_chunk`` (the continuous engine's chunked prefill, a
    ragged last chunk of pad rows at position -1) against one prefill of
    the whole prompt, and the chunked engine's greedy streams against
    ``run_sequential``."""
    _, _, tm, _ = pair
    tokens = arch_batch(tm.cfg, B=1, S=11, seed=7)["tokens"]
    want, wcache = tm.prefill(tokens, tm.init_cache(1, 12, torch.float32))
    cache = tm.init_cache(1, 12, torch.float32)
    for start in range(0, 11, 4):
        n = min(4, 11 - start)
        piece = np.zeros((1, 4), np.int32)
        piece[:, :n] = tokens[:, start:start + n]
        got, cache = tm.prefill_chunk(piece, cache, start, n)
    assert_close(got.numpy(), want.numpy(), FWD_RTOL, "chunked logits")
    for name in ("ckv", "krope"):
        assert_close(cache[0][name][:, :11].numpy(),
                     wcache[0][name][:, :11].numpy(), FWD_RTOL, name)
    reqs = RequestStream(tm.cfg.vocab_size, 3, prompt_lens=(5, 9),
                         gen_lens=(3, 4), seed=1).requests()
    eng = ContinuousEngine(tm, page_size=4, max_slots=2, max_request_len=16,
                           prefill_chunk=4)
    for r in reqs:
        eng.submit(r["prompt"], r["max_new_tokens"])
    with topk_margins(tm):
        got = eng.drain()
        want = run_sequential(tm, reqs, cache_len=eng.gather_tokens)
    for r in reqs:
        np.testing.assert_array_equal(got[r["rid"]], want[r["rid"]])
