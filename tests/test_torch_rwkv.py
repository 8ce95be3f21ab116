"""RWKV-6 ("Finch"), the port against the reference, on the CPU.

The reduced rwkv6-7b (2 layers, d_model 64, 4 heads of 16, decay and mix
LoRA ranks 8), the reference's weights through ``load_jax_params``.
Held: the forward logits, a prefill and two decode steps (logits and
every layer's ``x_tm``, ``x_cm`` and float32 ``state``) within 1e-5 *
max|ref|, the loss and gradients of two SGD steps within 1e-4; a prefill
longer than ``SCAN_CHUNK`` (the scan's outer products formed a chunk at a
time) and ``wkv_scan`` at every chunk size against every step's own; the
layer and group norms' biased variances; the static engine's streams
against ``run_sequential`` and the continuous engine's refusal.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.rwkv import RWKVBlock as JRWKVBlock
from repro_torch.models import RWKVBlock
from repro_torch.models.common import SCAN_CHUNK
from repro_torch.models.rwkv import wkv_scan

from test_torch_archs import (arch_batch, assert_close, build_arch_pair,
                              check_forward_and_two_sgd_steps,
                              check_prefill_decode, check_recurrent_serving)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def pair():
    return build_arch_pair("rwkv6-7b")


def test_rwkv_layers_are_the_reference_layout(pair):
    _, jp, tm, _ = pair
    assert [l.kind for l in tm.stack.layers] == ["rwkv", "rwkv"]
    block = tm.stack.layers[0].rwkv
    assert isinstance(block, RWKVBlock)
    assert not hasattr(tm.stack.layers[0], "norm1")
    assert tuple(block.mix_w2.shape) == (5, 8, 64)
    jb = jp["stack"]["scan"]["j0"]["rwkv"]
    np.testing.assert_array_equal(block.mix_w2.numpy(),
                                  np.asarray(jb["mix_w2"][0]))
    cache = tm.init_cache(2, 8, torch.float32)
    assert set(cache[0]) == {"x_tm", "x_cm", "state"}
    assert tuple(cache[0]["state"].shape) == (2, 4, 16, 16)


def test_norms_use_the_biased_variance():
    """``jnp.var`` is biased; so are the port's ``_ln`` and
    ``_group_norm`` (``torch.var`` defaults to the unbiased one, which
    gives plausible numbers too)."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 3, 64)).astype(np.float32) * 3 + 1
    scale = rng.standard_normal(64).astype(np.float32)
    bias = rng.standard_normal(64).astype(np.float32)
    want = JRWKVBlock._ln(jnp.asarray(x), jnp.asarray(scale),
                          jnp.asarray(bias))
    got = RWKVBlock._ln(torch.tensor(x), torch.tensor(scale),
                        torch.tensor(bias))
    assert_close(got.numpy(), want, 1e-6, "ln")
    y = rng.standard_normal((2, 3, 4, 16)).astype(np.float32)
    params = {"gn_scale": jnp.asarray(scale), "gn_bias": jnp.asarray(bias)}
    jblock = JRWKVBlock.__new__(JRWKVBlock)
    want = jblock._group_norm(jnp.asarray(y), params)
    block = RWKVBlock.__new__(RWKVBlock)
    torch.nn.Module.__init__(block)
    block.gn_scale = torch.nn.Parameter(torch.tensor(scale))
    block.gn_bias = torch.nn.Parameter(torch.tensor(bias))
    assert_close(block._group_norm(torch.tensor(y)).detach().numpy(), want,
                 1e-6, "group norm")


def test_prefill_and_decode_match_reference(pair):
    jm, jp, tm, _ = pair
    check_prefill_decode(jm, jp, tm, arch_batch(tm.cfg, seed=4))


def test_prefill_past_one_scan_chunk_matches_reference(pair):
    """A prompt of ``SCAN_CHUNK`` + 6 tokens: the scan crosses a chunk
    boundary, then decodes from the state it left."""
    jm, jp, tm, _ = pair
    check_prefill_decode(jm, jp, tm, arch_batch(tm.cfg, B=1,
                                                S=SCAN_CHUNK + 6, seed=5),
                         cache_len=SCAN_CHUNK + 8, n_decode=1)


@pytest.mark.parametrize("chunk", [1, 5, SCAN_CHUNK])
def test_wkv_scan_chunks_give_every_steps_own_products(chunk):
    """The chunked scan forms the same products as one formed a step at a
    time, or all at once: the same numbers, ragged last chunk included."""
    g = torch.Generator().manual_seed(3)
    B, S, H, hs = 2, 13, 3, 4
    r, k, v = (torch.randn((B, S, H, hs), generator=g) for _ in range(3))
    wdec = torch.rand((B, S, H, hs), generator=g)
    u = torch.randn((H, hs), generator=g)
    s0 = torch.randn((B, H, hs, hs), generator=g)
    want = wkv_scan(r, k, v, wdec, u, s0, chunk=S)
    got = wkv_scan(r, k, v, wdec, u, s0, chunk=chunk)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def indexed_wkv_scan(r, k, v, wdec, u, s, chunk):
    """``wkv_scan`` with its steps taken by indexing: the loop it
    replaced."""
    u = u[None, :, :, None]
    ys = []
    for t0 in range(0, k.shape[1], chunk):
        kv = k[:, t0:t0 + chunk, :, :, None] * v[:, t0:t0 + chunk, :, None, :]
        ukv = u * kv
        for t in range(kv.shape[1]):
            ys.append(torch.einsum("bhk,bhkv->bhv", r[:, t0 + t],
                                   s + ukv[:, t]))
            s = wdec[:, t0 + t, :, :, None] * s + kv[:, t]
    return torch.stack(ys, dim=1), s


@pytest.mark.parametrize("chunk", [1, 4])
def test_wkv_scan_gradients_equal_the_indexed_loops(chunk):
    """``wkv_scan`` takes its steps with ``unbind``: outputs and every
    input's gradient equal the indexing loop's, bit for bit."""
    g = torch.Generator().manual_seed(5)
    B, S, H, hs = 2, 9, 3, 4
    args = [torch.randn((B, S, H, hs), generator=g) for _ in range(3)]
    args += [torch.rand((B, S, H, hs), generator=g),
             torch.randn((H, hs), generator=g),
             torch.randn((B, H, hs, hs), generator=g)]
    cot = torch.randn((B, S, H, hs), generator=g)
    runs = []
    for scan in (wkv_scan, indexed_wkv_scan):
        xs = [a.clone().requires_grad_() for a in args]
        y, last = scan(*xs, chunk=chunk)
        ((y * cot).sum() + last.sum()).backward()
        runs.append([y, last] + [x.grad for x in xs])
    for got, want in zip(*runs):
        assert torch.equal(got, want)


def test_forward_loss_and_gradients_of_two_sgd_steps_match_reference(pair):
    jm, jp, tm, _ = pair
    check_forward_and_two_sgd_steps(jm, jp, tm, arch_batch(tm.cfg, seed=2))


def test_static_engine_serves_and_the_continuous_engine_refuses(pair):
    jm, jp, tm, _ = pair
    check_recurrent_serving(jm, jp, tm)


def test_serve_driver_refuses_the_continuous_engine(capsys):
    """``--engine continuous`` on a recurrent arch exits with the
    reference's message; ``--engine static`` serves."""
    from repro_torch.launch import serve

    argv = ["--arch", "rwkv6-7b", "--reduced", "--device", "cpu",
            "--requests", "2", "--batch", "2", "--prompt-len", "4",
            "--gen", "2"]
    with pytest.raises(SystemExit) as err:
        serve.main(argv)
    assert "static engine (--engine static)" in str(err.value.code)
    serve.main(argv + ["--engine", "static"])
    assert "arch=rwkv6-7b-smoke" in capsys.readouterr().out
