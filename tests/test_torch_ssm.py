"""Jamba's Mamba mixer (and its hybrid stack), the port against the
reference, on the CPU.

The reduced jamba-1.5-large-398b cut to 9 layers: one period of the
reference's scan (7 Mamba layers and one attention layer at position 3,
MoE with 8 experts, top-2, on the odd layers) and one tail layer, the
reference's head / period / tail split; d_state 4, d_conv 4, expand 2.
The reference's weights go through ``load_jax_params``.  Held: the
forward logits, a prefill and two decode steps (logits, the conv window
and the float32 state of every Mamba layer, the attention layer's KV)
within 1e-5 * max|ref|, the loss and gradients of two SGD steps within
1e-4, top-k router margins of at least 1e-4; a prefill longer than
``SCAN_CHUNK`` (the scan's decays and inputs formed a chunk at a time)
and ``selective_scan`` at every chunk size against every step's own; the
static engine's streams against ``run_sequential`` and the continuous
engine's refusal.
"""
import jax
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduce_config
from repro_torch.models import MambaMixer, jax_stack_split
from repro_torch.models.common import SCAN_CHUNK
from repro_torch.models.ssm import selective_scan, softplus

from test_torch_archs import (arch_batch, build_arch_pair,
                              check_forward_and_two_sgd_steps,
                              check_prefill_decode, check_recurrent_serving)
from test_torch_moe import topk_margins

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def pair():
    return build_arch_pair("jamba-1.5-large-398b", n_layers=9)


def test_hybrid_stack_is_the_reference_layout(pair):
    _, jp, tm, _ = pair
    kinds = [l.kind for l in tm.stack.layers]
    assert kinds == ["mamba"] * 3 + ["attn"] + ["mamba"] * 5
    assert [l.is_moe for l in tm.stack.layers] == [i % 2 == 1
                                                   for i in range(9)]
    assert jax_stack_split(tm.cfg) == (0, 8, 1, 8)
    mixer = tm.stack.layers[0].mixer
    assert isinstance(mixer, MambaMixer)
    names = {n for n, _ in mixer.named_parameters()}
    assert {"in.w_data", "x.w", "out.w_data", "conv_w", "conv_b", "dt_w",
            "dt_bias", "a_log", "d"} <= names, names
    jmix = jp["stack"]["scan"]["j0"]["mixer"]
    np.testing.assert_array_equal(mixer.a_log.numpy(),
                                  np.asarray(jmix["a_log"][0]))
    cache = tm.init_cache(2, 8, torch.float32)
    assert set(cache[0]) == {"conv", "h"}
    assert tuple(cache[0]["h"].shape) == (2, mixer.d_inner, 4)
    assert cache[0]["h"].dtype == torch.float32


def test_softplus_is_exact_past_the_torch_threshold():
    """``jax.nn.softplus`` is log(1 + e^x) everywhere; ``F.softplus``
    returns x above 20.  The port's dt bias and delta use the exact form."""
    x = np.linspace(-30.0, 30.0, 241).astype(np.float32)
    np.testing.assert_allclose(softplus(torch.tensor(x)).numpy(),
                               np.asarray(jax.nn.softplus(x)), rtol=1e-6)
    mixer = MambaMixer(reduce_config(get_config("jamba-1.5-large-398b")),
                       device="cpu")
    dt = softplus(mixer.dt_bias)
    assert float(dt.min()) >= 0.001 * (1 - 1e-5)
    assert float(dt.max()) <= 0.1 * (1 + 1e-5)


def test_prefill_and_decode_match_reference(pair):
    jm, jp, tm, _ = pair
    with topk_margins(tm):
        check_prefill_decode(jm, jp, tm, arch_batch(tm.cfg, seed=4))


def test_prefill_past_one_scan_chunk_matches_reference(pair):
    """A prompt of ``SCAN_CHUNK`` + 6 tokens: every Mamba layer's scan
    crosses a chunk boundary, then decodes from the state it left."""
    jm, jp, tm, _ = pair
    with topk_margins(tm):
        check_prefill_decode(jm, jp, tm, arch_batch(tm.cfg, B=1,
                                                    S=SCAN_CHUNK + 6,
                                                    seed=5),
                             cache_len=SCAN_CHUNK + 8, n_decode=1)


@pytest.mark.parametrize("chunk", [1, 5, SCAN_CHUNK])
def test_selective_scan_chunks_give_every_steps_own_products(chunk):
    """The chunked scan forms the same decays and inputs as one formed a
    step at a time, or all at once: the same numbers, ragged last chunk
    included."""
    g = torch.Generator().manual_seed(3)
    B, S, di, ds = 2, 13, 6, 4
    delta = softplus(torch.randn((B, S, di), generator=g))
    a = -torch.rand((di, ds), generator=g) * 4
    xb = torch.randn((B, S, di), generator=g)
    b, c = (torch.randn((B, S, ds), generator=g) for _ in range(2))
    h0 = torch.randn((B, di, ds), generator=g)
    want = selective_scan(delta, a, xb, b, c, h0, chunk=S)
    got = selective_scan(delta, a, xb, b, c, h0, chunk=chunk)
    for x, y in zip(got, want):
        assert torch.equal(x, y)


def indexed_selective_scan(delta, a, xb, b, c, h, chunk):
    """``selective_scan`` with its steps taken by indexing: the loop it
    replaced."""
    ys = []
    for t0 in range(0, delta.shape[1], chunk):
        sl = slice(t0, t0 + chunk)
        da = torch.exp(delta[:, sl, :, None] * a)
        dbx = (delta[:, sl] * xb[:, sl])[..., None] * b[:, sl, None, :]
        for t in range(da.shape[1]):
            h = da[:, t] * h + dbx[:, t]
            ys.append(torch.einsum("bds,bs->bd", h, c[:, t0 + t]))
    return torch.stack(ys, dim=1), h


@pytest.mark.parametrize("chunk", [1, 4])
def test_selective_scan_gradients_equal_the_indexed_loops(chunk):
    """``selective_scan`` takes its steps with ``unbind``: outputs and
    every input's gradient equal the indexing loop's, bit for bit."""
    g = torch.Generator().manual_seed(5)
    B, S, di, ds = 2, 9, 6, 4
    args = [softplus(torch.randn((B, S, di), generator=g)),
            -torch.rand((di, ds), generator=g) * 4,
            torch.randn((B, S, di), generator=g),
            torch.randn((B, S, ds), generator=g),
            torch.randn((B, S, ds), generator=g),
            torch.randn((B, di, ds), generator=g)]
    cot = torch.randn((B, S, di), generator=g)
    runs = []
    for scan in (selective_scan, indexed_selective_scan):
        xs = [x.clone().requires_grad_() for x in args]
        y, last = scan(*xs, chunk=chunk)
        ((y * cot).sum() + last.sum()).backward()
        runs.append([y, last] + [x.grad for x in xs])
    for got, want in zip(*runs):
        assert torch.equal(got, want)


def test_forward_loss_and_gradients_of_two_sgd_steps_match_reference(pair):
    jm, jp, tm, _ = pair
    with topk_margins(tm):
        check_forward_and_two_sgd_steps(jm, jp, tm,
                                        arch_batch(tm.cfg, seed=2))


def test_static_engine_serves_and_the_continuous_engine_refuses(pair):
    """Requests of seed 1: the default seed's come within 2.6e-6 of a
    routing tie, under the 1e-4 margin every routed comparison needs (a
    batch of two and a batch of one may then route apart)."""
    jm, jp, tm, _ = pair
    with topk_margins(tm):
        check_recurrent_serving(jm, jp, tm, seed=1)
