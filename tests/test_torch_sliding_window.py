"""Decode across a sliding-window ring, the port against the reference on
the CPU.

A rolling ``swa`` cache holds ``sliding_window`` (16 in the reduced
configs) slots, written at ``position % window``.  The prefill test of
``test_torch_model.py`` stops at the prefill; here a prefill of 10 tokens
is followed by 20 contiguous decode steps to position 29, so the ring
wraps and every later step overwrites a slot, with a cache of 40 (the
global ``attn`` layers keep all 40).  Reduced tinyllama with the layer
pattern ('swa', 'attn'), and reduced gemma3-4b at 7 layers (one period of
5 ``swa`` layers to one ``attn`` and one more, as ``test_torch_archs.py``
keeps it): each call's logits and, after the last step, every cache leaf
within 1e-5 * max|ref|.
"""
import pytest

from test_torch_archs import arch_batch, build_arch_pair, check_prefill_decode

PROMPT, STEPS, CACHE = 10, 20, 40


@pytest.mark.parametrize("arch, kw", [
    ("tinyllama-1.1b", {"layer_pattern": ("swa", "attn")}),
    ("gemma3-4b", {"n_layers": 7}),
])
def test_decode_past_the_window_matches_reference(arch, kw):
    jm, jp, tm, _ = build_arch_pair(arch, seed=3, **kw)
    assert tm.cfg.sliding_window == 16
    assert "swa" in tm.cfg.layer_pattern
    assert PROMPT + STEPS > tm.cfg.sliding_window
    check_prefill_decode(jm, jp, tm, arch_batch(tm.cfg, B=2, S=PROMPT),
                         cache_len=CACHE, n_decode=STEPS)
