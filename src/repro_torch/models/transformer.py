"""Decoder stack: one module per layer, a Python loop over layers.

The port of ``repro/models/transformer.py`` for the layer kinds the
serving slice runs ('attn', 'swa').  The reference scans its layers under
``lax.scan`` with stacked ``(T, ...)`` parameters; here every layer keeps
its own module, and ``jax_stack_split`` says how the reference grouped the
layers, which the weight bridge needs to split the stacked leaves.
Compact-storage layers keep the plan's seed, as in the reference, so all
layers share one layout per shape.  In training (``train=True`` with
gradients on and ``cfg.remat``) each layer runs under
``torch.utils.checkpoint`` and its forward is recomputed in the backward,
as the reference's ``jax.checkpoint`` of each scanned period.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from .attention import GQAttention, init_cache_gqa
from .common import RMSNorm
from .mlp import GatedMLP

__all__ = ["DecoderLayer", "Stack", "jax_stack_split", "PORTED_KINDS"]

PORTED_KINDS = ("attn", "swa")


def jax_stack_split(cfg: ModelConfig) -> tuple[int, int, int, int]:
    """(n_head, period, n_full, tail_start) of the reference's ``Stack``:
    layers [0, n_head) run alone, then ``n_full`` scanned periods of
    ``period`` layers, then layers [tail_start, n_layers) alone (the
    reference's rule without MoE cadence or per-layer plans)."""
    n = cfg.n_layers
    period = len(cfg.layer_pattern)

    def periodic_from(h):
        return all(cfg.layer_kind(i) == cfg.layer_kind(h + (i - h) % period)
                   for i in range(h, n))

    h = 0
    while h < n and not periodic_from(h):
        h += 1
    n_full = (n - h) // period
    return h, period, n_full, h + n_full * period


class DecoderLayer(nn.Module):
    """norm -> attention -> residual; norm -> gated MLP -> residual."""

    def __init__(self, cfg: ModelConfig, idx: int, **kw):
        super().__init__()
        self.cfg = cfg
        self.idx = idx
        self.kind = cfg.layer_kind(idx)
        if self.kind not in PORTED_KINDS:
            raise NotImplementedError(
                f"layer kind {self.kind!r} is not yet ported; have "
                f"{PORTED_KINDS}")
        device = kw.get("device")
        self.norm1 = RMSNorm(cfg.d_model, cfg.rmsnorm_eps, device=device)
        self.norm2 = RMSNorm(cfg.d_model, cfg.rmsnorm_eps, device=device)
        window = cfg.sliding_window if self.kind == "swa" else 0
        self.mixer = GQAttention(cfg, window=window,
                                 name=f"l{idx}.{self.kind}", **kw)
        self.ffn = GatedMLP(cfg.d_model, cfg.d_ff, cfg.sparsity,
                            cfg.hidden_act, name=f"l{idx}.mlp", **kw)

    def forward(self, x, positions, *, cache=None, block_tables=None,
                index: Optional[int] = None):
        """Returns (x, cache)."""
        h, cache = self.mixer(self.norm1(x), positions, cache=cache,
                              block_tables=block_tables, index=index)
        x = x + h
        return x + self.ffn(self.norm2(x)), cache

    def init_cache(self, batch: int, cache_len: int, dtype=torch.bfloat16,
                   *, full_length: bool = False, device=None) -> dict:
        """``full_length`` skips the sliding-window cap on 'swa' caches (the
        paged prefill's temp cache slots are absolute positions)."""
        L = cache_len
        if self.kind == "swa" and not full_length:
            L = min(cache_len, self.cfg.sliding_window)
        return init_cache_gqa(batch, L, self.cfg.n_kv_heads,
                              self.cfg.head_dim_, dtype, device=device)

    def init_pages(self, n_blocks: int, page_size: int, dtype=torch.bfloat16,
                   device=None) -> dict:
        """(n_blocks, page_size, ...) pools; sliding-window layers get
        full-size pools too (the window is a mask in paged mode)."""
        return self.init_cache(n_blocks, page_size, dtype, full_length=True,
                               device=device)


class Stack(nn.Module):
    """The decoder layers, run in order."""

    def __init__(self, cfg: ModelConfig, **kw):
        super().__init__()
        self.cfg = cfg
        self.layers = nn.ModuleList(
            DecoderLayer(cfg, i, **kw) for i in range(cfg.n_layers))

    def forward(self, x, positions, *, caches=None, block_tables=None,
                index: Optional[int] = None, train: bool = False):
        """Returns (x, caches); ``caches`` is one dict per layer (contiguous
        caches, or paged pools with ``block_tables``).  ``train`` (no
        caches) recomputes each layer in the backward when ``cfg.remat``."""
        if train and caches is None and self.cfg.remat \
                and torch.is_grad_enabled():
            for layer in self.layers:
                x = checkpoint(lambda h, lyr=layer: lyr(h, positions)[0], x,
                               use_reentrant=False)
            return x, None
        for i, layer in enumerate(self.layers):
            c = caches[i] if caches is not None else None
            x, c = layer(x, positions, cache=c, block_tables=block_tables,
                         index=index)
            if caches is not None:
                caches[i] = c
        return x, caches

    def init_cache(self, batch: int, cache_len: int, dtype=torch.bfloat16,
                   *, full_length: bool = False, device=None) -> list:
        return [l.init_cache(batch, cache_len, dtype, full_length=full_length,
                             device=device) for l in self.layers]

    def init_pages(self, n_blocks: int, page_size: int, dtype=torch.bfloat16,
                   device=None) -> list:
        return [l.init_pages(n_blocks, page_size, dtype, device=device)
                for l in self.layers]
