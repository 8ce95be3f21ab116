"""Decoder stack: one module per layer, a Python loop over layers.

The port of ``repro/models/transformer.py`` for the layer kinds ported so
far ('attn', 'swa'), each with a gated MLP or, on the MoE cadence of
``cfg.moe``, a ``MoELayer``.  The reference scans its layers under
``lax.scan`` with stacked ``(T, ...)`` parameters; here every layer keeps
its own module, and ``jax_stack_split`` says how the reference grouped the
layers, which the weight bridge needs to split the stacked leaves.
Each layer resolves its projections against the config's plan with the
reference's per-layer seed offset (``offset_masked_seeds``): compact- and
chain-storage rules keep their seed, as in the reference, so all layers
share one layout per shape.  In training (``train=True`` with
gradients on and ``cfg.remat``) each layer runs under
``torch.utils.checkpoint`` and its forward is recomputed in the backward,
as the reference's ``jax.checkpoint`` of each scanned period.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.sparsity import SparsityPlan
from .attention import GQAttention, init_cache_gqa
from .common import RMSNorm
from .mlp import GatedMLP
from .moe import MoELayer

__all__ = ["DecoderLayer", "Stack", "jax_stack_split", "PORTED_KINDS"]

PORTED_KINDS = ("attn", "swa")


def _layer_rules(cfg: ModelConfig, idx: int) -> SparsityPlan:
    """Layer ``idx``'s plan: masked-storage rules get a per-layer seed so
    every layer samples its own graphs; compact- and chain-storage rules
    keep their seed (the reference's rule, bit for bit)."""
    return cfg.sparsity_rules.offset_masked_seeds(1000 * (idx + 1))


def _layer_paths(cfg: ModelConfig, idx: int) -> list[tuple[str, int, int]]:
    """(path, m, k) of every projection layer ``idx`` builds, sorted by
    path: the shapes the reference records for its plan signature."""
    d, hd = cfg.d_model, cfg.head_dim_
    mixer = f"l{idx}.{cfg.layer_kind(idx)}"
    out = [(f"{mixer}.wq", cfg.n_heads * hd, d),
           (f"{mixer}.wk", cfg.n_kv_heads * hd, d),
           (f"{mixer}.wv", cfg.n_kv_heads * hd, d),
           (f"{mixer}.wo", d, cfg.n_heads * hd)]

    def mlp(name, width):
        return [(f"{name}.gate", width, d), (f"{name}.up", width, d),
                (f"{name}.down", d, width)]

    if cfg.is_moe_layer(idx):
        moe = cfg.moe
        out += [(f"l{idx}.moe.experts.in", moe.d_expert, d),
                (f"l{idx}.moe.experts.out", d, moe.d_expert)]
        if moe.n_shared:
            out += mlp(f"l{idx}.moe.shared", moe.d_expert * moe.n_shared)
    else:
        out += mlp(f"l{idx}.mlp", cfg.d_ff)
    return sorted(out)


def jax_stack_split(cfg: ModelConfig) -> tuple[int, int, int, int]:
    """(n_head, period, n_full, tail_start) of the reference's ``Stack``:
    layers [0, n_head) run alone, then ``n_full`` scanned periods of
    ``period`` layers, then layers [tail_start, n_layers) alone.  The
    period is the lcm of the layer pattern and the MoE cadence, and a
    layer's scan signature is its kind, whether it is a MoE layer and,
    under an explicit plan, the resolved specs of its projections."""
    n = cfg.n_layers
    period = len(cfg.layer_pattern)
    if cfg.moe is not None:
        period = math.lcm(period, cfg.moe.every_n_layers)

    def signature(i):
        plan_sig = (_layer_rules(cfg, i).signature(_layer_paths(cfg, i))
                    if cfg.plan is not None else None)
        return cfg.layer_kind(i), cfg.is_moe_layer(i), plan_sig

    sigs = [signature(i) for i in range(n)]

    def periodic_from(h):
        return all(sigs[i] == sigs[h + (i - h) % period]
                   for i in range(h, n))

    h = 0
    while h < n and not periodic_from(h):
        h += 1
    n_full = (n - h) // period
    return h, period, n_full, h + n_full * period


class DecoderLayer(nn.Module):
    """norm -> attention -> residual; norm -> gated MLP or MoE ->
    residual.  ``device`` (in ``kw``) defaults to the card; without CUDA
    that raises, naming ``device="cpu"``."""

    def __init__(self, cfg: ModelConfig, idx: int, **kw):
        super().__init__()
        self.cfg = cfg
        self.idx = idx
        self.kind = cfg.layer_kind(idx)
        if self.kind not in PORTED_KINDS:
            raise NotImplementedError(
                f"layer kind {self.kind!r} is not yet ported; have "
                f"{PORTED_KINDS}")
        # one device for the norms, attention and FFN: the card unless
        # the caller names another
        device = kw["device"] = resolve_device(kw.get("device"))
        self.norm1 = RMSNorm(cfg.d_model, cfg.rmsnorm_eps, device=device)
        self.norm2 = RMSNorm(cfg.d_model, cfg.rmsnorm_eps, device=device)
        window = cfg.sliding_window if self.kind == "swa" else 0
        lcfg = cfg.with_(plan=_layer_rules(cfg, idx))
        self.mixer = GQAttention(lcfg, window=window,
                                 name=f"l{idx}.{self.kind}", **kw)
        self.is_moe = cfg.is_moe_layer(idx)
        if self.is_moe:
            self.ffn = MoELayer(cfg.d_model, cfg.moe, lcfg.sparsity_rules,
                                cfg.hidden_act, name=f"l{idx}.moe", **kw)
        else:
            self.ffn = GatedMLP(cfg.d_model, cfg.d_ff, lcfg.sparsity_rules,
                                cfg.hidden_act, name=f"l{idx}.mlp", **kw)

    def forward(self, x, positions, *, cache=None, block_tables=None,
                index: Optional[int] = None):
        """Returns (x, cache, aux): ``aux`` is the MoE layer's load-balance
        loss, None for a gated MLP.  With a cache (prefill and decode) the
        MoE layer runs at full capacity, as the reference's."""
        h, cache = self.mixer(self.norm1(x), positions, cache=cache,
                              block_tables=block_tables, index=index)
        x = x + h
        if self.is_moe:
            h2, aux = self.ffn(self.norm2(x), full_capacity=cache is not None)
            return x + h2, cache, aux
        return x + self.ffn(self.norm2(x)), cache, None

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
    """The decoder layers, run in order, all on one device (``device`` in
    ``kw``, the card by default)."""

    def __init__(self, cfg: ModelConfig, **kw):
        super().__init__()
        self.cfg = cfg
        kw["device"] = resolve_device(kw.get("device"))
        self.layers = nn.ModuleList(
            DecoderLayer(cfg, i, **kw) for i in range(cfg.n_layers))

    def forward(self, x, positions, *, caches=None, block_tables=None,
                index: Optional[int] = None, train: bool = False):
        """Returns (x, caches, aux); ``caches`` is one dict per layer
        (contiguous caches, or paged pools with ``block_tables``), ``aux``
        the sum of the MoE layers' load-balance losses (float32, 0 without
        MoE layers).  ``train`` (no caches) recomputes each layer in the
        backward when ``cfg.remat``."""
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        remat = (train and caches is None and self.cfg.remat
                 and torch.is_grad_enabled())
        for i, layer in enumerate(self.layers):
            if remat:
                x, a = checkpoint(lambda h, lyr=layer: lyr(h, positions)[::2],
                                  x, use_reentrant=False)
            else:
                c = caches[i] if caches is not None else None
                x, c, a = layer(x, positions, cache=c,
                                block_tables=block_tables, index=index)
                if caches is not None:
                    caches[i] = c
            if a is not None:
                aux = aux + a
        return x, caches, aux

    def init_cache(self, batch: int, cache_len: int, dtype=torch.bfloat16,
                   *, full_length: bool = False, device=None) -> list:
        return [l.init_cache(batch, cache_len, dtype, full_length=full_length,
                             device=device) for l in self.layers]

    def init_pages(self, n_blocks: int, page_size: int, dtype=torch.bfloat16,
                   device=None) -> list:
        return [l.init_pages(n_blocks, page_size, dtype, device=device)
                for l in self.layers]
