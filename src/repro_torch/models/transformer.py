"""Decoder stack: one module per layer, a Python loop over layers.

The port of ``repro/models/transformer.py``, every layer kind of the
reference: 'attn' and 'swa' (``GQAttention``), 'mla' (``MLAttention``)
and 'mamba' (``MambaMixer``), each between two RMSNorms with a gated MLP
or, on the MoE cadence of ``cfg.moe``, a ``MoELayer``; and 'rwkv'
(``RWKVBlock``), a whole layer with its own norms and channel mix.  The
recurrent kinds ('mamba', 'rwkv') have no paged form: their O(1) state
has nothing to page, and ``init_pages`` and a paged call raise, naming
the static engine, as the reference's do.  The reference scans its layers
under ``lax.scan`` with stacked ``(T, ...)`` parameters; here every layer
keeps its own module, and ``jax_stack_split`` says how the reference
grouped the layers, which the weight bridge needs to split the stacked
leaves.  Each layer resolves its projections against the config's plan
with the reference's per-layer seed offset (``offset_masked_seeds``):
compact- and chain-storage rules keep their seed, as in the reference, so
all layers share one layout per shape.  In training (``train=True`` with
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
from .attention import GQAttention, MLAttention, init_cache_gqa, \
    init_cache_mla
from .common import RMSNorm
from .mlp import GatedMLP
from .moe import MoELayer
from .rwkv import RWKVBlock, init_cache_rwkv
from .ssm import MambaMixer, init_cache_mamba

__all__ = ["DecoderLayer", "Stack", "jax_stack_split", "LAYER_KINDS",
           "PAGED_KINDS"]

LAYER_KINDS = ("attn", "swa", "mla", "mamba", "rwkv")
#: the kinds with a paged cache (the continuous engine's)
PAGED_KINDS = ("attn", "swa", "mla")


def _layer_rules(cfg: ModelConfig, idx: int) -> SparsityPlan:
    """Layer ``idx``'s plan: masked-storage rules get a per-layer seed so
    every layer samples its own graphs; compact- and chain-storage rules
    keep their seed (the reference's rule, bit for bit)."""
    return cfg.sparsity_rules.offset_masked_seeds(1000 * (idx + 1))


def _layer_paths(cfg: ModelConfig, idx: int) -> list[tuple[str, int, int]]:
    """(path, m, k) of every projection layer ``idx`` builds, sorted by
    path: the reference's plan signature, recorded as the reference
    records it (the layer built on ``meta`` under ``recording_shapes``)."""
    from repro_torch.sparsity import recording_shapes

    with recording_shapes() as shapes:
        DecoderLayer(cfg, idx, device="meta")
    return [(path, m, k) for path, (m, k, _c) in sorted(shapes.items())]


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
    """norm -> mixer -> residual; norm -> gated MLP or MoE -> residual; or
    a whole RWKV layer.  ``device`` (in ``kw``) defaults to the card;
    without CUDA that raises, naming ``device="cpu"``."""

    def __init__(self, cfg: ModelConfig, idx: int, **kw):
        super().__init__()
        self.cfg = cfg
        self.idx = idx
        self.kind = cfg.layer_kind(idx)
        if self.kind not in LAYER_KINDS:
            raise ValueError(f"unknown layer kind {self.kind!r}; have "
                             f"{LAYER_KINDS}")
        # one device for every tensor of the layer: the card unless the
        # caller names another
        device = kw["device"] = resolve_device(kw.get("device"))
        lcfg = cfg.with_(plan=_layer_rules(cfg, idx))
        self.is_moe = cfg.is_moe_layer(idx)
        if self.kind == "rwkv":
            self.rwkv = RWKVBlock(lcfg, name=f"l{idx}", **kw)
            return
        nkw = dict(device=device,
                   dtype=kw.get("param_dtype", torch.float32))
        self.norm1 = RMSNorm(cfg.d_model, cfg.rmsnorm_eps, **nkw)
        self.norm2 = RMSNorm(cfg.d_model, cfg.rmsnorm_eps, **nkw)
        name = f"l{idx}.{self.kind}"
        if self.kind == "mla":
            self.mixer = MLAttention(lcfg, name=name, **kw)
        elif self.kind == "mamba":
            self.mixer = MambaMixer(lcfg, name=name, **kw)
        else:
            window = cfg.sliding_window if self.kind == "swa" else 0
            self.mixer = GQAttention(lcfg, window=window, name=name, **kw)
        if self.is_moe:
            self.ffn = MoELayer(cfg.d_model, cfg.moe, lcfg.sparsity_rules,
                                cfg.hidden_act, name=f"l{idx}.moe", **kw)
        else:
            self.ffn = GatedMLP(cfg.d_model, cfg.d_ff, lcfg.sparsity_rules,
                                cfg.hidden_act, name=f"l{idx}.mlp", **kw)

    def _no_paged(self) -> str:
        return (f"paged decode supports attention layer kinds ('attn', "
                f"'swa', 'mla'); layer {self.idx} is {self.kind!r}, whose "
                f"O(1) recurrent state has nothing to page — serve this "
                f"architecture with the static engine (--engine static)")

    def forward(self, x, positions, *, cache=None, block_tables=None,
                index: Optional[int] = None):
        """Returns (x, cache, aux): ``aux`` is the MoE layer's load-balance
        loss, None otherwise.  With a cache (prefill and decode) the MoE
        layer runs at full capacity, as the reference's."""
        if self.kind in ("mamba", "rwkv") and block_tables is not None:
            raise NotImplementedError(self._no_paged())
        if self.kind == "rwkv":
            x, cache = self.rwkv(x, positions, cache=cache)
            return x, cache, None
        if self.kind == "mamba":
            h, cache = self.mixer(self.norm1(x), positions, cache=cache)
        else:
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
        paged prefill's temp cache slots are absolute positions).  A
        sharded recurrent layer's cache holds its rank's channels: Mamba's
        ``conv`` and ``h`` its d_inner channels, RWKV's ``state`` its
        heads (``x_tm`` and ``x_cm`` whole)."""
        cfg = self.cfg
        if self.kind == "mamba":
            mc, tp = cfg.mamba, self.mixer.tp
            di = mc.expand * cfg.d_model if tp is None else tp.hi - tp.lo
            return init_cache_mamba(batch, di, mc.d_conv, mc.d_state, dtype,
                                    device=device)
        if self.kind == "rwkv":
            hs, tp = cfg.rwkv.head_size, self.rwkv.tp
            d = cfg.d_model if tp is None else tp.hi - tp.lo
            return init_cache_rwkv(batch, cfg.d_model, d // hs, hs, dtype,
                                   device=device)
        L = cache_len
        if self.kind == "swa" and not full_length:
            L = min(cache_len, cfg.sliding_window)
        if self.kind == "mla":
            return init_cache_mla(batch, L, cfg.mla, dtype, device=device)
        return init_cache_gqa(batch, L, self.mixer.cache_kv_heads,
                              cfg.head_dim_, dtype, device=device)

    def init_pages(self, n_blocks: int, page_size: int, dtype=torch.bfloat16,
                   device=None) -> dict:
        """(n_blocks, page_size, ...) pools; sliding-window layers get
        full-size pools too (the window is a mask in paged mode).  The
        recurrent kinds raise."""
        if self.kind not in PAGED_KINDS:
            raise NotImplementedError(self._no_paged())
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
        """Every layer's pools; a recurrent layer raises.  They are built
        in the reference's order (the head layers, the tail, then the
        scanned periods), so the first recurrent layer in that order names
        the refusal."""
        pools = {i: self.layers[i].init_pages(n_blocks, page_size, dtype,
                                              device=device)
                 for i in self.reference_order()}
        return [pools[i] for i in range(self.cfg.n_layers)]

    def reference_order(self) -> tuple[int, ...]:
        """The layer indices in the order the reference builds their
        caches: the head layers, the tail, then the scanned periods."""
        n = self.cfg.n_layers
        n_head, _, _, tail_start = jax_stack_split(self.cfg)
        return (*range(n_head), *range(tail_start, n),
                *range(n_head, tail_start))
