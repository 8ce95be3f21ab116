"""LMModel: embedding -> decoder stack -> norm -> head, with the training
forward and loss and the serving entry points (prefill, chunked prefill,
contiguous decode, paged decode).

The port of ``repro/models/lm.py``, its frontends and heads included:
an audio model (``n_codebooks > 1``) takes (B, S, n_codebooks) tokens,
sums one embedding a codebook and emits (..., n_codebooks, V) logits from
one head of ``n_codebooks * V`` rows; a tied model has no ``head`` and
takes its logits as ``x @ Eᵀ`` (``LMModel._logits``); ``logit_softcap``
caps them as ``tanh(z / c) * c``; a vision model takes precomputed
``patch_embeds`` (B, n_patches, D) in place of its first token
embeddings (``forward``, ``loss`` through ``batch['patch_embeds']``,
``prefill``).  The model holds its weights (the
reference passes a params pytree to every call); they are drawn from a
``torch.Generator`` seeded with ``seed`` on the model's device, or loaded
from the reference with ``repro_torch.bridge.load_jax_params``.  The model
runs on the card unless ``device="cpu"`` is asked for.  The serving entry
points run under ``torch.no_grad``; ``forward`` and ``loss`` run under
autograd when the caller's tensors ask for it (``repro_torch.train``
switches ``requires_grad`` on).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from .common import Embedding, RMSNorm
from .transformer import Stack

__all__ = ["LMModel", "lm_loss", "mean_nll", "vocab_parallel_ll"]


def mean_nll(ll: torch.Tensor,
             mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The mean of -ll (over ``mask``'s ones where given)."""
    if mask is None:
        return -ll.mean()
    mask = mask.float()
    return -(ll * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def lm_loss(logits: torch.Tensor, labels: torch.Tensor,
            mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean cross-entropy in f32; logits (..., V), labels (...) int.

    logsumexp - <one_hot, logits>, as the reference: the log-likelihoods
    of ``vocab_parallel_ll`` over whole rows (the same reductions in the
    same order as a share of the whole vocabulary takes)."""
    return mean_nll(vocab_parallel_ll(logits, labels, None,
                                      logits.shape[-1]), mask)


def vocab_parallel_ll(share: torch.Tensor, labels: torch.Tensor, tp,
                      vocab: int) -> torch.Tensor:
    """Log-likelihoods (labels' shape) of ``labels`` (..., [n_cb]) under
    logits of which this rank holds the flat rows [tp.lo, tp.hi) of
    n_cb * vocab (``share`` (..., tp.hi - tp.lo)), in f32, Megatron's
    vocabulary-parallel cross-entropy: each codebook's max over the
    ranks (a gather), its sum of exponentials and the labels' logits
    summed over the ranks in rank order (``gather_sum``).  A share may
    cross a codebook's boundary.  ``tp`` None: the whole rows, and no
    collective.

    logsumexp is taken as max + log(sum(exp(z - max))), each codebook's
    run of columns reduced on its own, so every sum's order is fixed (a
    ``scatter_add`` into the codebooks adds by atomics on the card, in
    another order each run); the label's logit is a gather (the one-hot
    row's other V-1 terms are exact zeros), which spares a (..., V) f32
    one-hot."""
    from repro_torch.parallel.comm import gather_cat, gather_sum

    lab = labels.long()
    if lab.ndim == share.ndim - 1:
        lab = lab[..., None]
    n_cb = lab.shape[-1]
    lo, hi = (0, share.shape[-1]) if tp is None else (tp.lo, tp.hi)
    z = share.float()
    lead = z.shape[:-1]
    # each codebook's columns [a, b) of the share (None: none of them)
    runs = [(max(lo, c * vocab) - lo, min(hi, (c + 1) * vocab) - lo)
            for c in range(n_cb)]
    runs = [(a, b) if a < b else None for a, b in runs]
    m = torch.stack([z[..., r[0]:r[1]].detach().amax(-1) if r else
                     z.new_full(lead, float("-inf")) for r in runs], -1)
    if tp is not None:
        m = gather_cat(m[None], tp.axis, dim=0).amax(0)
    sumexp = torch.stack(
        [torch.exp(z[..., r[0]:r[1]] - m[..., c, None]).sum(-1) if r else
         z.new_zeros(lead) for c, r in enumerate(runs)], -1)
    flat = lab + torch.arange(n_cb, device=z.device) * vocab - lo
    inside = (flat >= 0) & (flat < hi - lo)
    picked = torch.where(inside, torch.gather(
        z, -1, flat.clamp(0, hi - lo - 1)), 0.0)
    if tp is not None:
        sumexp = gather_sum(sumexp, tp.axis)
        picked = gather_sum(picked, tp.axis)
    return (picked - (torch.log(sumexp) + m)).reshape(labels.shape)


class LMModel(nn.Module):
    """``parallel.shard_module(model, mesh)`` cuts the model to a rank's
    share in place: ``head_tp`` (a ``parallel.VocabShard``) keeps the
    head's vocabulary rows, whose logits are gathered, and ``dp`` (the
    mesh's data axis) splits a paged decode step's rows over the data
    ranks, whose logits are gathered, so every rank's host loop sees the
    same logits.  ``fsdp`` (a ``parallel.DataShard``) holds a data rank's
    share of the head's columns, gathered whole where the logits read it,
    and ``data_axis`` the data axes (pod and data, flattened) that every
    such share is cut over.  ``mesh`` is the mesh the model is cut over
    (None: whole)."""

    mesh = None
    head_tp = None
    dp = None
    fsdp = None
    data_axis = None

    def __init__(self, cfg: ModelConfig, *, device=None, seed: int = 0):
        super().__init__()
        self.cfg = cfg
        self.device = resolve_device(device)
        self.compute_dtype = getattr(torch, cfg.compute_dtype)
        param_dtype = getattr(torch, cfg.param_dtype)
        # ``meta`` (shape recording, n_params) draws nothing: no generator
        generator = (None if self.device.type == "meta" else
                     torch.Generator(device=self.device).manual_seed(seed))
        kw = dict(device=self.device, generator=generator,
                  dtype=self.compute_dtype, param_dtype=param_dtype)
        self.embed = nn.ModuleList(
            [Embedding(cfg.vocab_size, cfg.d_model, **kw)
             for _ in range(cfg.n_codebooks)])
        self.stack = Stack(cfg, **kw)
        self.norm_f = RMSNorm(cfg.d_model, cfg.rmsnorm_eps,
                              device=self.device, dtype=param_dtype)
        self.head = None
        if not cfg.tie_embeddings:
            head = torch.randn((cfg.n_codebooks * cfg.vocab_size,
                                cfg.d_model), generator=generator,
                               device=self.device, dtype=torch.float32)
            self.head = nn.Parameter(
                (head * cfg.d_model ** -0.5).to(param_dtype).to(
                    self.compute_dtype), requires_grad=False)

    def n_params(self) -> int:
        """Stored values (a model built on ``meta`` counts the same)."""
        return sum(p.numel() for p in self.parameters())

    # -- embedding / head ----------------------------------------------------
    def _tokens(self, tokens) -> torch.Tensor:
        return torch.as_tensor(tokens, device=self.device).long()

    def _embed(self, tokens: torch.Tensor,
               patch_embeds=None) -> torch.Tensor:
        """(B, S[, n_cb]) tokens -> (B, S, D) in the compute dtype; the
        codebooks' embeddings summed; ``patch_embeds`` (vision) in place
        of the first positions."""
        if self.cfg.n_codebooks > 1:
            x = 0
            for i, e in enumerate(self.embed):
                x = x + e(tokens[..., i]).to(self.compute_dtype)
        else:
            x = self.embed[0](tokens).to(self.compute_dtype)
        if self.cfg.frontend == "vision" and patch_embeds is not None:
            pe = torch.as_tensor(patch_embeds, device=self.device)
            x = torch.cat([pe.to(self.compute_dtype), x[:, pe.shape[1]:]],
                          dim=1)
        return x

    def _head_shard(self):
        """The head's ``VocabShard`` (a tied head's is the embedding's), or
        None for a head kept whole."""
        return self.embed[0].tp if self.cfg.tie_embeddings else self.head_tp

    def _logits(self, x: torch.Tensor, tp) -> torch.Tensor:
        """x @ W^T, softcapped: the flat (n_cb * V) logits, or under a
        ``VocabShard`` ``tp`` this rank's rows [tp.lo, tp.hi) of them, not
        gathered."""
        from repro_torch.parallel.comm import to_ranks
        from repro_torch.parallel.tensor import on_use

        w = (on_use(self.embed[0], "embedding") if self.cfg.tie_embeddings
             else on_use(self, "head"))
        if tp is not None:
            x = to_ranks(x, tp.axis)
        logits = x @ w.to(x.dtype).T
        if self.cfg.logit_softcap:
            c = self.cfg.logit_softcap
            logits = torch.tanh(logits / c) * c
        return logits

    def _head(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        tp = self._head_shard()
        logits = self._logits(x, tp)
        if tp is not None:
            from repro_torch.parallel.comm import gather_cat

            logits = gather_cat(logits, tp.axis)
        if cfg.n_codebooks > 1:
            logits = logits.reshape(*x.shape[:-1], cfg.n_codebooks,
                                    cfg.vocab_size)
        return logits

    # -- training forward ------------------------------------------------------
    def _trunk(self, tokens: torch.Tensor, train: bool, patch_embeds):
        B, S = tokens.shape[:2]
        x = self._embed(tokens, patch_embeds)
        positions = torch.arange(S, device=self.device).expand(B, S)
        x, _, aux = self.stack(x, positions, train=train)
        return self.norm_f(x), aux

    def forward(self, tokens, *, train: bool = False, patch_embeds=None):
        """tokens (B, S[, n_cb]) -> (logits (B, S[, n_cb], V), aux_loss).
        ``train`` recomputes each layer in the backward when ``cfg.remat``;
        the aux loss is the sum of the MoE layers' load-balance losses (0
        without MoE layers)."""
        x, aux = self._trunk(self._tokens(tokens), train, patch_embeds)
        return self._head(x), aux

    def loss(self, batch: dict, *, train: bool = True):
        """Next-token loss over batch['tokens'] (+ the aux loss), over
        every codebook.  Returns (loss, (ce, aux)); ``batch['loss_mask']``
        (B, S) and ``batch['patch_embeds']`` are optional.  A head that
        splits the vocabulary over ranks keeps its logits split: the
        log-likelihoods are taken from each rank's share
        (``vocab_parallel_ll``), never gathered whole.  Sharded or not,
        the head takes every position and the loss the same reductions,
        so a sharded model of one rank computes the unsharded loss and
        gradients to the bit."""
        tokens = self._tokens(batch["tokens"])
        labels = tokens[:, 1:]
        tp = self._head_shard()
        x, aux = self._trunk(tokens, train, batch.get("patch_embeds"))
        ll = vocab_parallel_ll(self._logits(x, tp)[:, :-1], labels, tp,
                               self.cfg.vocab_size)
        mask = batch.get("loss_mask")
        if mask is not None:
            mask = torch.as_tensor(mask, device=self.device)[:, 1:]
            if self.cfg.n_codebooks > 1:
                mask = mask[..., None] * torch.ones(labels.shape,
                                                    dtype=mask.dtype,
                                                    device=self.device)
        ce = mean_nll(ll, mask)
        return ce + aux, (ce, aux)

    # -- serving -------------------------------------------------------------
    def init_cache(self, batch: int, cache_len: int, dtype=torch.bfloat16,
                   *, full_length: bool = False) -> list:
        return self.stack.init_cache(batch, cache_len, dtype,
                                     full_length=full_length,
                                     device=self.device)

    def init_pages(self, n_blocks: int, page_size: int,
                   dtype=torch.bfloat16) -> list:
        """Paged KV pools for the serving engine (see repro_torch.serve)."""
        return self.stack.init_pages(n_blocks, page_size, dtype,
                                     device=self.device)

    @torch.no_grad()
    def prefill(self, tokens, cache: list, patch_embeds=None):
        """Run the prompt (B, S[, n_cb]) through the stack, filling
        ``cache`` in place.  Returns (last-position logits (B[, n_cb], V),
        cache)."""
        tokens = self._tokens(tokens)
        B, S = tokens.shape[:2]
        x = self._embed(tokens, patch_embeds)
        positions = torch.arange(S, device=self.device).expand(B, S)
        x, cache, _ = self.stack(x, positions, caches=cache, index=0)
        x = self.norm_f(x[:, -1:])
        return self._head(x)[:, 0], cache

    @torch.no_grad()
    def prefill_chunk(self, tokens, cache: list, index: int, n_valid: int):
        """One fixed-size prefill chunk (B, C) written at offset ``index``.

        The serving engine feeds long prompts in equal chunks; the last one
        is ragged, and its rows from ``n_valid`` on are pad tokens with
        position ``-1``, which the position-mask attention (and later the
        page scatter) treats as empty slots.  ``index`` and ``n_valid`` are
        host ints, handed down to the stack, so no layer reads a position
        back from the card.  Returns (logits at the last valid row (B, V),
        cache), the cache written in place.
        """
        tokens = self._tokens(tokens)
        B, C = tokens.shape[:2]
        index, n_valid = int(index), int(n_valid)
        x = self._embed(tokens)
        offs = torch.arange(C, device=self.device)
        row = torch.where(offs < n_valid, offs + index,
                          torch.full_like(offs, -1))
        positions = row.expand(B, C)
        x, cache, _ = self.stack(x, positions, caches=cache, index=index)
        x = self.norm_f(x[:, n_valid - 1:n_valid])
        return self._head(x)[:, 0], cache

    @torch.no_grad()
    def decode_step(self, tokens_new, cache: list, index: int):
        """One decode step; tokens_new (B, 1[, n_cb]), all rows at position
        ``index``.  Returns (logits (B[, n_cb], V), cache)."""
        tokens_new = self._tokens(tokens_new)
        B = tokens_new.shape[0]
        x = self._embed(tokens_new)
        positions = torch.full((B, 1), int(index), device=self.device,
                               dtype=torch.long)
        x, cache, _ = self.stack(x, positions, caches=cache,
                                 index=int(index))
        return self._head(self.norm_f(x))[:, 0], cache

    @torch.no_grad()
    def decode_step_paged(self, tokens_new, pages: list, block_tables,
                          positions):
        """One continuous-batching decode step through the paged pools.

        tokens_new (B, 1[, n_cb]); positions (B,) per-request absolute
        positions; block_tables (B, max_blocks), -1 = unallocated (rows
        whose current block is -1 are inactive and write to the trash
        block).  Returns (logits (B[, n_cb], V), pages), the pools updated
        in place.
        """
        tokens_new = self._tokens(tokens_new)
        B = tokens_new.shape[0]
        pos2 = torch.as_tensor(positions, device=self.device).long().reshape(
            B, 1)
        bt = torch.as_tensor(block_tables, device=self.device)
        dp = self.dp
        split = dp is not None and B % dp.size == 0
        if split:
            lo, hi = dp.range(B)
            tokens_new, pos2, bt = tokens_new[lo:hi], pos2[lo:hi], bt[lo:hi]
        x = self._embed(tokens_new)
        x, pages, _ = self.stack(x, pos2, caches=pages, block_tables=bt)
        logits = self._head(self.norm_f(x))[:, 0]
        if split:
            from repro_torch.parallel.comm import gather_cat

            logits = gather_cat(logits, dp, dim=0)
        return logits, pages
