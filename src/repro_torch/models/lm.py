"""LMModel: embedding -> decoder stack -> norm -> head, with the training
forward and loss and the serving entry points (prefill, chunked prefill,
contiguous decode, paged decode).

The port of ``repro/models/lm.py``.  The model holds its weights (the
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

__all__ = ["LMModel", "lm_loss"]


def lm_loss(logits: torch.Tensor, labels: torch.Tensor,
            mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean cross-entropy in f32; logits (..., V), labels (...) int.

    logsumexp - <one_hot, logits>, as the reference; the inner product
    with the one-hot row is taken as a gather of the label's logit (the
    other V-1 terms are exact zeros), which spares a (..., V) f32 one-hot.
    """
    logits32 = logits.float()
    lse = torch.logsumexp(logits32, dim=-1)
    picked = torch.gather(logits32, -1, labels.long()[..., None])[..., 0]
    ll = picked - lse
    if mask is None:
        return -ll.mean()
    mask = mask.float()
    return -(ll * mask).sum() / torch.clamp(mask.sum(), min=1.0)


class LMModel(nn.Module):
    def __init__(self, cfg: ModelConfig, *, device=None, seed: int = 0):
        super().__init__()
        self.cfg = cfg
        self.device = resolve_device(device)
        self.compute_dtype = getattr(torch, cfg.compute_dtype)
        param_dtype = getattr(torch, cfg.param_dtype)
        generator = torch.Generator(device=self.device).manual_seed(seed)
        kw = dict(device=self.device, generator=generator,
                  dtype=self.compute_dtype, param_dtype=param_dtype)
        self.embed = nn.ModuleList(
            [Embedding(cfg.vocab_size, cfg.d_model, **kw)])
        self.stack = Stack(cfg, **kw)
        self.norm_f = RMSNorm(cfg.d_model, cfg.rmsnorm_eps,
                              device=self.device)
        head = torch.randn((cfg.vocab_size, cfg.d_model), generator=generator,
                           device=self.device,
                           dtype=torch.float32) * (cfg.d_model ** -0.5)
        self.head = nn.Parameter(head.to(param_dtype).to(self.compute_dtype),
                                 requires_grad=False)

    def n_params(self) -> int:
        return sum(p.numel() for p in self.parameters())

    # -- embedding / head ----------------------------------------------------
    def _tokens(self, tokens) -> torch.Tensor:
        return torch.as_tensor(tokens, device=self.device).long()

    def _head(self, x: torch.Tensor) -> torch.Tensor:
        return x @ self.head.to(x.dtype).T

    # -- training forward ------------------------------------------------------
    def forward(self, tokens, *, train: bool = False):
        """tokens (B, S) -> (logits (B, S, V), aux_loss).  ``train``
        recomputes each layer in the backward when ``cfg.remat``; the aux
        loss is the sum of the MoE layers' load-balance losses (0 for a
        dense stack)."""
        tokens = self._tokens(tokens)
        B, S = tokens.shape
        x = self.embed[0](tokens).to(self.compute_dtype)
        positions = torch.arange(S, device=self.device).expand(B, S)
        x, _, aux = self.stack(x, positions, train=train)
        return self._head(self.norm_f(x)), aux

    def loss(self, batch: dict, *, train: bool = True):
        """Next-token loss over batch['tokens'] (+ the aux loss).  Returns
        (loss, (ce, aux)); ``batch['loss_mask']`` (B, S) is optional."""
        tokens = self._tokens(batch["tokens"])
        logits, aux = self.forward(tokens, train=train)
        mask = batch.get("loss_mask")
        if mask is not None:
            mask = torch.as_tensor(mask, device=self.device)[:, 1:]
        ce = lm_loss(logits[:, :-1], tokens[:, 1:], mask)
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
    def prefill(self, tokens, cache: list):
        """Run the prompt (B, S) through the stack, filling ``cache`` in
        place.  Returns (last-position logits (B, V), cache)."""
        tokens = self._tokens(tokens)
        B, S = tokens.shape
        x = self.embed[0](tokens).to(self.compute_dtype)
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
        B, C = tokens.shape
        index, n_valid = int(index), int(n_valid)
        x = self.embed[0](tokens).to(self.compute_dtype)
        offs = torch.arange(C, device=self.device)
        row = torch.where(offs < n_valid, offs + index,
                          torch.full_like(offs, -1))
        positions = row.expand(B, C)
        x, cache, _ = self.stack(x, positions, caches=cache, index=index)
        x = self.norm_f(x[:, n_valid - 1:n_valid])
        return self._head(x)[:, 0], cache

    @torch.no_grad()
    def decode_step(self, tokens_new, cache: list, index: int):
        """One decode step; tokens_new (B, 1), all rows at position
        ``index``.  Returns (logits (B, V), cache)."""
        tokens_new = self._tokens(tokens_new)
        B = tokens_new.shape[0]
        x = self.embed[0](tokens_new).to(self.compute_dtype)
        positions = torch.full((B, 1), int(index), device=self.device,
                               dtype=torch.long)
        x, cache, _ = self.stack(x, positions, caches=cache,
                                 index=int(index))
        return self._head(self.norm_f(x))[:, 0], cache

    @torch.no_grad()
    def decode_step_paged(self, tokens_new, pages: list, block_tables,
                          positions):
        """One continuous-batching decode step through the paged pools.

        tokens_new (B, 1); positions (B,) per-request absolute positions;
        block_tables (B, max_blocks), -1 = unallocated (rows whose current
        block is -1 are inactive and write to the trash block).  Returns
        (logits (B, V), pages), the pools updated in place.
        """
        tokens_new = self._tokens(tokens_new)
        B = tokens_new.shape[0]
        x = self.embed[0](tokens_new).to(self.compute_dtype)
        pos2 = torch.as_tensor(positions, device=self.device).long().reshape(
            B, 1)
        bt = torch.as_tensor(block_tables, device=self.device)
        x, pages, _ = self.stack(x, pos2, caches=pages, block_tables=bt)
        return self._head(self.norm_f(x))[:, 0], pages
