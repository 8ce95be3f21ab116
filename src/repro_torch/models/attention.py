"""Grouped-query attention (full or sliding window) over contiguous and
paged KV caches.

The port of the GQA part of ``repro/models/attention.py``.  Attention is
plain tensor code in the reference too, so it is plain PyTorch here; only
the projections reach the ``rbgp4mm_rhs`` kernel (through SparseLinear).

Caches are dicts of tensors:
  contiguous: {"k": (B, L, Hkv, hd), "v": (B, L, Hkv, hd), "pos": (B, L) int32}
  paged pools: {"k": (N, P, Hkv, hd), "v": ..., "pos": (N, P) int32}
``pos`` holds each slot's absolute position (-1 = empty), so the attention
mask is computed from slot positions for full and rolling caches alike.
Unlike the reference, which is functional, caches are updated in place
(one copy of the pools instead of two).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.sparsity import SparseLinear
from .common import apply_rope, rope_frequencies

__all__ = ["GQAttention", "init_cache_gqa", "paged_cache_update",
           "NEG_INF", "CHUNK_THRESHOLD", "KV_CHUNK"]

NEG_INF = -1e30

# keys-length threshold above which prefill attention runs chunked
# (online softmax) instead of materializing (B, H, Sq, Sk) scores
CHUNK_THRESHOLD = 2048
KV_CHUNK = 1024


def _online_attend(score_fn, value_fn, n_keys: int, lead: tuple,
                   out_dim: int, device, chunk: int = 0) -> torch.Tensor:
    """Online-softmax attention over key chunks (the reference's
    flash-attention recurrence, as a Python loop over chunks).

    score_fn(start, size) -> (*lead, size) f32 scores, already masked with
    NEG_INF; value_fn(probs, start, size) -> (*lead, out_dim).
    """
    chunk = chunk or KV_CHUNK
    n_chunks = (n_keys + chunk - 1) // chunk
    m = torch.full(lead, -math.inf, dtype=torch.float32, device=device)
    l = torch.zeros(lead, dtype=torch.float32, device=device)
    acc = torch.zeros(lead + (out_dim,), dtype=torch.float32, device=device)
    for i in range(n_chunks):
        start = i * chunk
        s = score_fn(start, chunk)
        m_new = torch.maximum(m, s.amax(dim=-1))
        # guard fully-masked rows (m_new = -inf): exp(-inf - -inf) -> nan
        inf_new = torch.isinf(m_new)
        m_safe = torch.where(inf_new, torch.zeros_like(m_new), m_new)
        p = torch.exp(s - m_safe[..., None])
        p = torch.where(inf_new[..., None], torch.zeros_like(p), p)
        corr = torch.where(torch.isinf(m), torch.zeros_like(m),
                           torch.exp(m - m_safe))
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + value_fn(p, start, chunk)
        m = m_new
    return acc / torch.clamp(l, min=1e-30)[..., None]


def _write_cache(buf: torch.Tensor, new: torch.Tensor, index: int,
                 rolling: bool) -> torch.Tensor:
    """Write (B, S, ...) entries at [index, index+S) (mod L if rolling),
    in place; returns ``buf``."""
    L = buf.shape[1]
    S = new.shape[1]
    new = new.to(buf.dtype)
    if S == 1:
        slot = (index % L) if rolling else index
        buf[:, slot] = new[:, 0]
        return buf
    if rolling:
        # invariant: the token at absolute position p lives at slot p % L
        keep = min(S, L)
        idx = (index + (S - keep) + torch.arange(keep, device=buf.device)) % L
        buf[:, idx] = new[:, -keep:]
        return buf
    if S >= L:
        buf[:] = new[:, -L:]
        return buf
    buf[:, index:index + S] = new
    return buf


def paged_cache_update(pages: dict, new_vals: dict, positions: torch.Tensor,
                       block_tables: torch.Tensor):
    """Scatter one decode step into the page pools (in place) and gather
    each request's view.

    pages: {"pos": (N, P), name: (N, P, ...) per entry of new_vals};
    new_vals: {name: (B, 1, ...)}; positions: (B, 1) absolute positions;
    block_tables: (B, MB), -1 = unallocated.  Rows whose current block is
    -1 (inactive batch slots) write to physical block 0, the trash block
    the allocator never hands out.

    Returns (pages, {name: (B, MB*P, ...)}, k_pos (B, MB*P)) with k_pos = -1
    on every slot not backed by an allocated block.
    """
    P = pages["pos"].shape[1]
    B, MB = block_tables.shape
    bt = block_tables.long()
    slot = positions[:, 0].long()
    bt_cur = torch.gather(bt, 1, (slot // P)[:, None])[:, 0]
    active = bt_cur >= 0
    phys = torch.where(active, bt_cur, torch.zeros_like(bt_cur))
    off = torch.where(active, slot % P, torch.zeros_like(slot))
    for name, val in new_vals.items():
        buf = pages[name]
        buf[phys, off] = val[:, 0].to(buf.dtype)
    pages["pos"][phys, off] = torch.where(
        active, slot, torch.full_like(slot, -1)).to(pages["pos"].dtype)
    safe = torch.clamp(bt, min=0)
    gathered = {
        name: pages[name][safe].reshape((B, MB * P) + pages[name].shape[2:])
        for name in new_vals
    }
    valid = torch.repeat_interleave(bt >= 0, P, dim=1)
    k_pos = torch.where(valid, pages["pos"][safe].reshape(B, MB * P),
                        torch.full((B, MB * P), -1, dtype=pages["pos"].dtype,
                                   device=bt.device))
    return pages, gathered, k_pos


def init_cache_gqa(batch: int, length: int, n_kv: int, head_dim: int,
                   dtype=torch.bfloat16, device=None) -> dict:
    return {
        "k": torch.zeros((batch, length, n_kv, head_dim), dtype=dtype,
                         device=device),
        "v": torch.zeros((batch, length, n_kv, head_dim), dtype=dtype,
                         device=device),
        "pos": torch.full((batch, length), -1, dtype=torch.int32,
                          device=device),
    }


class GQAttention(nn.Module):
    """Grouped-query attention with RoPE; window=0 means full causal.
    ``device`` defaults to the card (projections and ``inv_freq`` alike);
    without CUDA that raises, naming ``device="cpu"``."""

    def __init__(self, cfg: ModelConfig, *, window: int = 0,
                 name: str = "attn", device=None, **kw):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        self.window = window
        self.name = name
        d, hd = cfg.d_model, cfg.head_dim_
        sp = cfg.sparsity_rules
        kw = dict(kw, device=device)
        self.wq = SparseLinear(d, cfg.n_heads * hd, sp, name=f"{name}.wq", **kw)
        self.wk = SparseLinear(d, cfg.n_kv_heads * hd, sp, name=f"{name}.wk",
                               **kw)
        self.wv = SparseLinear(d, cfg.n_kv_heads * hd, sp, name=f"{name}.wv",
                               **kw)
        self.wo = SparseLinear(cfg.n_heads * hd, d, sp, name=f"{name}.wo", **kw)
        self.register_buffer(
            "inv_freq", rope_frequencies(hd, cfg.rope_theta, device=device),
            persistent=False)

    def forward(self, x: torch.Tensor, positions: torch.Tensor, *,
                cache: Optional[dict] = None,
                block_tables: Optional[torch.Tensor] = None,
                index: Optional[int] = None):
        """x: (B, S, D); positions: (B, S).  Returns (y, cache).

        ``index`` is the first position of a contiguous-cache call (rows in
        lockstep); read from ``positions`` when not given.  With
        ``block_tables`` the cache is the paged pools (decode only, S == 1,
        per-request positions)."""
        cfg = self.cfg
        B, S, _ = x.shape
        H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
        q = self.wq(x).reshape(B, S, H, hd)
        k = self.wk(x).reshape(B, S, Hkv, hd)
        v = self.wv(x).reshape(B, S, Hkv, hd)
        q = apply_rope(q, self.inv_freq, positions)
        k = apply_rope(k, self.inv_freq, positions)

        if block_tables is not None:
            if S != 1:
                raise ValueError("paged attention is decode-only (S == 1); "
                                 "prefill goes through the contiguous path")
            cache, got, k_pos = paged_cache_update(
                cache, {"k": k, "v": v}, positions, block_tables)
            k_all = got["k"].to(q.dtype)
            v_all = got["v"].to(q.dtype)
        elif cache is not None:
            if index is None:
                index = int(positions[0, 0])  # decode/prefill in lockstep
            rolling = self.window > 0
            if S == 1:
                # decode: attend over the updated cache
                for name, val in (("k", k), ("v", v)):
                    _write_cache(cache[name], val, index, rolling)
                _write_cache(cache["pos"][..., None], positions[..., None],
                             index, rolling)
                k_all = cache["k"].to(q.dtype)
                v_all = cache["v"].to(q.dtype)
                k_pos = cache["pos"]
            else:
                # prefill: attend over (old cache ++ current chunk), taken
                # before the in-place write; stale slots are masked by
                # position
                k_all = torch.cat([cache["k"].to(q.dtype), k], dim=1)
                v_all = torch.cat([cache["v"].to(q.dtype), v], dim=1)
                k_pos = torch.cat([cache["pos"].to(positions.dtype),
                                   positions], dim=1)
                for name, val in (("k", k), ("v", v)):
                    _write_cache(cache[name], val, index, rolling)
                _write_cache(cache["pos"][..., None], positions[..., None],
                             index, rolling)
        else:
            k_all, v_all, k_pos = k, v, positions

        y = self._attend(q, k_all, v_all, positions, k_pos)
        return self.wo(y.reshape(B, S, H * hd)), cache

    def _mask(self, q_pos: torch.Tensor, k_pos: torch.Tensor) -> torch.Tensor:
        """(B, Sq, Sk) True where attention is allowed."""
        qp = q_pos[:, :, None]
        kp = k_pos[:, None, :]
        ok = (kp >= 0) & (kp <= qp)
        if self.window > 0:
            ok &= (qp - kp) < self.window
        return ok

    def _expand_kv(self, t: torch.Tensor) -> torch.Tensor:
        """(B, L, Hkv, hd) -> (B, L, H, hd) (GQA repeat)."""
        B, L, g, hd = t.shape
        rep = self.cfg.n_heads // g
        return t[:, :, :, None, :].expand(B, L, g, rep, hd).reshape(
            B, L, g * rep, hd)

    def _attend(self, q, k, v, q_pos, k_pos):
        S = q.shape[1]
        if S == 1:
            return self._attend_decode_grouped(q, k, v, q_pos, k_pos)
        k = self._expand_kv(k)
        v = self._expand_kv(v)
        if k.shape[1] > CHUNK_THRESHOLD:
            return self._attend_chunked(q, k, v, q_pos, k_pos)
        hd = q.shape[-1]
        # scores in f32 from the working-dtype operands (the reference's
        # preferred_element_type=f32 contraction)
        scores = torch.einsum("bshd,blhd->bhsl", q.float(),
                              k.float()) / math.sqrt(hd)
        ok = self._mask(q_pos, k_pos)[:, None]
        scores = torch.where(ok, scores, torch.full_like(scores, NEG_INF))
        probs = torch.softmax(scores, dim=-1).to(q.dtype)
        return torch.einsum("bhsl,blhd->bshd", probs, v)

    def _attend_decode_grouped(self, q, k, v, q_pos, k_pos):
        B, S, H, hd = q.shape
        Hkv = k.shape[2]
        qg = q.reshape(B, S, Hkv, H // Hkv, hd)
        scores = torch.einsum("bsgrh,blgh->bgrsl", qg.float(),
                              k.float()) / math.sqrt(hd)
        ok = self._mask(q_pos, k_pos)[:, None, None]
        scores = torch.where(ok, scores, torch.full_like(scores, NEG_INF))
        probs = torch.softmax(scores, dim=-1).to(q.dtype)
        out = torch.einsum("bgrsl,blgh->bsgrh", probs, v)
        return out.reshape(B, S, H, hd)

    def _attend_chunked(self, q, k, v, q_pos, k_pos):
        """Online-softmax attention over KV chunks: O(Sq) score memory."""
        B, S, H, hd = q.shape
        L = k.shape[1]
        pad = (-L) % KV_CHUNK
        if pad:
            k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
            v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
            k_pos = torch.nn.functional.pad(k_pos, (0, pad), value=-1)
        scale = 1.0 / math.sqrt(hd)
        qf = q.float()

        def score_fn(start, size):
            k_c = k[:, start:start + size]
            p_c = k_pos[:, start:start + size]
            s = torch.einsum("bshd,blhd->bhsl", qf, k_c.float()) * scale
            ok = self._mask(q_pos, p_c)[:, None]
            return torch.where(ok, s, torch.full_like(s, NEG_INF))

        def value_fn(p, start, size):
            v_c = v[:, start:start + size]
            return torch.einsum("bhsl,blhd->bhsd", p, v_c.float())

        out = _online_attend(score_fn, value_fn, L + pad, (B, H, S), hd,
                             q.device)
        return out.transpose(1, 2).to(q.dtype)
