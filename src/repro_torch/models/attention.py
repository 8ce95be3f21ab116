"""Attention mixers over contiguous and paged caches: grouped-query
attention (full or sliding window) and DeepSeek-V2's multi-head latent
attention (MLA).

The port of ``repro/models/attention.py``.  Attention is plain tensor code
in the reference too, so it is plain PyTorch here; only the projections
reach the ``rbgp4mm_rhs`` kernel (through SparseLinear).

Caches are dicts of tensors:
  GQA contiguous: {"k": (B, L, Hkv, hd), "v": (B, L, Hkv, hd),
                   "pos": (B, L) int32}
  MLA contiguous: {"ckv": (B, L, r_kv), "krope": (B, L, d_r), "pos": ...}
  paged pools: the same leaves with (N, P) in place of (B, L)
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

from repro_torch.configs.base import MLAConfig, ModelConfig
from repro_torch.device import resolve_device
from repro_torch.parallel.comm import to_ranks
from repro_torch.parallel.tensor import whole_output
from repro_torch.sparsity import SparseLinear
from .common import apply_rope, rope_frequencies

__all__ = ["GQAttention", "MLAttention", "init_cache_gqa", "init_cache_mla",
           "paged_cache_update", "NEG_INF", "CHUNK_THRESHOLD", "KV_CHUNK"]

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


def init_cache_mla(batch: int, length: int, mla: MLAConfig,
                   dtype=torch.bfloat16, device=None) -> dict:
    return {
        "ckv": torch.zeros((batch, length, mla.kv_lora_rank), dtype=dtype,
                           device=device),
        "krope": torch.zeros((batch, length, mla.rope_head_dim), dtype=dtype,
                             device=device),
        "pos": torch.full((batch, length), -1, dtype=torch.int32,
                          device=device),
    }


def _attention_mask(q_pos: torch.Tensor, k_pos: torch.Tensor,
                    window: int = 0) -> torch.Tensor:
    """(B, Sq, Sk) True where a causal query may see a key slot (within
    ``window`` positions when it is not 0)."""
    qp = q_pos[:, :, None]
    kp = k_pos[:, None, :]
    ok = (kp >= 0) & (kp <= qp)
    if window > 0:
        ok &= (qp - kp) < window
    return ok


class GQAttention(nn.Module):
    """Grouped-query attention with RoPE; window=0 means full causal.
    ``device`` defaults to the card (projections and ``inv_freq`` alike);
    without CUDA that raises, naming ``device="cpu"``.

    ``tp`` (a ``parallel.HeadShard``, set by ``parallel.shard_module``)
    runs this rank's q heads: wq gives their rows, the cache holds the kv
    heads ``tp.cache`` (the k/v projections' rows gathered to whole where
    the "model" axis splits them below a whole head), each q head reads
    its own kv head from it, and wo (row-parallel) sums the heads' share
    over the ranks."""

    tp = None

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
        q, k, v = self.wq(x), self.wk(x), self.wv(x)
        tp = self.tp
        # every rank runs every q head where the axis does not divide them
        q_whole = tp is not None and tp.q == (0, H)
        if tp is not None:
            from repro_torch.parallel.comm import gather_cat

            if tp.kv_gather:
                k, v = gather_cat(k, tp.axis), gather_cat(v, tp.axis)
            if tp.q_gather:
                q = gather_cat(q, tp.axis)
            H = tp.q[1] - tp.q[0]
            Hkv = tp.cache[1] - tp.cache[0]
        q = q.reshape(B, S, H, hd)
        k = k.reshape(B, S, Hkv, hd)
        v = v.reshape(B, S, Hkv, hd)
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

        if tp is not None:
            # the kv heads this rank's q heads read, out of the cache's; a
            # cache of every kv head is whole on every rank (to_ranks)
            rep = cfg.n_heads // cfg.n_kv_heads
            a = tp.q[0] // rep - tp.cache[0]
            b = (tp.q[1] - 1) // rep + 1 - tp.cache[0]
            if tp.cache == (0, cfg.n_kv_heads) and not q_whole:
                k_all = to_ranks(k_all, tp.axis)
                v_all = to_ranks(v_all, tp.axis)
            k_all, v_all = k_all[:, :, a:b], v_all[:, :, a:b]
        y = self._attend(q, k_all, v_all, positions, k_pos).reshape(
            B, S, H * hd)
        if q_whole and self.wo.tp.full % tp.axis.size == 0:
            # wo takes this rank's columns of the whole output
            y = to_ranks(y, tp.axis)[..., self.wo.tp.lo:self.wo.tp.hi]
        return self.wo(y), cache

    @property
    def cache_kv_heads(self) -> int:
        """KV heads a cache of this layer holds (a rank's share under
        ``tp``)."""
        if self.tp is None:
            return self.cfg.n_kv_heads
        return self.tp.cache[1] - self.tp.cache[0]

    @staticmethod
    def _expand_kv(t: torch.Tensor, n_heads: int) -> torch.Tensor:
        """(B, L, Hkv, hd) -> (B, L, n_heads, hd) (GQA repeat)."""
        B, L, g, hd = t.shape
        rep = n_heads // g
        return t[:, :, :, None, :].expand(B, L, g, rep, hd).reshape(
            B, L, g * rep, hd)

    def _attend(self, q, k, v, q_pos, k_pos):
        S = q.shape[1]
        if S == 1:
            return self._attend_decode_grouped(q, k, v, q_pos, k_pos)
        k = self._expand_kv(k, q.shape[2])
        v = self._expand_kv(v, q.shape[2])
        if k.shape[1] > CHUNK_THRESHOLD:
            return self._attend_chunked(q, k, v, q_pos, k_pos)
        hd = q.shape[-1]
        # scores in f32 from the working-dtype operands (the reference's
        # preferred_element_type=f32 contraction)
        scores = torch.einsum("bshd,blhd->bhsl", q.float(),
                              k.float()) / math.sqrt(hd)
        ok = _attention_mask(q_pos, k_pos, self.window)[:, None]
        scores = torch.where(ok, scores, torch.full_like(scores, NEG_INF))
        probs = torch.softmax(scores, dim=-1).to(q.dtype)
        return torch.einsum("bhsl,blhd->bshd", probs, v)

    def _attend_decode_grouped(self, q, k, v, q_pos, k_pos):
        B, S, H, hd = q.shape
        Hkv = k.shape[2]
        qg = q.reshape(B, S, Hkv, H // Hkv, hd)
        scores = torch.einsum("bsgrh,blgh->bgrsl", qg.float(),
                              k.float()) / math.sqrt(hd)
        ok = _attention_mask(q_pos, k_pos, self.window)[:, None, None]
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
            ok = _attention_mask(q_pos, p_c, self.window)[:, None]
            return torch.where(ok, s, torch.full_like(s, NEG_INF))

        def value_fn(p, start, size):
            v_c = v[:, start:start + size]
            return torch.einsum("bhsl,blhd->bhsd", p, v_c.float())

        out = _online_attend(score_fn, value_fn, L + pad, (B, H, S), hd,
                             q.device)
        return out.transpose(1, 2).to(q.dtype)


class MLAttention(nn.Module):
    """Multi-head latent attention (DeepSeek-V2).

    The cache holds the compressed ``ckv`` (r_kv a token) and the shared
    rotary key ``krope``; the per-head up-projections ``wk_b`` (H, r_kv,
    d_nope) and ``wv_b`` (H, r_kv, d_v) are dense parameters, the other
    projections SparseLinear.  As the reference, the formulation follows
    the query length: a decode step (S == 1) takes the absorbed form (the
    query through ``wk_b``, the context through ``wv_b``, the cache never
    decompressed); a prefill decompresses per-head keys and values, in
    one pass, or over key chunks through ``_online_attend`` past
    ``CHUNK_THRESHOLD`` keys.  The three sum in different orders, so each
    call takes the reference's branch.  ``device`` defaults to the card.

    ``tp`` (a ``parallel.LatentShard``, set by ``parallel.shard_module``)
    runs this rank's heads: ``wq_b`` gives their rows, ``wk_b`` and
    ``wv_b`` hold them, and ``wo`` (row-parallel) sums their share over
    the ranks; the latent stays whole on every rank (``wq_a``'s and
    ``wkv_a``'s outputs gathered, every rank writing the whole ``ckv`` and
    ``krope``).  A head's branch and order of summation do not change.
    """

    tp = None

    def __init__(self, cfg: ModelConfig, *, name: str = "mla", device=None,
                 dtype=torch.float32, param_dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if cfg.mla is None:
            raise ValueError(f"layer kind 'mla' needs cfg.mla ({cfg.name})")
        device = resolve_device(device)
        self.cfg = cfg
        self.mla = m = cfg.mla
        d, H = cfg.d_model, cfg.n_heads
        sp = cfg.sparsity_rules
        kw = dict(device=device, dtype=dtype, param_dtype=param_dtype,
                  generator=generator)
        self.q_head = m.nope_head_dim + m.rope_head_dim
        if m.q_lora_rank:
            self.wq_a = SparseLinear(d, m.q_lora_rank, sp,
                                     name=f"{name}.wq_a", **kw)
            self.wq_b = SparseLinear(m.q_lora_rank, H * self.q_head, sp,
                                     name=f"{name}.wq_b", **kw)
            self.q_norm_scale = nn.Parameter(
                torch.ones(m.q_lora_rank, device=device), requires_grad=False)
        else:
            self.wq = SparseLinear(d, H * self.q_head, sp, name=f"{name}.wq",
                                   **kw)
        self.wkv_a = SparseLinear(d, m.kv_lora_rank + m.rope_head_dim, sp,
                                  name=f"{name}.wkv_a", **kw)
        self.kv_norm_scale = nn.Parameter(
            torch.ones(m.kv_lora_rank, device=device), requires_grad=False)

        def up(width):
            w = torch.randn((H, m.kv_lora_rank, width), generator=generator,
                            device=device) * m.kv_lora_rank ** -0.5
            return nn.Parameter(w.to(param_dtype).to(dtype),
                                requires_grad=False)

        self.wk_b = up(m.nope_head_dim)
        self.wv_b = up(m.v_head_dim)
        self.wo = SparseLinear(H * m.v_head_dim, d, sp, name=f"{name}.wo",
                               **kw)
        self.register_buffer(
            "inv_freq",
            rope_frequencies(m.rope_head_dim, cfg.rope_theta, device=device),
            persistent=False)

    @staticmethod
    def _rms(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6):
        x32 = x.float()
        v = torch.mean(x32 ** 2, dim=-1, keepdim=True)
        return (x32 * torch.rsqrt(v + eps) * scale).to(x.dtype)

    def forward(self, x: torch.Tensor, positions: torch.Tensor, *,
                cache: Optional[dict] = None,
                block_tables: Optional[torch.Tensor] = None,
                index: Optional[int] = None):
        """x: (B, S, D); positions: (B, S).  Returns (y, cache), the cache
        written in place; ``index`` and ``block_tables`` as
        ``GQAttention``'s."""
        m = self.mla
        B, S, _ = x.shape
        H = self.cfg.n_heads
        dn, dr, dv, r = (m.nope_head_dim, m.rope_head_dim, m.v_head_dim,
                         m.kv_lora_rank)
        if self.tp is not None:
            H = self.tp.heads[1] - self.tp.heads[0]
        if m.q_lora_rank:
            q_a = whole_output(self.wq_a, self.wq_a(x))
            q = self.wq_b(self._rms(q_a, self.q_norm_scale))
        else:
            q = self.wq(x)
        q = q.reshape(B, S, H, self.q_head)
        q_nope = q[..., :dn]
        q_rope = apply_rope(q[..., dn:], self.inv_freq, positions)
        kv = whole_output(self.wkv_a, self.wkv_a(x))
        ckv = self._rms(kv[..., :r], self.kv_norm_scale)
        k_rope = apply_rope(kv[..., r:][:, :, None, :], self.inv_freq,
                            positions)[:, :, 0]

        if block_tables is not None:
            if S != 1:
                raise ValueError("paged attention is decode-only (S == 1); "
                                 "prefill goes through the contiguous path")
            cache, got, k_pos = paged_cache_update(
                cache, {"ckv": ckv, "krope": k_rope}, positions, block_tables)
            ckv_all, krope_all = got["ckv"], got["krope"]
        elif cache is not None:
            if index is None:
                index = int(positions[0, 0])  # decode/prefill in lockstep
            # the reference attends over the written cache, prefill too
            for name, val in (("ckv", ckv), ("krope", k_rope)):
                _write_cache(cache[name], val, index, False)
            _write_cache(cache["pos"][..., None], positions[..., None],
                         index, False)
            ckv_all, krope_all, k_pos = cache["ckv"], cache["krope"], \
                cache["pos"]
        else:
            ckv_all, krope_all, k_pos = ckv, k_rope, positions
        if self.tp is not None:
            # the latent is whole on every rank; this rank's heads read it
            ckv_all = to_ranks(ckv_all, self.tp.axis)
            krope_all = to_ranks(krope_all, self.tp.axis)
        ckv_all = ckv_all.to(x.dtype)
        krope_all = krope_all.to(x.dtype)
        wk_b = self.wk_b.to(x.dtype)
        wv_b = self.wv_b.to(x.dtype)
        scale = 1.0 / math.sqrt(dn + dr)
        L = ckv_all.shape[1]
        qr = q_rope.float()

        if S == 1:
            # absorbed: scores against the compressed cache, O(L * r)
            q_abs = torch.einsum("bshn,hrn->bshr", q_nope, wk_b)
            scores = torch.einsum("bshr,blr->bhsl", q_abs.float(),
                                  ckv_all.float())
            scores = scores + torch.einsum("bshr,blr->bhsl", qr,
                                           krope_all.float())
            scores = scores * scale
            ok = _attention_mask(positions, k_pos)[:, None]
            scores = torch.where(ok, scores, torch.full_like(scores, NEG_INF))
            probs = torch.softmax(scores, dim=-1).to(x.dtype)
            ctx = torch.einsum("bhsl,blr->bshr", probs, ckv_all)
            y = torch.einsum("bshr,hrv->bshv", ctx, wv_b)
        elif L > CHUNK_THRESHOLD:
            pad = (-L) % KV_CHUNK
            ckv_p = torch.nn.functional.pad(ckv_all, (0, 0, 0, pad))
            krope_p = torch.nn.functional.pad(krope_all, (0, 0, 0, pad))
            kpos_p = torch.nn.functional.pad(k_pos, (0, pad), value=-1)
            qn = q_nope.float()

            def score_fn(start, size):
                c_c = ckv_p[:, start:start + size]
                k_nope = torch.einsum("blr,hrn->blhn", c_c, wk_b)
                s = torch.einsum("bshn,blhn->bhsl", qn, k_nope.float())
                s = s + torch.einsum("bshr,blr->bhsl", qr,
                                     krope_p[:, start:start + size].float())
                s = s * scale
                ok = _attention_mask(positions,
                                     kpos_p[:, start:start + size])[:, None]
                return torch.where(ok, s, torch.full_like(s, NEG_INF))

            def value_fn(p, start, size):
                v_c = torch.einsum("blr,hrv->blhv",
                                   ckv_p[:, start:start + size], wv_b)
                return torch.einsum("bhsl,blhv->bhsv", p, v_c.float())

            y = _online_attend(score_fn, value_fn, L + pad, (B, H, S), dv,
                               x.device)
            y = y.transpose(1, 2).to(x.dtype)   # (B, S, H, dv)
        else:
            # naive: decompressed per-head keys and values
            k_nope = torch.einsum("blr,hrn->blhn", ckv_all, wk_b)
            v_full = torch.einsum("blr,hrv->blhv", ckv_all, wv_b)
            scores = torch.einsum("bshn,blhn->bhsl", q_nope.float(),
                                  k_nope.float())
            scores = scores + torch.einsum("bshr,blr->bhsl", qr,
                                           krope_all.float())
            scores = scores * scale
            ok = _attention_mask(positions, k_pos)[:, None]
            scores = torch.where(ok, scores, torch.full_like(scores, NEG_INF))
            probs = torch.softmax(scores, dim=-1).to(x.dtype)
            y = torch.einsum("bhsl,blhv->bshv", probs, v_full)
        return self.wo(y.reshape(B, S, H * dv)), cache
