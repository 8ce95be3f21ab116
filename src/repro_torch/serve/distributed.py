"""Mesh-sharded serving engines: TP x EP continuous batching and
prefill/decode disaggregation over ``torch.distributed``.

The port of ``repro/serve/distributed.py``.  The port runs SPMD: every
rank runs the same host loop (scheduler, allocator, block tables, the
sampler) over the same requests, and every rank's host loop sees the same
logits, so every rank makes the same decisions.

  * :class:`ShardedContinuousEngine` shards the model over ``mesh`` with
    ``parallel.shard_module`` (column- and row-parallel projections,
    heads and experts over "model", a decode step's rows over "data") and
    lays the page pools out by ``page_pool_specs`` (heads over "model",
    blocks on every rank); the continuous loop is unchanged.
  * :class:`DisaggregatedEngine` runs prefill and decode as two roles on
    two meshes.  The decode role is the sharded engine's; the prefill
    role holds its own weight copy on ``prefill_mesh`` and runs every
    prefill, single-shot or chunked.  A finished prefill's packed pages
    go to the decode ranks, each rank its heads: the one transfer between
    the roles, counted in ``stats["handoffs"]``.  First-token and decode
    logits are broadcast, so both roles' host loops agree.  A rank
    outside the decode role holds no pools, one outside the prefill role
    no weights of it.  Where the two meshes hold the same ranks in the
    same shape (one rank: both roles on it), the two roles share one copy
    of the weights, which would hold the same bits, and the handoff is a
    copy.

Both engines are paged, as the reference's are: a model with a recurrent
layer kind (mamba, rwkv), whose O(1) state has nothing to page, is
refused with the reference's message before anything is cut, so the
model is left whole (``shard_module`` itself takes those layers: the
sharded step, ``prefill`` and ``decode_step`` and the dry-run run them).

Parity: the engines' greedy streams equal ``run_sequential`` over the
same sharded model, token for token.  Every sum over ranks is taken in
rank order (``parallel.gather_sum``), so a row's bits do not depend on
how many rows share a call.  Sharding a contraction reorders its sums,
so a sharded model is compared with an unsharded one within a
tolerance, never bit for bit.
"""
from __future__ import annotations

import copy

import torch

from repro_torch.parallel import broadcast, gather_cat, shard_module

from .cache import PagedKVCache
from .engine import ContinuousEngine

__all__ = ["ShardedContinuousEngine", "DisaggregatedEngine"]


def _check_paged(model) -> None:
    """The engines are paged: the first recurrent layer in the
    reference's order names the refusal, as its engine's does."""
    for i in model.stack.reference_order():
        layer = model.stack.layers[i]
        if layer.kind in ("mamba", "rwkv"):
            raise NotImplementedError(layer._no_paged())


def _shard(model, mesh):
    """``model`` sharded over ``mesh`` (in place; a model sharded over
    ``mesh`` already, as a restored engine's, is taken as it is)."""
    have = getattr(model, "mesh", None)
    if have is None:
        return shard_module(model, mesh)
    if have is not mesh:
        raise ValueError("the model is sharded over another mesh")
    return model


class ShardedContinuousEngine(ContinuousEngine):
    """Continuous batching with the model and pools sharded over ``mesh``.

    Same knobs as :class:`ContinuousEngine` plus the mesh.  Host-side
    bookkeeping is untouched, preemption included: victim selection is
    host state only, so the engine preempts the same victims at the same
    clocks whatever the mesh (``preempt_log``).  The reference's
    ``constrain_activations`` has no counterpart: eager torch has no
    layout to pin, and a rank's activations are its share already."""

    kind = "sharded"

    def __init__(self, model, mesh, **kw):
        _check_paged(model)
        self.mesh = mesh
        super().__init__(_shard(model, mesh), **kw)

    def _make_kv(self, n_blocks: int) -> PagedKVCache:
        return PagedKVCache(self.model, n_blocks, self.page,
                            self.cache_dtype, mesh=self.mesh)


def _page_leaves(cfg, lyr) -> dict:
    """{name: the trailing dims of its whole pool} of a paged layer: GQA's
    kv heads, MLA's compressed latent and shared rotary key."""
    if lyr.kind == "mla":
        return {"ckv": (cfg.mla.kv_lora_rank,),
                "krope": (cfg.mla.rope_head_dim,)}
    return {"k": (cfg.n_kv_heads, cfg.head_dim_),
            "v": (cfg.n_kv_heads, cfg.head_dim_)}


def _heads_split(lyr) -> bool:
    """Whether a layer's pools hold a rank's share of the kv heads (the
    "model" axis divides them; never MLA's latent)."""
    if lyr.kind == "mla":
        return False
    return lyr.mixer.cfg.n_kv_heads % lyr.mixer.tp.axis.size == 0


def _root(mesh) -> int:
    """The global rank of a mesh's first device."""
    return int(mesh.mesh.flatten()[0])


def _same(a, b) -> bool:
    return a is b or (a.mesh.shape == b.mesh.shape
                      and bool(torch.equal(a.mesh, b.mesh)))


class DisaggregatedEngine(ShardedContinuousEngine):
    """Prefill/decode disaggregation with an explicit KV-page handoff.

    ``decode_mesh`` hosts the decode role (weights, page pools, the
    batched decode step); ``prefill_mesh`` a second weight copy and every
    prefill.  A request's life: the prefill role fills a contiguous temp
    cache (chunk by chunk with ``prefill_chunk``) and emits the
    first-token logits; the cache is packed into page-shaped leaves and
    handed off (:meth:`_handoff`); the decode role scatters them into its
    pools, and from then on the request is a plain decode row.  The
    handoff moves bits and recomputes none, so greedy parity with the
    single-role engines holds token for token."""

    kind = "disagg"

    def __init__(self, model, decode_mesh, prefill_mesh, **kw):
        _check_paged(model)
        self.mesh = decode_mesh
        self.prefill_mesh = prefill_mesh
        self.in_decode = decode_mesh.get_coordinate() is not None
        self.in_prefill = prefill_mesh.get_coordinate() is not None
        if not (self.in_decode or self.in_prefill):
            raise ValueError("this rank is in neither role's mesh")
        self._decode_root = _root(decode_mesh)
        self._prefill_root = _root(prefill_mesh)
        self.prefill_model = None
        if self.in_prefill:
            if self.in_decode and _same(decode_mesh, prefill_mesh):
                self.prefill_model = model
            elif self.in_decode:
                self.prefill_model = _shard(copy.deepcopy(model),
                                            prefill_mesh)
            else:
                self.prefill_model = _shard(model, prefill_mesh)
        if self.in_decode:
            model = _shard(model, decode_mesh)
        ContinuousEngine.__init__(self, model, **kw)
        self.stats.update(handoffs=0)

    # -- roles -----------------------------------------------------------------
    def _make_kv(self, n_blocks: int) -> PagedKVCache:
        return PagedKVCache(self.model if self.in_decode else None,
                            n_blocks, self.page, self.cache_dtype,
                            mesh=self.mesh if self.in_decode else None)

    def _logits_from(self, logits, root: int, rows: int) -> torch.Tensor:
        """The role's logits (rows[, n_codebooks], V) on every rank, from
        ``root``."""
        if logits is None:
            cfg = self.cfg
            shape = ((rows, cfg.n_codebooks, cfg.vocab_size)
                     if cfg.n_codebooks > 1 else (rows, cfg.vocab_size))
            logits = torch.empty(shape, dtype=self.model.compute_dtype,
                                 device=self.device)
        return broadcast(logits.contiguous(), root)

    def _prefill(self, tokens, cache):
        logits = None
        if self.in_prefill:
            logits, cache = self.prefill_model.prefill(tokens, cache)
        return self._logits_from(logits, self._prefill_root,
                                 len(tokens)), cache

    def _chunk(self, tokens, cache, index: int, n_valid: int):
        logits = None
        if self.in_prefill:
            logits, cache = self.prefill_model.prefill_chunk(
                tokens, cache, index, n_valid)
        return self._logits_from(logits, self._prefill_root,
                                 len(tokens)), cache

    def _decode(self, tokens, pools, block_tables, positions):
        logits = None
        if self.in_decode:
            logits, pools = self.model.decode_step_paged(
                tokens, pools, block_tables, positions)
        return self._logits_from(logits, self._decode_root,
                                 len(tokens)), pools

    def _temp_cache(self, length: int) -> list:
        """The prefill role's temp cache; elsewhere a stand-in with no
        cached values (only its slot positions), which packs to the block
        count the handoff receives."""
        if self.in_prefill:
            return self.prefill_model.init_cache(1, length, self.cache_dtype,
                                                 full_length=True)
        out = []
        for lyr in self.model.stack.layers:
            layer = {name: torch.zeros((1, length, 0), dtype=self.cache_dtype,
                                       device=self.device)
                     for name in _page_leaves(self.cfg, lyr)}
            layer["pos"] = torch.full((1, length), -1, dtype=torch.int32,
                                      device=self.device)
            out.append(layer)
        return out

    def kv_bytes_per_token(self) -> float:
        """The decode role's, on every rank."""
        own = super().kv_bytes_per_token() if self.in_decode else 0.0
        t = torch.tensor([own], dtype=torch.float64, device=self.device)
        return float(broadcast(t, self._decode_root))

    # -- the transfers -----------------------------------------------------------
    def _move_pages(self, pages, model, root: int, n_blocks: int) -> list:
        """Pages (``pack_prefill_pages`` leaves, each rank its share of
        the kv heads, an MLA layer's latent whole) of ``model``'s role,
        whole on every rank: each GQA layer's heads gathered over the
        role's "model" axis, then all of it broadcast from ``root`` in two
        flat buffers (the cached values and the slot positions).
        ``pages`` is None off the role."""
        cfg = self.cfg
        shapes = [{name: (n_blocks, self.page) + tail
                   for name, tail in _page_leaves(cfg, lyr).items()}
                  for lyr in self.model.stack.layers]
        if pages is not None:
            whole = []
            for layer, lyr in zip(pages, model.stack.layers):
                split = _heads_split(lyr)
                whole.append({name: (gather_cat(leaf, lyr.mixer.tp.axis,
                                                dim=2)
                                     if split and name != "pos" else leaf)
                              for name, leaf in layer.items()})
            vals = torch.cat([l[n].reshape(-1) for l, sh in zip(whole, shapes)
                              for n in sh]).to(self.cache_dtype)
            pos = torch.cat([l["pos"].reshape(-1) for l in whole]).to(
                torch.int32)
        else:
            n_vals = sum(int(torch.Size(t).numel()) for sh in shapes
                         for t in sh.values())
            vals = torch.empty(n_vals, dtype=self.cache_dtype,
                               device=self.device)
            pos = torch.empty(cfg.n_layers * n_blocks * self.page,
                              dtype=torch.int32, device=self.device)
        broadcast(vals, root)
        broadcast(pos, root)
        pos = pos.reshape(cfg.n_layers, n_blocks, self.page)
        out, at = [], 0
        for i, sh in enumerate(shapes):
            layer = {}
            for name, shape in sh.items():
                size = int(torch.Size(shape).numel())
                layer[name] = vals[at:at + size].view(shape)
                at += size
            layer["pos"] = pos[i]
            out.append(layer)
        return out

    def _heads_of(self, model, whole: list) -> list:
        """Each GQA layer's leaves cut to ``model``'s rank's cache heads
        (an MLA layer's latent is whole on every rank)."""
        out = []
        for layer, lyr in zip(whole, model.stack.layers):
            if lyr.kind == "mla":
                out.append(layer)
                continue
            a, b = lyr.mixer.tp.cache
            out.append({name: leaf if name == "pos"
                        else leaf[:, :, a:b].contiguous()
                        for name, leaf in layer.items()})
        return out

    def _handoff(self, paged: list) -> list:
        """Move the packed pages from the prefill role onto the decode
        role's pools' layout (each decode rank its heads): the one
        transfer.  Off the decode role there are no pools to write."""
        self.stats["handoffs"] += 1
        self._obs.instant("kv_handoff", step=self._clock)
        n_blocks = paged[0]["pos"].shape[0]
        whole = self._move_pages(paged if self.in_prefill else None,
                                 self.prefill_model, self._prefill_root,
                                 n_blocks)
        return self._heads_of(self.model, whole) if self.in_decode else []

    def _localize(self, cache: list, blocks: list) -> list:
        """The reverse handoff for prefix sharing: the gathered prefix is
        read from the decode role's pools and moved onto the prefill
        role's temp cache (bits move, nothing is recomputed)."""
        if not blocks:
            return cache
        pages = None
        if self.in_decode:
            idx = torch.as_tensor(blocks, dtype=torch.long,
                                  device=self.device)
            pages = [{name: leaf[idx] for name, leaf in pool.items()}
                     for pool in self.kv.pools]
        whole = self._move_pages(pages, self.model, self._decode_root,
                                 len(blocks))
        if not self.in_prefill:
            return cache
        span = len(blocks) * self.page
        for layer, got in zip(cache, self._heads_of(self.prefill_model,
                                                    whole)):
            for name, leaf in layer.items():
                sel = got[name]
                leaf[0, :span] = sel.reshape((span,) + tuple(sel.shape[2:]))
        return cache
