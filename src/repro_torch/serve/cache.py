"""Paged KV cache: fixed-size blocks, per-request block tables, free list.

The port of ``repro/serve/cache.py``.  ``PageAllocator`` is the reference's
host-side bookkeeping (block 0 is the reserved trash block, refcounted
blocks); ``PagedKVCache`` owns one ``(n_blocks, page, ...)`` pool per cache
leaf of every layer, as torch tensors on the model's device, and moves a
contiguous prefill cache into freshly allocated blocks.  Recycled blocks
get position -1 so stale KV can never leak into a new request's attention.
Fault quarantine and prefix sharing come with later slices.
"""
from __future__ import annotations

import os
from typing import Iterable, Optional

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["PageAllocator", "PagedKVCache", "blocks_for_tokens",
           "pack_prefill_pages"]


def _checks_enabled() -> bool:
    """``REPRO_SERVE_CHECKS=1`` makes every allocator mutation re-verify the
    full invariant set (read per call)."""
    return os.environ.get("REPRO_SERVE_CHECKS", "") == "1"


def blocks_for_tokens(n_tokens: int, page_size: int) -> int:
    """Blocks needed to hold ``n_tokens`` (the one shared ceil-division)."""
    return -(-n_tokens // page_size)


class PageAllocator:
    """Refcounted free-list allocator over ``n_blocks`` fixed-size blocks.

    Block 0 is reserved (the trash block) and never allocated, so
    ``n_total == n_blocks - 1``.  Invariants:

      * no block is handed out twice without an intervening release;
      * ``n_free + n_allocated == n_total`` at all times;
      * every allocated block has refcount >= 1, every other block 0;
      * a block returns to the free list exactly when its refcount hits 0.
    """

    def __init__(self, n_blocks: int):
        if n_blocks < 2:
            raise ValueError(
                f"need >= 2 blocks (one is the reserved trash block); "
                f"got n_blocks={n_blocks}"
            )
        self.n_blocks = n_blocks
        # pop() from the tail -> blocks are handed out in increasing order
        self._free = list(range(n_blocks - 1, 0, -1))
        self._allocated: set[int] = set()
        self._refs: dict[int, int] = {}

    @property
    def n_total(self) -> int:
        return self.n_blocks - 1

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_allocated(self) -> int:
        return len(self._allocated)

    def can_alloc(self, n: int) -> bool:
        return n <= self.n_free

    def refcount(self, block: int) -> int:
        return self._refs.get(block, 0)

    def alloc(self, n: int) -> list[int]:
        if n < 0:
            raise ValueError(f"alloc({n})")
        if n > self.n_free:
            raise RuntimeError(
                f"out of cache blocks: requested {n}, free {self.n_free} "
                f"of {self.n_total} (under worst-case reservation this is "
                f"a bookkeeping bug)"
            )
        blocks = [self._free.pop() for _ in range(n)]
        self._allocated.update(blocks)
        for b in blocks:
            self._refs[b] = 1
        if _checks_enabled():
            self.check_invariants()
        return blocks

    def release(self, blocks: Iterable[int]) -> list[int]:
        """Drop one reader from each block; returns the blocks whose
        refcount hit 0 (now free), whose position marks must be reset."""
        blocks = list(blocks)
        if len(set(blocks)) != len(blocks):
            raise ValueError(f"duplicate blocks in release({blocks})")
        for b in blocks:
            if b not in self._allocated:
                raise ValueError(f"release of non-allocated block {b}")
        freed = []
        for b in blocks:
            self._refs[b] -= 1
            if self._refs[b] == 0:
                del self._refs[b]
                self._allocated.discard(b)
                self._free.append(b)
                freed.append(b)
        if _checks_enabled():
            self.check_invariants()
        return freed

    def free(self, blocks: Iterable[int]) -> None:
        """Strict single-owner free: every block must have refcount 1."""
        blocks = list(blocks)
        if len(set(blocks)) != len(blocks):
            raise ValueError(f"duplicate blocks in free({blocks})")
        for b in blocks:
            if b not in self._allocated:
                raise ValueError(f"double free / foreign block {b}")
            if self._refs[b] != 1:
                raise ValueError(
                    f"free of block {b} with refcount {self._refs[b]} "
                    f"(live readers remain; use release())")
        for b in blocks:
            del self._refs[b]
            self._allocated.discard(b)
            self._free.append(b)
        if _checks_enabled():
            self.check_invariants()

    def check_invariants(self) -> None:
        """Verify the full invariant set; raise on any violation."""
        free_set = set(self._free)
        if len(free_set) != len(self._free):
            raise AssertionError(f"duplicate block in free list: {self._free}")
        if 0 in free_set or 0 in self._allocated:
            raise AssertionError("trash block 0 handed out")
        both = free_set & self._allocated
        if both:
            raise AssertionError(f"blocks {sorted(both)} both free and "
                                 f"allocated")
        universe = set(range(1, self.n_blocks))
        union = free_set | self._allocated
        if union != universe:
            raise AssertionError(
                f"lost/foreign blocks: missing {sorted(universe - union)}, "
                f"extra {sorted(union - universe)}")
        if set(self._refs) != self._allocated:
            raise AssertionError(
                f"refcount keys {sorted(self._refs)} != allocated "
                f"{sorted(self._allocated)}")
        bad = {b: c for b, c in self._refs.items() if c < 1}
        if bad:
            raise AssertionError(f"allocated blocks with refcount < 1: {bad}")


def pack_prefill_pages(cache: list, n_blocks: int, page_size: int) -> list:
    """Reshape a batch-1 contiguous prefill cache into per-request pages.

    ``cache`` is one dict per layer with leaves (1, L, ...); the result has
    leaves (n_blocks, page, ...).  Slots past L are padded with position -1
    / data 0, i.e. marked empty for the position-mask paths.
    """
    tgt = n_blocks * page_size

    def pack(leaf):
        leaf = leaf[0]
        L = leaf.shape[0]
        if L > tgt:
            raise ValueError(
                f"prefill cache length {L} > {n_blocks} blocks "
                f"x page {page_size}")
        if L < tgt:
            fill = -1 if not leaf.is_floating_point() else 0
            pad = [0, 0] * (leaf.ndim - 1) + [0, tgt - L]
            leaf = F.pad(leaf, pad, value=fill)
        return leaf.reshape((n_blocks, page_size) + tuple(leaf.shape[1:]))

    return [{name: pack(leaf) for name, leaf in layer.items()}
            for layer in cache]


class PagedKVCache:
    """Device page pools + allocator for one model's serving caches."""

    def __init__(self, model, n_blocks: int, page_size: int,
                 dtype=torch.float32):
        if page_size < 1:
            raise ValueError(f"page_size={page_size}")
        self.model = model
        self.page = page_size
        self.dtype = dtype
        self.pools = model.init_pages(n_blocks, page_size, dtype)
        self.allocator = PageAllocator(n_blocks)

    def blocks_for(self, n_tokens: int) -> int:
        return blocks_for_tokens(n_tokens, self.page)

    def block_table(self, block_lists: list[Optional[list[int]]],
                    max_blocks: int) -> np.ndarray:
        """(B, max_blocks) int32, -1-padded; None rows are inactive slots
        (an active row with no blocks is a bookkeeping bug and raises)."""
        bt = np.full((len(block_lists), max_blocks), -1, np.int32)
        for i, blocks in enumerate(block_lists):
            if blocks is None:
                continue
            if len(blocks) == 0:
                raise ValueError(
                    f"block table row {i} is active but holds no blocks "
                    f"(inactive slots must be None, not [])")
            bt[i, : len(blocks)] = blocks
        return bt

    def write_prefill(self, cache: list, blocks: list[int]) -> None:
        """Scatter a batch-1 contiguous prefill cache into ``blocks``."""
        self.write_pages(pack_prefill_pages(cache, len(blocks), self.page),
                         blocks)

    def write_pages(self, paged: list, blocks: list[int]) -> None:
        """Scatter per-request pages (``pack_prefill_pages`` shapes) into
        ``blocks`` of every layer's pools, in place."""
        idx = torch.as_tensor(blocks, dtype=torch.long,
                              device=self.pools[0]["pos"].device)
        for pool, layer in zip(self.pools, paged):
            for name, leaf in layer.items():
                pool[name][idx] = leaf.to(pool[name].dtype)

    def reset_blocks(self, blocks: list[int]) -> None:
        """Mark freed blocks empty (pos = -1) in every layer's pos pool, so
        a recycled block carries no stale position into the attention mask."""
        if not blocks:
            return
        idx = torch.as_tensor(blocks, dtype=torch.long,
                              device=self.pools[0]["pos"].device)
        for pool in self.pools:
            pool["pos"][idx] = -1
