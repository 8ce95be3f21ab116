"""Radix index over token prefixes at page granularity (prefix sharing).

The port of ``repro/serve/prefix.py`` (host bookkeeping, unchanged).
Production traffic is dominated by shared prefixes — system prompts,
few-shot templates, multi-turn histories — and decode is memory-bound, so
resident KV bytes are the capacity lever (the serving-side analogue of the
paper's compact RBGP4 weight storage).  The paged cache already splits
every request's KV into fixed ``page_size``-token blocks; this module adds
the one missing piece: an index that maps *token content* to resident
blocks so a newly submitted prompt can reuse every full page some earlier
request already computed.

Structure: a radix tree whose edges are whole pages (``page_size`` tokens
hashed to bytes).  A node exists for every indexed page and holds the
block id storing that page's KV.  Matching walks the tree page by page
from the root; because an edge is a full page, a match at depth ``d``
guarantees the *entire* token prefix ``d * page_size`` agrees — there are
no partial-edge matches to split.

Lifecycle contract (the engine side lives in serve/engine.py):

  * The index itself holds one allocator reference (``share``) on every
    indexed block, so finished requests can release their blocks while
    the pages stay resident for future hits.
  * A request that matches pins the blocks (another ``share``) *before*
    any other request's admission work can evict them; eviction only ever
    considers blocks with ``refcount == 1`` (index-only — no live
    readers), so preemption pressure reclaims cold cached prefixes but
    can never yank a page out from under a reader.
  * Matched full pages are reused read-only.  When a prompt is covered
    entirely by matched pages, the *last* matched page is the
    copy-on-write source: the engine gathers it into the request's
    private temp cache (as a copy) and the request writes its decode KV into a fresh
    private block — shared pages are never written after insertion.
  * Eviction is LRU over leaf nodes with deterministic (last_used, seq)
    tie-break, so the eviction order is a pure function of the request
    stream, never of hash/set iteration order.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Callable, Optional

import numpy as np

__all__ = ["PrefixIndex", "PrefixPlan"]


@dataclasses.dataclass
class PrefixPlan:
    """What an incoming prompt can reuse from the index.

    ``blocks``: resident block ids covering the prompt's leading full
    pages, reused read-only.  ``cow_src``: when the prompt is *entirely*
    covered by matched pages, the last matched block — its content is
    copied (gathered) into a private block before the request writes the
    first decode token into that page.  ``suffix_start``: first token
    position the engine must actually prefill (always >= 1 token of
    suffix so there are logits to sample from).
    """

    blocks: list[int]
    cow_src: Optional[int]
    suffix_start: int

    @property
    def hit_pages(self) -> int:
        return len(self.blocks) + (1 if self.cow_src is not None else 0)

    @property
    def hit_tokens(self) -> int:
        return self.suffix_start


class _Node:
    __slots__ = ("key", "block", "children", "parent", "last_used", "seq")

    def __init__(self, key: bytes, block: int, parent: "_Node",
                 last_used: int, seq: int):
        self.key = key
        self.block = block
        self.children: dict[bytes, "_Node"] = {}
        self.parent = parent
        self.last_used = last_used
        self.seq = seq


class PrefixIndex:
    """Radix tree mapping page-granular token prefixes to block ids."""

    def __init__(self, page_size: int):
        if page_size < 1:
            raise ValueError(f"page_size={page_size}")
        self.page = page_size
        self._root = _Node(b"", -1, None, -1, -1)   # sentinel, holds no block
        self._seq = 0                               # insertion tie-break
        self._n_nodes = 0

    # -- introspection -------------------------------------------------------------
    @property
    def n_nodes(self) -> int:
        return self._n_nodes

    def blocks(self) -> list[int]:
        """Every indexed block id (deterministic pre-order)."""
        out: list[int] = []
        stack = [self._root]
        while stack:
            node = stack.pop()
            if node is not self._root:
                out.append(node.block)
            stack.extend(node.children[k] for k in sorted(node.children,
                                                          reverse=True))
        return out

    # -- keys ----------------------------------------------------------------------
    def _key(self, tokens: np.ndarray, i: int) -> bytes:
        page = np.ascontiguousarray(
            np.asarray(tokens[i * self.page:(i + 1) * self.page], np.int32)
        )
        return page.tobytes()

    # -- lookup --------------------------------------------------------------------
    def _match(self, tokens: np.ndarray) -> list[_Node]:
        nodes: list[_Node] = []
        cur = self._root
        for i in range(tokens.shape[0] // self.page):
            child = cur.children.get(self._key(tokens, i))
            if child is None:
                break
            nodes.append(child)
            cur = child
        return nodes

    def plan(self, tokens: np.ndarray, now: Optional[int]) -> PrefixPlan:
        """Match ``tokens`` against the index and stamp LRU clocks.

        Full pages that match are reused; if the whole prompt is covered,
        the last page becomes the copy-on-write source and the suffix is
        the final token alone (recomputed so there are logits to sample).
        Does NOT take allocator references — the caller pins via
        ``share`` while the plan is still fresh (same host step).

        ``now=None`` is a read-only probe: the match runs without
        touching ``last_used``, so admission probes for requests that end
        up rejected neither refresh LRU recency nor poison the
        ``(last_used, seq)`` eviction order with non-integer stamps.
        """
        S = int(tokens.shape[0])
        nodes = self._match(tokens)
        if now is not None:
            for node in nodes:
                node.last_used = now
        m = len(nodes)
        if m == 0:
            return PrefixPlan(blocks=[], cow_src=None, suffix_start=0)
        if m * self.page == S:
            # fully covered: keep >= 1 suffix token, COW the page it
            # lands in (the last matched page)
            return PrefixPlan(blocks=[n.block for n in nodes[:-1]],
                              cow_src=nodes[-1].block,
                              suffix_start=S - 1)
        return PrefixPlan(blocks=[n.block for n in nodes],
                          cow_src=None, suffix_start=m * self.page)

    # -- insertion -----------------------------------------------------------------
    def insert(self, tokens: np.ndarray, blocks: list[int],
               n_tokens: int, now: int) -> list[int]:
        """Index every full page of ``tokens[:n_tokens]`` backed by
        ``blocks`` (the request's block list, page ``i`` in ``blocks[i]``).

        Pages already indexed keep their existing block (first writer
        wins — later duplicates stay private to their request and are
        recycled normally).  Returns the block ids newly referenced by
        the index; the caller must ``share()`` exactly those.
        """
        new_blocks: list[int] = []
        cur = self._root
        for i in range(n_tokens // self.page):
            key = self._key(tokens, i)
            child = cur.children.get(key)
            if child is None:
                child = _Node(key, blocks[i], cur, now, self._seq)
                self._seq += 1
                cur.children[key] = child
                self._n_nodes += 1
                new_blocks.append(blocks[i])
            cur = child
        return new_blocks

    # -- eviction ------------------------------------------------------------------
    def evict_lru(self, evictable: Callable[[int], bool],
                  n: int = 1) -> list[int]:
        """Remove up to ``n`` least-recently-used evictable *leaves* and
        return their block ids, in eviction order.

        ``evictable(block)`` is the engine's refcount gate — only blocks
        with no readers beyond the index itself may go.  Leaves only:
        an inner node's page is the prefix of a live cached path, and
        evicting it would orphan descendants that remain matchable.  A
        node whose last child is evicted becomes a leaf and joins the
        candidate heap, so the sequence is identical to ``n`` repeated
        single evictions — one tree scan instead of one per block.
        ``seq`` is unique per node, so the ``(last_used, seq)`` heap key
        never ties and ordering stays a pure function of the request
        stream.
        """
        if n <= 0:
            return []
        heap: list[tuple[int, int, _Node]] = []
        stack = [self._root]
        while stack:
            node = stack.pop()
            if node is not self._root and not node.children:
                heapq.heappush(heap, (node.last_used, node.seq, node))
            stack.extend(node.children.values())
        out: list[int] = []
        while heap and len(out) < n:
            _, _, node = heapq.heappop(heap)
            if not evictable(node.block):
                continue
            parent = node.parent
            del parent.children[node.key]
            self._n_nodes -= 1
            out.append(node.block)
            if parent is not self._root and not parent.children:
                heapq.heappush(heap, (parent.last_used, parent.seq, parent))
        return out

    def evict_one(self, evictable: Callable[[int], bool]) -> Optional[int]:
        """Remove the least-recently-used evictable leaf and return its
        block id (None if nothing qualifies).  See :meth:`evict_lru`."""
        out = self.evict_lru(evictable, 1)
        return out[0] if out else None

    def drop_all(self) -> list[int]:
        """Empty the index; returns every previously indexed block id so
        the caller can release the index's references."""
        blocks = self.blocks()
        self._root.children.clear()
        self._n_nodes = 0
        return blocks
