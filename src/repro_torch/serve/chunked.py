"""Chunked prefill: fixed-size prompt chunks interleaved with decode.

The port of ``repro/serve/chunked.py``.  A long prompt prefilled in one
shot holds every live decode row for the whole prefill; chunked prefill
feeds each admitted prompt in fixed ``chunk``-token pieces, one piece per
engine step, so a decode step waits at most one chunk.  Every chunk has
the shape ``(1, chunk)``, so on the card every chunk of every prompt runs
the projections at N = chunk (the tensor-core bodies from N = 16).

Chunks run through the contiguous cache path (``LMModel.prefill_chunk``)
into one temp cache per request; the last chunk's ragged tail carries
position ``-1``, which every position-masked softmax gives exact-zero
weight.  After the last chunk the temp cache is cut to the request's
block span and scattered into the page pools as a single-shot prefill's.

The temp cache is the port's cache, a list of per-layer dicts with leaves
(1, L, ...), and the functions here cut it with views or write it in
place (the reference's return new arrays).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import numpy as np

__all__ = ["ChunkedPrefillState", "chunk_cache_len", "mask_cache_rows",
           "run_one_chunk", "slice_cache", "trim_cache"]


def chunk_cache_len(max_request_len: int, page_size: int, chunk: int) -> int:
    """Length of the temp prefill cache every request shares.

    It must cover (a) the widest block span a request can hold
    (``blocks_for(max_request_len) * page``, the scatter's source) and (b)
    the last chunk's write window (``ceil(max_len / chunk) * chunk``): a
    write past the end raises here, where the reference's
    dynamic-update-slice would clamp its start and overwrite earlier slots.
    """
    blocks = -(-max_request_len // page_size)
    return max(blocks * page_size, -(-max_request_len // chunk) * chunk)


def slice_cache(cache: list, start: int, end: int) -> list:
    """Slots ``[start, end)`` of a contiguous prefill cache (views).

    The prefix-sharing scatter uses a non-zero ``start`` to take only the
    privately written page span (the leading shared pages live in blocks
    the request must never write).
    """
    def cut(leaf):
        if start == 0 and leaf.shape[1] <= end:
            return leaf
        return leaf[:, start:min(end, leaf.shape[1])]

    return [{name: cut(leaf) for name, leaf in layer.items()}
            for layer in cache]


def trim_cache(cache: list, n: int) -> list:
    """The first ``n`` slots of a contiguous prefill cache.  Slots past the
    prompt hold position ``-1``, so trimming them drops no live data."""
    return slice_cache(cache, 0, n)


def mask_cache_rows(cache: list, start: int, end: int) -> list:
    """Set the position marks of slots ``[start, end)`` to ``-1``, in place.

    Prefix-sharing prefill needs it: a gathered prefix fills slots the
    suffix chunks are about to rewrite (the chunk-aligned resume point
    rounds down past the shared span's edge).  A chunk attends over (old
    cache ++ the chunk itself), so a rewritten slot left with a valid
    position would count its key twice.  With the marks at ``-1`` the
    cache is exactly what a chunked run from scratch had before that chunk;
    the K/V rows need no clearing, a ``-1`` position weighs exactly zero.
    Only the integer leaves (the position marks) are touched.
    """
    if start >= end:
        return cache
    for layer in cache:
        for leaf in layer.values():
            if leaf.is_floating_point():
                continue
            hi = min(end, leaf.shape[1])
            if hi > start:
                leaf[:, start:hi] = -1
    return cache


@dataclasses.dataclass(eq=False)
class ChunkedPrefillState:
    """Progress of one request's chunked prefill (processed FCFS).

    ``tokens`` defaults to the request's prompt; a resumed request passes
    prompt ++ generated prefix (``Request.prefill_tokens``), so its
    chunked re-prefill rebuilds the cache the uninterrupted run had.
    """

    req: Any                       # serve.engine.Request
    cache: list                    # the request's contiguous temp cache
    chunk: int
    tokens: Optional[np.ndarray] = None   # default: req.prompt
    pos: int = 0                   # tokens already fed
    logits: Optional[np.ndarray] = None   # last valid row's, final chunk

    def __post_init__(self):
        if self.tokens is None:
            self.tokens = self.req.prompt

    @property
    def total(self) -> int:
        return self.tokens.shape[0]

    @property
    def done(self) -> bool:
        return self.pos >= self.total

    def next_chunk(self) -> tuple[np.ndarray, int, int]:
        """(tokens (1, chunk), start index, n_valid) of the next chunk; the
        final chunk's ragged tail is zero-padded (those rows get position
        -1 and are masked everywhere)."""
        start = self.pos
        n_valid = min(self.chunk, self.total - start)
        piece = self.tokens[start:start + n_valid]
        if n_valid < self.chunk:
            pad = np.zeros((self.chunk - n_valid,) + piece.shape[1:],
                           piece.dtype)
            piece = np.concatenate([piece, pad], axis=0)
        return piece[None], start, n_valid

    def advance(self, n_valid: int, cache: list,
                logits: Optional[np.ndarray]) -> None:
        self.pos += n_valid
        self.cache = cache
        if logits is not None:
            self.logits = logits


def run_one_chunk(state: ChunkedPrefillState, chunk_fn: Callable,
                  fence: Optional[Callable] = None) -> int:
    """Feed one chunk of ``state`` through ``chunk_fn`` (the model's
    ``prefill_chunk``); returns the prompt tokens fed.

    Only the final chunk's logits are read, as a float32 host array.
    ``fence`` is applied to the updated cache, so a timed section around a
    non-final chunk, whose logits stay on the card, covers the chunk's work
    and not only its launch.
    """
    tokens, start, n_valid = state.next_chunk()
    logits, cache = chunk_fn(tokens, state.cache, start, n_valid)
    if fence is not None:
        fence(cache)
    will_finish = start + n_valid >= state.total
    state.advance(n_valid, cache,
                  logits.float().cpu().numpy() if will_finish else None)
    return n_valid
