"""Sparsity pattern registry: dense | unstructured | block | rbgp4 | rbgp.

The port of ``repro/sparsity/patterns.py``.  The first four are the
patterns of the paper's Table 1.  Masks are deterministic in (shape,
sparsity, seed), with the reference's numpy RNG calls, so a layer built
here has the reference's mask bit for bit.  ``rbgp`` is the general
product chain (``SparsityConfig.factors`` names any sequence of Ramanujan
and complete factors); a chain with at most two Ramanujan factors
canonicalizes onto an RBGP4 layout (compact storage), a deeper one gets a
``ChainLayout`` (chain storage).  ``unstructured`` and ``block`` have no
layout: they are masked storage (a dense array under the mask).  Each
maker returns a ``PatternInstance`` with the (lazy) mask and the paper's
Table-1 memory model (``memory_bytes``).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Optional

import numpy as np

from repro_torch.core import (ChainLayout, RBGP4Layout, RBGP4Spec, RBGPSpec,
                              canonicalize_factors, design_rbgp,
                              design_rbgp4)

__all__ = ["SparsityConfig", "PatternInstance", "make_pattern", "PATTERNS"]


@dataclasses.dataclass(frozen=True)
class SparsityConfig:
    """Per-model sparsity settings.

    pattern:  one of ``PATTERNS``.
    sparsity: target fraction of zeros (rbgp4 and block need 1 - 2^-k).
    backend:  'auto' — compact storage for a pattern with an RBGP4 layout,
              chain storage for a deeper ``rbgp`` chain, each executed by
              its hand-written kernels (on the card) or their plain
              versions (on the CPU), masked storage otherwise; or any
              name registered in ``repro_torch.sparsity.api``, whose
              declared capabilities decide the storage
              (``api.storage_kind``) and which runs every product of the
              layer: 'xla_masked' and 'ref' store any pattern masked
              (dense values under a fixed mask, one dense product).
    block:    (bh, bw) of the 'block' pattern (the paper's Table 1 uses
              (4, 4)).
    min_dim:  skip sparsification for matrices with any dim below this.
    factors:  'rbgp' only: the factor-chain template (see
              ``repro_torch.core.canonicalize_factors``); None is the
              default RBGP4 chain.
    quant:    value storage dtype of the layer's sparse weights: None
              (full precision) or 'int8' (weight-only int8 leaf blocks +
              per-leaf-block f32 scales, ``sparsity/quant.py``).  Part of
              the plan fingerprint, so checkpoints refuse a restore across
              the two.  The layer is built in full precision either way;
              ``quantize_weights`` converts it.
    """

    pattern: str = "dense"
    sparsity: float = 0.0
    backend: str = "auto"
    block: tuple[int, int] = (4, 4)
    seed: int = 0
    min_dim: int = 256
    factors: Optional[tuple] = None
    quant: Optional[str] = None

    def __post_init__(self):
        if self.quant not in (None, "int8"):
            raise ValueError(
                f"quant={self.quant!r} (supported: None, 'int8')")

    def applies_to(self, m: int, k: int) -> bool:
        if self.pattern == "dense" or self.sparsity <= 0.0:
            return False
        return min(m, k) >= self.min_dim


@dataclasses.dataclass
class PatternInstance:
    """A realized mask for one (m, k) weight matrix."""

    name: str
    m: int
    k: int
    sparsity: float
    mask_fn: Callable[[], np.ndarray]     # lazy: masks can be big
    layout: Optional[RBGP4Layout] = None  # rbgp4 / rbgp4-expressible chains
    nnz: int = 0
    index_bytes_succinct: int = 0
    index_bytes_full: int = 0
    chain: Optional[RBGPSpec] = None      # the chain spec of an 'rbgp' pattern
    # blocked-CSR layout of a chain with more than two Ramanujan factors
    # (chain storage); None for every other pattern
    chain_layout: Optional[ChainLayout] = None

    def mask(self) -> np.ndarray:
        """The (m, k) uint8 {0, 1} mask."""
        return self.mask_fn()

    def memory_bytes(self, value_bytes: int = 4, index_bytes: int = 4) -> dict:
        """The paper's Table-1 'Mem' model: values + index storage."""
        values = self.nnz * value_bytes
        if self.name == "dense":
            return {"values": self.m * self.k * value_bytes, "index": 0,
                    "total": self.m * self.k * value_bytes}
        idx = {
            "unstructured": self.index_bytes_full,
            "block": self.index_bytes_full,
            "rbgp4": self.index_bytes_succinct,
            "rbgp": self.index_bytes_succinct,
        }[self.name]
        return {"values": values, "index": idx * index_bytes // 4,
                "total": values + idx * index_bytes // 4}


def _dense(m, k, sparsity, cfg):
    return PatternInstance(
        name="dense", m=m, k=k, sparsity=0.0,
        mask_fn=lambda: np.ones((m, k), np.uint8), nnz=m * k)


def _unstructured(m, k, sparsity, cfg):
    """Row-uniform random mask (the paper's 'unstructured' baseline): each
    row keeps round((1 - sparsity) * k) columns, at least one."""
    nnz_row = max(round((1.0 - sparsity) * k), 1)

    def mk():
        rng = np.random.default_rng(cfg.seed ^ (m * 0x9E3779B1 + k))
        mask = np.zeros((m, k), np.uint8)
        for r in range(m):
            mask[r, rng.choice(k, nnz_row, replace=False)] = 1
        return mask

    nnz = nnz_row * m
    return PatternInstance(
        name="unstructured", m=m, k=k, sparsity=1 - nnz / (m * k),
        mask_fn=mk, nnz=nnz,
        index_bytes_full=nnz * 4, index_bytes_succinct=nnz * 4,
    )


def _block(m, k, sparsity, cfg):
    """Uniform block-sparse mask of (bh, bw) blocks (the paper's 'Block'):
    each block row keeps round((1 - sparsity) * k / bw) blocks."""
    bh, bw = cfg.block
    if m % bh or k % bw:
        raise ValueError(f"block {cfg.block} does not tile {m}x{k}")
    br, bc = m // bh, k // bw
    nnz_blocks_row = max(round((1.0 - sparsity) * bc), 1)

    def mk():
        rng = np.random.default_rng(cfg.seed ^ (m * 0x85EBCA77 + k))
        mask = np.zeros((br, bc), np.uint8)
        for r in range(br):
            mask[r, rng.choice(bc, nnz_blocks_row, replace=False)] = 1
        return np.kron(mask, np.ones((bh, bw), np.uint8))

    nnz = nnz_blocks_row * br * bh * bw
    # BSR index: one int per non-zero block
    return PatternInstance(
        name="block", m=m, k=k, sparsity=1 - nnz / (m * k),
        mask_fn=mk, nnz=nnz,
        index_bytes_full=(nnz // (bh * bw)) * 4,
        index_bytes_succinct=(nnz // (bh * bw)) * 4,
    )


@functools.lru_cache(maxsize=1024)
def _layout_for(spec: RBGP4Spec) -> RBGP4Layout:
    """Memoized layout construction: every layer with the same spec shares
    one adjacency set (and one device-side kernel table)."""
    return RBGP4Layout(spec)


def _rbgp4(m, k, sparsity, cfg):
    spec = design_rbgp4(m, k, sparsity, seed=cfg.seed)
    layout = _layout_for(spec)
    mem = layout.memory_bytes()
    return PatternInstance(
        name="rbgp4", m=m, k=k, sparsity=spec.sparsity, mask_fn=layout.mask,
        layout=layout, nnz=spec.nnz,
        index_bytes_succinct=mem["index_succinct"],
        index_bytes_full=mem["index_full"],
    )


@functools.lru_cache(maxsize=1024)
def _chain_layout_for(spec: RBGPSpec) -> ChainLayout:
    """Memoized chain layout construction: every layer with the same spec
    shares one sample (and one device-side table)."""
    return ChainLayout(spec)


def _rbgp(m, k, sparsity, cfg):
    """Generalized product chain.  Templates with at most two Ramanujan
    factors canonicalize onto an RBGP4 layout; deeper chains get a
    ``ChainLayout``.  The decision is template-level, as the reference's,
    so a plan knows the storage kind without shapes."""
    spec = design_rbgp(m, k, sparsity, factors=cfg.factors, seed=cfg.seed)
    if cfg.factors is None:
        n_ram = 2
    else:
        n_ram = sum(1 for t in canonicalize_factors(cfg.factors)
                    if t[0] == "ramanujan")
    r4 = spec.to_rbgp4() if n_ram <= 2 else None
    if r4 is not None:
        layout = _layout_for(r4)
        mem = layout.memory_bytes()
        return PatternInstance(
            name="rbgp", m=m, k=k, sparsity=spec.sparsity,
            mask_fn=layout.mask, layout=layout, nnz=spec.nnz,
            index_bytes_succinct=mem["index_succinct"],
            index_bytes_full=mem["index_full"], chain=spec)
    chain_layout = _chain_layout_for(spec)
    return PatternInstance(
        name="rbgp", m=m, k=k, sparsity=spec.sparsity,
        mask_fn=chain_layout.mask, nnz=spec.nnz,
        index_bytes_succinct=spec.stored_index_edges * 4,
        index_bytes_full=spec.nnz * 4, chain=spec, chain_layout=chain_layout)


PATTERNS = {
    "dense": _dense,
    "unstructured": _unstructured,
    "block": _block,
    "rbgp4": _rbgp4,
    "rbgp": _rbgp,
}


def make_pattern(cfg: SparsityConfig, m: int, k: int) -> PatternInstance:
    if cfg.pattern not in PATTERNS:
        raise ValueError(f"unknown pattern {cfg.pattern!r}; have {list(PATTERNS)}")
    return PATTERNS[cfg.pattern](m, k, cfg.sparsity, cfg)
