"""Sparsity pattern registry: ``dense``, ``rbgp4`` and ``rbgp``.

The port of ``repro/sparsity/patterns.py``.  Masks are deterministic in
(shape, sparsity, seed), as in the reference, so a layer built here has the
reference's mask.  ``rbgp`` is the general product chain
(``SparsityConfig.factors`` names any sequence of Ramanujan and complete
factors); a chain with at most two Ramanujan factors canonicalizes onto an
RBGP4 layout (compact storage), a deeper one gets a ``ChainLayout`` (chain
storage).  The reference's ``unstructured`` and ``block`` patterns are not
yet ported and raise.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional

from repro_torch.core import (ChainLayout, RBGP4Layout, RBGP4Spec, RBGPSpec,
                              canonicalize_factors, design_rbgp,
                              design_rbgp4)

__all__ = ["SparsityConfig", "PatternInstance", "make_pattern", "PATTERNS",
           "NOT_YET_PORTED"]

#: reference patterns whose port comes with a later slice
NOT_YET_PORTED = ("unstructured", "block")


@dataclasses.dataclass(frozen=True)
class SparsityConfig:
    """Per-model sparsity settings.

    pattern:  'dense', 'rbgp4' or 'rbgp'.
    sparsity: target fraction of zeros (1 - 2^-k).
    backend:  'auto' — compact storage for a pattern with an RBGP4 layout,
              chain storage for a deeper ``rbgp`` chain, each executed by
              its hand-written kernels (on the card) or their plain
              versions (on the CPU).  The reference's masked backends are
              not yet ported.
    block:    (bh, bw) of the reference's 'block' pattern (not yet ported);
              carried so that plan JSON and fingerprints match.
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
    layout: Optional[RBGP4Layout] = None  # rbgp4 / rbgp4-expressible chains
    nnz: int = 0
    chain: Optional[RBGPSpec] = None      # the chain spec of an 'rbgp' pattern
    # blocked-CSR layout of a chain with more than two Ramanujan factors
    # (chain storage); None for every other pattern
    chain_layout: Optional[ChainLayout] = None


def _dense(m, k, sparsity, cfg):
    return PatternInstance(name="dense", m=m, k=k, sparsity=0.0, nnz=m * k)


@functools.lru_cache(maxsize=1024)
def _layout_for(spec: RBGP4Spec) -> RBGP4Layout:
    """Memoized layout construction: every layer with the same spec shares
    one adjacency set (and one device-side kernel table)."""
    return RBGP4Layout(spec)


def _rbgp4(m, k, sparsity, cfg):
    spec = design_rbgp4(m, k, sparsity, seed=cfg.seed)
    layout = _layout_for(spec)
    return PatternInstance(
        name="rbgp4", m=m, k=k, sparsity=spec.sparsity, layout=layout,
        nnz=spec.nnz,
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
        return PatternInstance(name="rbgp", m=m, k=k, sparsity=spec.sparsity,
                               layout=_layout_for(r4), nnz=spec.nnz,
                               chain=spec)
    return PatternInstance(name="rbgp", m=m, k=k, sparsity=spec.sparsity,
                           nnz=spec.nnz, chain=spec,
                           chain_layout=_chain_layout_for(spec))


PATTERNS = {
    "dense": _dense,
    "rbgp4": _rbgp4,
    "rbgp": _rbgp,
}


def make_pattern(cfg: SparsityConfig, m: int, k: int) -> PatternInstance:
    if cfg.pattern in NOT_YET_PORTED:
        raise NotImplementedError(
            f"sparsity pattern {cfg.pattern!r} is not yet ported; "
            f"have {list(PATTERNS)}")
    if cfg.pattern not in PATTERNS:
        raise ValueError(f"unknown pattern {cfg.pattern!r}; have {list(PATTERNS)}")
    return PATTERNS[cfg.pattern](m, k, cfg.sparsity, cfg)
