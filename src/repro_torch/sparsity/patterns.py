"""Sparsity pattern registry: ``dense`` and ``rbgp4``.

The port of ``repro/sparsity/patterns.py``.  Masks are deterministic in
(shape, sparsity, seed), as in the reference, so a layer built here has the
reference's mask.  The other patterns of the reference (``unstructured``,
``block``, ``rbgp`` chains) are not yet ported and raise.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional

from repro_torch.core import RBGP4Layout, RBGP4Spec, design_rbgp4

__all__ = ["SparsityConfig", "PatternInstance", "make_pattern", "PATTERNS",
           "NOT_YET_PORTED"]

#: reference patterns whose port comes with a later slice
NOT_YET_PORTED = ("unstructured", "block", "rbgp")


@dataclasses.dataclass(frozen=True)
class SparsityConfig:
    """Per-model sparsity settings.

    pattern:  'dense' or 'rbgp4'.
    sparsity: target fraction of zeros (rbgp4 requires 1 - 2^-k).
    backend:  'auto' — compact storage executed by the ``rbgp4mm_rhs``
              kernel (on the card) or its plain version (on the CPU).  The
              reference's masked and chain backends are not yet ported.
    min_dim:  skip sparsification for matrices with any dim below this.

    The reference's ``block``, ``factors`` and ``quant`` fields come with
    the patterns and storages that read them.
    """

    pattern: str = "dense"
    sparsity: float = 0.0
    backend: str = "auto"
    seed: int = 0
    min_dim: int = 256

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
    layout: Optional[RBGP4Layout] = None
    nnz: int = 0


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


PATTERNS = {
    "dense": _dense,
    "rbgp4": _rbgp4,
}


def make_pattern(cfg: SparsityConfig, m: int, k: int) -> PatternInstance:
    if cfg.pattern in NOT_YET_PORTED:
        raise NotImplementedError(
            f"sparsity pattern {cfg.pattern!r} is not yet ported; "
            f"have {list(PATTERNS)}")
    if cfg.pattern not in PATTERNS:
        raise ValueError(f"unknown pattern {cfg.pattern!r}; have {list(PATTERNS)}")
    return PATTERNS[cfg.pattern](m, k, cfg.sparsity, cfg)
