"""Sparsity integration: pattern registry, weight containers, SparseLinear."""
from .api import (CompactWeight, DenseWeight, SparseWeight, sparse_linear,
                  sparse_linear_batched)
from .layer import SparseLinear
from .patterns import PATTERNS, PatternInstance, SparsityConfig, make_pattern

__all__ = [
    "SparsityConfig", "PatternInstance", "make_pattern", "PATTERNS",
    "SparseWeight", "DenseWeight", "CompactWeight", "sparse_linear",
    "sparse_linear_batched",
    "SparseLinear",
]
