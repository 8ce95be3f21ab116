"""Sparsity integration: patterns, plans, weight containers, SparseLinear."""
from .api import (ChainWeight, CompactWeight, DenseWeight, SparseWeight,
                  dense_weight, sparse_linear, sparse_linear_batched,
                  sparse_matmul)
from .chain import chain_storage_bytes
from .layer import SparseLinear
from .patterns import PATTERNS, PatternInstance, SparsityConfig, make_pattern
from .plan import (PatternSpec, PlanRule, SparsityPlan, lower_config,
                   storage_kind)

__all__ = [
    "SparsityConfig", "PatternInstance", "make_pattern", "PATTERNS",
    "PatternSpec", "PlanRule", "SparsityPlan", "lower_config",
    "storage_kind",
    "SparseWeight", "DenseWeight", "CompactWeight", "ChainWeight",
    "sparse_linear", "sparse_linear_batched", "sparse_matmul",
    "dense_weight",
    "chain_storage_bytes",
    "SparseLinear",
]
