"""Sparsity integration: patterns, plans, weight containers (int8 storage
included), SparseLinear."""
from .api import (ChainWeight, CompactWeight, DenseWeight, QuantizedWeight,
                  SparseWeight, dense_weight, sparse_linear,
                  sparse_linear_batched, sparse_matmul)
from .chain import chain_storage_bytes
from .layer import SparseLinear
from .patterns import PATTERNS, PatternInstance, SparsityConfig, make_pattern
from .plan import (PatternSpec, PlanRule, SparsityPlan, lower_config,
                   storage_kind)
from .quant import (dequantize_weights, leaf_block_dims, quant_storage_bytes,
                    quantize_weight, quantize_weights, weight_bytes)

__all__ = [
    "SparsityConfig", "PatternInstance", "make_pattern", "PATTERNS",
    "PatternSpec", "PlanRule", "SparsityPlan", "lower_config",
    "storage_kind",
    "SparseWeight", "DenseWeight", "CompactWeight", "ChainWeight",
    "QuantizedWeight", "quantize_weight", "quantize_weights",
    "dequantize_weights", "leaf_block_dims", "quant_storage_bytes",
    "weight_bytes",
    "sparse_linear", "sparse_linear_batched", "sparse_matmul",
    "dense_weight",
    "chain_storage_bytes",
    "SparseLinear",
]
