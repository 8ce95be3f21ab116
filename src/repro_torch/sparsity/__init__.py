"""Sparsity integration: patterns, plans and the plan compiler, weight
containers (masked and int8 storage included), the sparse-backend
registry, SparseLinear."""
from .api import (BackendCapabilities, ChainWeight, CompactWeight,
                  DenseWeight, MaskedWeight, QuantizedWeight, SparseBackend,
                  SparseWeight, available_backends, dense_weight,
                  expand_rbgp4_mask, get_backend, register_backend,
                  resolve_backend, sparse_linear, sparse_linear_batched,
                  sparse_matmul, storage_kind)
from .chain import chain_storage_bytes
from .layer import SparseLinear
from .patterns import PATTERNS, PatternInstance, SparsityConfig, make_pattern
from .plan import (PatternSpec, PlanRule, SparsityPlan, certify,
                   lower_config, model_matmul_shapes, plan_density,
                   record_shape, recording_active, recording_shapes,
                   solve_budget)
from .quant import (dequantize_weights, leaf_block_dims, quant_storage_bytes,
                    quantize_weight, quantize_weights, weight_bytes)

__all__ = [
    "SparsityConfig", "PatternInstance", "make_pattern", "PATTERNS",
    "PatternSpec", "PlanRule", "SparsityPlan", "lower_config",
    "storage_kind", "solve_budget", "plan_density", "certify",
    "model_matmul_shapes", "recording_shapes", "record_shape",
    "recording_active",
    "BackendCapabilities", "SparseBackend", "register_backend",
    "get_backend", "available_backends", "resolve_backend",
    "SparseWeight", "DenseWeight", "MaskedWeight", "CompactWeight",
    "ChainWeight", "QuantizedWeight", "expand_rbgp4_mask",
    "quantize_weight", "quantize_weights",
    "dequantize_weights", "leaf_block_dims", "quant_storage_bytes",
    "weight_bytes",
    "sparse_linear", "sparse_linear_batched", "sparse_matmul",
    "dense_weight",
    "chain_storage_bytes",
    "SparseLinear",
]
