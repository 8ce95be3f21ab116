"""Models of the port: shared components, the decoder stack with every
layer kind of the reference (GQA, MLA, Mamba, RWKV-6) and its MoE layers,
and the paper's vision models (VGG19, WideResNet)."""
from .attention import (GQAttention, MLAttention, init_cache_gqa,
                        init_cache_mla, paged_cache_update)
from .common import Embedding, RMSNorm, apply_rope, rope_frequencies
from .lm import LMModel
from .mlp import GatedMLP
from .rwkv import RWKVBlock, init_cache_rwkv
from .ssm import MambaMixer, init_cache_mamba
from .transformer import DecoderLayer, Stack, jax_stack_split
from .vision import (KEEP_DENSE_PATHS, VGG19, BatchNorm, SparseConv2D,
                     VisionConfig, WideResNet, WRNBlock, vision_plan)

__all__ = [
    "RMSNorm", "Embedding", "rope_frequencies", "apply_rope",
    "GQAttention", "MLAttention", "init_cache_gqa", "init_cache_mla",
    "paged_cache_update", "GatedMLP", "MambaMixer", "init_cache_mamba",
    "RWKVBlock", "init_cache_rwkv",
    "DecoderLayer", "Stack", "jax_stack_split", "LMModel",
    "SparseConv2D", "BatchNorm", "VGG19", "WRNBlock", "WideResNet",
    "VisionConfig", "vision_plan", "KEEP_DENSE_PATHS",
]
