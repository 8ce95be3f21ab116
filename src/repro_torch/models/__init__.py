"""Models of the port: shared components, the dense GQA decoder and its MoE
layers, and the paper's vision models (VGG19, WideResNet)."""
from .attention import GQAttention, init_cache_gqa, paged_cache_update
from .common import Embedding, RMSNorm, apply_rope, rope_frequencies
from .lm import LMModel
from .mlp import GatedMLP
from .transformer import DecoderLayer, Stack, jax_stack_split
from .vision import (KEEP_DENSE_PATHS, VGG19, BatchNorm, SparseConv2D,
                     VisionConfig, WideResNet, WRNBlock, vision_plan)

__all__ = [
    "RMSNorm", "Embedding", "rope_frequencies", "apply_rope",
    "GQAttention", "init_cache_gqa", "paged_cache_update", "GatedMLP",
    "DecoderLayer", "Stack", "jax_stack_split", "LMModel",
    "SparseConv2D", "BatchNorm", "VGG19", "WRNBlock", "WideResNet",
    "VisionConfig", "vision_plan", "KEEP_DENSE_PATHS",
]
