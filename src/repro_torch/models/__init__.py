"""Models of the port: shared components and the dense GQA decoder."""
from .attention import GQAttention, init_cache_gqa, paged_cache_update
from .common import Embedding, RMSNorm, apply_rope, rope_frequencies
from .lm import LMModel
from .mlp import GatedMLP
from .transformer import DecoderLayer, Stack, jax_stack_split

__all__ = [
    "RMSNorm", "Embedding", "rope_frequencies", "apply_rope",
    "GQAttention", "init_cache_gqa", "paged_cache_update", "GatedMLP",
    "DecoderLayer", "Stack", "jax_stack_split", "LMModel",
]
