"""musicgen-medium [audio]: 48L d_model=1536 24H (kv=24) d_ff=6144 vocab=2048.

Decoder-only over EnCodec tokens (arXiv:2306.05284): 4 codebooks of 2048
codes each, embedded and summed per step; 4 per-codebook output heads.  The
EnCodec frontend + delay-pattern scheduling is a stub per the assignment.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium",
    family="audio",
    n_layers=48,
    d_model=1536,
    n_heads=24,
    n_kv_heads=24,
    head_dim=64,
    d_ff=6144,
    vocab_size=2048,
    hidden_act="gelu",
    n_codebooks=4,
    max_seq_len=32768,
)
