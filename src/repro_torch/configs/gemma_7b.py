"""gemma-7b [dense]: 28L d_model=3072 16H (kv=16) d_ff=24576 vocab=256000.

GeGLU activation, head_dim=256 (arXiv:2403.08295).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma-7b",
    family="dense",
    n_layers=28,
    d_model=3072,
    n_heads=16,
    n_kv_heads=16,
    head_dim=256,
    d_ff=24576,
    vocab_size=256000,
    hidden_act="gelu",
    tie_embeddings=True,
    max_seq_len=32768,
)
