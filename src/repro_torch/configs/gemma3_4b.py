"""gemma3-4b [dense]: 34L d_model=2560 8H (GQA kv=4) d_ff=10240 vocab=262144.

5:1 local:global attention interleave, 1024-token sliding window on local
layers, 128k context (hf:google/gemma-3-4b-pt).  Sub-quadratic enough for the
long_500k cell: only every 6th layer holds a full-length KV cache.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-4b",
    family="dense",
    n_layers=34,
    d_model=2560,
    n_heads=8,
    n_kv_heads=4,
    head_dim=256,
    d_ff=10240,
    vocab_size=262144,
    hidden_act="gelu",
    tie_embeddings=True,
    layer_pattern=("swa", "swa", "swa", "swa", "swa", "attn"),
    sliding_window=1024,
    max_seq_len=524288,
)
