"""tinyllama-1.1b [dense]: 22L d_model=2048 32H (GQA kv=4) d_ff=5632 vocab=32000.

Llama-2 architecture, small (arXiv:2401.02385); the reference's
``repro/configs/tinyllama_1_1b.py``.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="tinyllama-1.1b",
    n_layers=22,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    head_dim=64,
    d_ff=5632,
    vocab_size=32000,
    hidden_act="silu",
    max_seq_len=32768,
)
