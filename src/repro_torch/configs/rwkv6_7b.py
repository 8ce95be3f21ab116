"""rwkv6-7b [ssm]: 32L d_model=4096 (attention-free) d_ff=14336 vocab=65536.

RWKV-6 "Finch" with data-dependent decay (arXiv:2404.05892).  O(1) decode
state: runs the long_500k cell natively.
"""
from repro_torch.configs.base import ModelConfig, RWKVConfig

CONFIG = ModelConfig(
    name="rwkv6-7b",
    family="ssm",
    n_layers=32,
    d_model=4096,
    n_heads=64,            # d_model / head_size
    n_kv_heads=64,
    d_ff=14336,
    vocab_size=65536,
    layer_pattern=("rwkv",),
    rwkv=RWKVConfig(head_size=64, decay_lora=64, mix_lora=32),
    max_seq_len=524288,
)
