"""jamba-1.5-large-398b [hybrid]: 72L d_model=8192 64H (GQA kv=8), MoE 16e top-2.

Mamba:attention 7:1 interleave (attention at position 4 of each 8-layer
block), MoE every other layer, d_ff/expert width 24576 (arXiv:2403.19887).
Hybrid: Mamba layers carry O(1) state so the long_500k cell runs.
"""
from repro_torch.configs.base import MambaConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    vocab_size=65536,
    hidden_act="silu",
    layer_pattern=(
        "mamba", "mamba", "mamba", "attn",
        "mamba", "mamba", "mamba", "mamba",
    ),
    mamba=MambaConfig(d_state=16, d_conv=4, expand=2),
    moe=MoEConfig(
        n_experts=16,
        top_k=2,
        n_shared=0,
        d_expert=24576,
        every_n_layers=2,
        first_dense=1,  # MoE on odd layers (1, 3, 5, ...)
    ),
    max_seq_len=524288,
)
