"""qwen2-moe-a2.7b [moe]: 24L d_model=2048 16H (kv=16), MoE 60e top-4 + 4 shared.

Expert width 1408 (hf:Qwen/Qwen1.5-MoE-A2.7B); the reference's
``repro/configs/qwen2_moe_a2_7b.py``.  As the reference (and unlike the HF
model) it has no shared-expert sigmoid gate and no qkv bias, and it
normalises the top-k gates.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=5632,
    vocab_size=151936,
    hidden_act="silu",
    moe=MoEConfig(
        n_experts=60,
        top_k=4,
        n_shared=4,
        d_expert=1408,
        every_n_layers=1,
    ),
    max_seq_len=32768,
)
