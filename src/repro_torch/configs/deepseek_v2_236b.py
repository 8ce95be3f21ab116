"""deepseek-v2-236b [moe]: 60L d_model=5120 128H, MoE 160e top-6 (+2 shared).

MLA with kv_lora_rank=512 (q_lora 1536, rope/nope head dims 64/128, v 128);
layer 0 keeps a dense 12288-wide FFN, all other layers are MoE with
1536-wide experts (arXiv:2405.04434).
"""
from repro_torch.configs.base import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b",
    family="moe",
    n_layers=60,
    d_model=5120,
    n_heads=128,
    n_kv_heads=128,
    head_dim=128,
    d_ff=12288,  # dense layer-0 FFN width
    vocab_size=102400,
    hidden_act="silu",
    layer_pattern=("mla",),
    mla=MLAConfig(
        kv_lora_rank=512,
        q_lora_rank=1536,
        rope_head_dim=64,
        nope_head_dim=128,
        v_head_dim=128,
    ),
    moe=MoEConfig(
        n_experts=160,
        top_k=6,
        n_shared=2,
        d_expert=1536,
        every_n_layers=1,
        first_dense=1,
    ),
    max_seq_len=32768,
)
