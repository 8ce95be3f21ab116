"""pixtral-12b [vlm]: 40L d_model=5120 32H (GQA kv=8) d_ff=14336 vocab=131072.

Mistral-Nemo decoder backbone (hf:mistralai/Pixtral-12B-2409).  The Pixtral
ViT frontend is a stub, as in the reference: the caller gives precomputed
patch embeddings (B, n_patches, d_model), ``patch_embeds=``, that replace
the first n_patches token embeddings.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="pixtral-12b",
    family="vlm",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=131072,
    hidden_act="silu",
    frontend="vision",
    n_patches=256,
    max_seq_len=32768,
)
