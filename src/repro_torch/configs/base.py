"""ModelConfig: the architecture fields the serving slice reads.

The port of ``repro/configs/base.py``.  Fields that only architectures not
yet ported read (MoE, MLA, Mamba, RWKV, frontends, tied embeddings, logit
soft-capping) come with those architectures.
"""
from __future__ import annotations

import dataclasses

from repro_torch.sparsity import SparsityConfig

__all__ = ["ModelConfig"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // n_heads
    # layer pattern, repeated cyclically: 'attn' (full causal) or 'swa'
    layer_pattern: tuple[str, ...] = ("attn",)
    sliding_window: int = 1024
    hidden_act: str = "silu"         # 'gelu' -> GeGLU MLP
    rmsnorm_eps: float = 1e-6
    rope_theta: float = 10000.0
    max_seq_len: int = 8192
    sparsity: SparsityConfig = dataclasses.field(default_factory=SparsityConfig)
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def layer_kind(self, i: int) -> str:
        return self.layer_pattern[i % len(self.layer_pattern)]

    def with_(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)
