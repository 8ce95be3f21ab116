"""MoEConfig, MLAConfig, MambaConfig, RWKVConfig, ModelConfig and
TrainConfig.

The port of ``repro/configs/base.py``, the language models' fields all
ported.  Left out: ``ssm_unroll`` (the reference's unroll factor of its
``lax.scan`` over time, a TPU compile knob; the port's scans are Python
loops), the shape cells (``ShapeConfig``, ``LM_SHAPES``: JAX's dry-run
cells) and the reference's ``distill_alpha`` / ``distill_temp``:
distillation is a ``loss_fn`` here (``train/distill.py``).
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
from typing import Optional

from repro_torch.sparsity import SparsityConfig, SparsityPlan, lower_config

__all__ = ["ShapeConfig", "LM_SHAPES", "MoEConfig", "MLAConfig",
           "MambaConfig", "RWKVConfig",
           "ModelConfig", "TrainConfig"]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    n_shared: int = 0
    d_expert: int = 0            # expert hidden dim (d_ff of each expert)
    every_n_layers: int = 1      # MoE replaces the MLP every n layers
    first_dense: int = 0         # first k layers keep a dense MLP
    capacity_factor: float = 1.25
    aux_loss_coef: float = 0.01
    # the router runs in float32, as the reference's does; MoELayer
    # refuses any other value
    router_dtype: str = "float32"


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    kv_lora_rank: int = 512
    q_lora_rank: int = 1536
    rope_head_dim: int = 64
    nope_head_dim: int = 128
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class MambaConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0  # 0 -> ceil(d_model / 16)


@dataclasses.dataclass(frozen=True)
class RWKVConfig:
    head_size: int = 64
    decay_lora: int = 64
    mix_lora: int = 32


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    family: str = "dense"            # dense | moe | ssm | hybrid | vlm | audio
    head_dim: int = 0                # 0 -> d_model // n_heads
    # layer pattern, repeated cyclically over layers: 'attn' (full
    # causal), 'swa' (sliding window), 'mla', 'mamba', 'rwkv'
    layer_pattern: tuple[str, ...] = ("attn",)
    sliding_window: int = 1024
    hidden_act: str = "silu"         # 'gelu' -> GeGLU MLP
    rmsnorm_eps: float = 1e-6
    rope_theta: float = 10000.0
    max_seq_len: int = 8192
    tie_embeddings: bool = False     # the head is the embedding's transpose
    logit_softcap: float = 0.0       # > 0: logits -> tanh(z / c) * c
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    mamba: Optional[MambaConfig] = None
    rwkv: Optional[RWKVConfig] = None
    # modality frontend stub: 'vision' (the first n_patches positions take
    # given patch embeddings) or 'audio' (n_codebooks ids a step, their
    # embeddings summed, one head of n_codebooks * vocab rows)
    frontend: Optional[str] = None
    n_codebooks: int = 1
    n_patches: int = 0
    # the paper's technique: ``sparsity`` is the uniform knob (a one-rule
    # plan); ``plan`` is the per-layer SparsityPlan and wins when set.
    # Model constructors only see the resolved plan (``sparsity_rules``)
    # and match their module paths against it.
    sparsity: SparsityConfig = dataclasses.field(default_factory=SparsityConfig)
    plan: Optional[SparsityPlan] = None
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    # training recomputes each layer's forward in the backward (the
    # reference's per-period ``jax.checkpoint``)
    remat: bool = True

    @property
    def sparsity_rules(self) -> SparsityPlan:
        """The plan every model constructor resolves against: ``plan`` if
        set, else ``sparsity`` lowered to a uniform one-rule plan."""
        return (self.plan if self.plan is not None
                else lower_config(self.sparsity))

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def layer_kind(self, i: int) -> str:
        return self.layer_pattern[i % len(self.layer_pattern)]

    def is_moe_layer(self, i: int) -> bool:
        if self.moe is None:
            return False
        if i < self.moe.first_dense:
            return False
        return (i - self.moe.first_dense) % self.moe.every_n_layers == 0

    def with_(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # 'train' | 'prefill' | 'decode'


LM_SHAPES = (
    ShapeConfig("train_4k", 4096, 256, "train"),
    ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    ShapeConfig("decode_32k", 32768, 128, "decode"),
    ShapeConfig("long_500k", 524288, 1, "decode"),
)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    optimizer: str = "sgdm"          # paper uses SGD momentum 0.9, wd 1e-4
    lr: float = 0.1
    momentum: float = 0.9
    weight_decay: float = 1e-4
    adam_b1: float = 0.9
    adam_b2: float = 0.95
    adam_eps: float = 1e-8
    schedule: str = "cosine"         # 'step' for the paper's VGG/WRN recipe
    warmup_steps: int = 100
    total_steps: int = 1000
    lr_step_epochs: tuple[int, ...] = (60, 120, 160)
    lr_step_gamma: float = 0.1
    microbatches: int = 1            # gradient accumulation
    grad_clip: float = 1.0
    grad_compression: str = "none"   # 'int8': error-feedback Q/DQ of grads
    checkpoint_every: int = 100
    checkpoint_dir: str = os.path.join(tempfile.gettempdir(), "repro_ckpt")
