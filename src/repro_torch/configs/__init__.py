"""Config registry of the port: ``get_config``, ``reduce_config``,
``apply_sparsity`` (the port of ``repro/configs/__init__.py``).

Only the ported architectures are listed; every other architecture of the
reference raises "not yet ported".
"""
from __future__ import annotations

import dataclasses
import importlib
import math

from repro_torch.sparsity import SparsityConfig

from .base import ModelConfig, MoEConfig, TrainConfig

ARCHS = {
    "tinyllama-1.1b": "tinyllama_1_1b",
    "qwen2-moe-a2.7b": "qwen2_moe_a2_7b",
}

#: architectures of the reference whose port comes with a later slice
NOT_YET_PORTED = (
    "gemma-7b", "gemma3-4b", "deepseek-7b", "pixtral-12b",
    "deepseek-v2-236b", "rwkv6-7b", "jamba-1.5-large-398b",
    "musicgen-medium", "vgg19-cifar", "wrn40-4-cifar",
)


def get_config(name: str) -> ModelConfig:
    if name in NOT_YET_PORTED:
        raise NotImplementedError(
            f"arch {name!r} is not yet ported; have {sorted(ARCHS)}")
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; have {sorted(ARCHS)}")
    mod = importlib.import_module(f"repro_torch.configs.{ARCHS[name]}")
    return mod.CONFIG


def apply_sparsity(cfg: ModelConfig, pattern: str = "rbgp4",
                   sparsity: float = 0.75, backend: str = "auto",
                   min_dim: int = 1024, plan=None) -> ModelConfig:
    """Enable the paper's technique on a config.  ``plan`` (a
    ``SparsityPlan``) takes precedence over the uniform knobs and is
    matched per module path."""
    if plan is not None:
        return cfg.with_(plan=plan)
    return cfg.with_(sparsity=SparsityConfig(
        pattern=pattern, sparsity=sparsity, backend=backend, min_dim=min_dim,
    ))


def reduce_config(cfg: ModelConfig) -> ModelConfig:
    """Small same-family config: tiny dims, few layers, CPU-runnable.

    The reference's ``reduce_config`` for the ported families, with the
    sparsity backend 'auto' (compact storage).  It keeps the MoE cadence:
    the period is the lcm of the layer pattern and ``every_n_layers``, the
    ``first_dense`` layers stay in front.
    """
    period = len(cfg.layer_pattern)
    if cfg.moe is not None:
        period = math.lcm(period, cfg.moe.every_n_layers)
    head = cfg.moe.first_dense if cfg.moe else 0
    n_layers = min(cfg.n_layers, head + 2 * period + max(period - 1, 0))
    kv_ratio = max(cfg.n_heads // cfg.n_kv_heads, 1)
    n_heads = 4
    n_kv = max(n_heads // min(kv_ratio, 4), 1)
    moe = cfg.moe
    if moe is not None:
        moe = dataclasses.replace(
            moe, n_experts=min(moe.n_experts, 8), top_k=min(moe.top_k, 2),
            n_shared=min(moe.n_shared, 1), d_expert=64)
    sp = SparsityConfig(pattern="rbgp4", sparsity=0.5, backend="auto",
                        min_dim=64)
    return cfg.with_(
        name=cfg.name + "-smoke",
        n_layers=n_layers,
        d_model=64,
        n_heads=n_heads,
        n_kv_heads=n_kv,
        head_dim=16,
        d_ff=128,
        vocab_size=997,
        sliding_window=min(cfg.sliding_window, 16),
        max_seq_len=256,
        moe=moe,
        sparsity=sp,
        compute_dtype="float32",
    )


__all__ = ["ARCHS", "get_config", "apply_sparsity",
           "reduce_config", "ModelConfig", "MoEConfig", "TrainConfig"]
