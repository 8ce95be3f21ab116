"""Config registry of the port: ``get_config``, ``list_archs``,
``reduce_config``, ``apply_sparsity`` and the shape cells (the port of
``repro/configs/__init__.py``).

All twelve architectures of the reference: ten language models
(``ModelConfig``) and the paper's ``vgg19-cifar`` and ``wrn40-4-cifar``
(``VisionConfig``, ``repro_torch.models.vision``).  The shape cells
(``LM_SHAPES``, ``shape_cells``, ``LONG_CONTEXT_ARCHS``) are the dry-run's
(``repro_torch.launch.dryrun``); ``input_specs`` gives a cell's inputs as
``meta`` tensors, the counterpart of the reference's
``ShapeDtypeStruct``s: shapes and dtypes, no storage.
"""
from __future__ import annotations

import dataclasses
import importlib
import math
from typing import Optional

import torch

from repro_torch.sparsity import SparsityConfig

from .base import (LM_SHAPES, MambaConfig, MLAConfig, ModelConfig,
                   MoEConfig, RWKVConfig, ShapeConfig, TrainConfig)

ARCHS = {
    "gemma-7b": "gemma_7b",
    "tinyllama-1.1b": "tinyllama_1_1b",
    "gemma3-4b": "gemma3_4b",
    "deepseek-7b": "deepseek_7b",
    "pixtral-12b": "pixtral_12b",
    "deepseek-v2-236b": "deepseek_v2_236b",
    "qwen2-moe-a2.7b": "qwen2_moe_a2_7b",
    "rwkv6-7b": "rwkv6_7b",
    "jamba-1.5-large-398b": "jamba_1_5_large_398b",
    "musicgen-medium": "musicgen_medium",
    "vgg19-cifar": "vgg19_cifar",
    "wrn40-4-cifar": "wrn40_4_cifar",
}

# archs with sub-quadratic sequence mixing: the only ones running long_500k
# (see DESIGN.md §5 "Shape-cell skips")
LONG_CONTEXT_ARCHS = {"rwkv6-7b", "jamba-1.5-large-398b", "gemma3-4b"}


def get_config(name: str):
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; have {sorted(ARCHS)}")
    mod = importlib.import_module(f"repro_torch.configs.{ARCHS[name]}")
    return mod.CONFIG


def list_archs(lm_only: bool = False) -> list[str]:
    names = list(ARCHS)
    if lm_only:
        names = [n for n in names if not n.endswith("-cifar")]
    return names


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


def reduce_config(cfg: ModelConfig, *,
                  sparsity_backend: str = "auto") -> ModelConfig:
    """Small same-family config: tiny dims, few layers, CPU-runnable.

    The reference's ``reduce_config``; its ``sparsity_backend`` defaults to
    'auto' (compact storage), the port's default backend, where the
    reference's defaults to 'xla_masked'.  It keeps the layer pattern, the
    MoE cadence (the period is the lcm of the pattern and
    ``every_n_layers``, the ``first_dense`` layers stay in front) and the
    mixer kinds: MLA, Mamba and RWKV keep their sub-configs at small ranks,
    a vision frontend 4 patches, a codebook model a vocabulary of 128.
    """
    period = len(cfg.layer_pattern)
    if cfg.moe is not None:
        period = math.lcm(period, cfg.moe.every_n_layers)
    head = cfg.moe.first_dense if cfg.moe else 0
    n_layers = min(cfg.n_layers, head + 2 * period + max(period - 1, 0))
    kv_ratio = max(cfg.n_heads // cfg.n_kv_heads, 1)
    n_heads = 4
    n_kv = max(n_heads // min(kv_ratio, 4), 1)
    rwkv = cfg.rwkv
    d_model = 64
    if rwkv is not None:
        rwkv = dataclasses.replace(rwkv, head_size=16, decay_lora=8,
                                   mix_lora=8)
        n_heads = n_kv = d_model // 16
    moe = cfg.moe
    if moe is not None:
        moe = dataclasses.replace(
            moe, n_experts=min(moe.n_experts, 8), top_k=min(moe.top_k, 2),
            n_shared=min(moe.n_shared, 1), d_expert=64)
    mla = cfg.mla
    if mla is not None:
        mla = dataclasses.replace(
            mla, kv_lora_rank=32, q_lora_rank=32 if mla.q_lora_rank else 0,
            rope_head_dim=8, nope_head_dim=16, v_head_dim=16)
    mamba = cfg.mamba
    if mamba is not None:
        mamba = dataclasses.replace(mamba, d_state=4)
    sp = SparsityConfig(pattern="rbgp4", sparsity=0.5,
                        backend=sparsity_backend, min_dim=64)
    return cfg.with_(
        name=cfg.name + "-smoke",
        n_layers=n_layers,
        d_model=d_model,
        n_heads=n_heads,
        n_kv_heads=n_kv,
        head_dim=16,
        d_ff=128,
        vocab_size=128 if cfg.n_codebooks > 1 else 997,
        sliding_window=min(cfg.sliding_window, 16),
        max_seq_len=256,
        n_patches=4 if cfg.frontend == "vision" else 0,
        moe=moe, mla=mla, mamba=mamba, rwkv=rwkv,
        sparsity=sp,
        plan=None,  # plans are shape-specific, as in the reference
        compute_dtype="float32",
    )


# ---------------------------------------------------------------------------
# shape cells
# ---------------------------------------------------------------------------

def shape_cells(cfg: ModelConfig) -> list[tuple[ShapeConfig, Optional[str]]]:
    """All 4 assigned cells as (shape, skip_reason_or_None)."""
    out = []
    for shp in LM_SHAPES:
        skip = None
        if shp.name == "long_500k" and cfg.name not in LONG_CONTEXT_ARCHS:
            skip = (
                "pure full-attention arch: 500k-token full-attention decode "
                "is quadratic-history; run only for SSM/hybrid/local-global "
                "archs (DESIGN.md §5)"
            )
        out.append((shp, skip))
    return out


def _token_spec(cfg: ModelConfig, batch: int, seq: int) -> torch.Tensor:
    tail = (cfg.n_codebooks,) if cfg.n_codebooks > 1 else ()
    return torch.empty((batch, seq, *tail), dtype=torch.int32, device="meta")


def input_specs(cfg: ModelConfig, shape: ShapeConfig, *,
                cache_dtype=torch.bfloat16) -> dict:
    """The (arch x shape) cell's inputs as ``meta`` tensors.

    train/prefill: {'batch': {'tokens', ['patch_embeds']}}
    decode:        {'tokens_new', 'cache', 'index'}, the cache the port's
                   per-layer list (``LMModel.init_cache``)
    """
    B, S = shape.global_batch, shape.seq_len
    if shape.kind in ("train", "prefill"):
        batch = {"tokens": _token_spec(cfg, B, S)}
        if cfg.frontend == "vision":
            batch["patch_embeds"] = torch.empty(
                (B, cfg.n_patches, cfg.d_model), dtype=torch.bfloat16,
                device="meta")
        return {"batch": batch}
    # decode: one new token against a cache of S past tokens
    from repro_torch.models import LMModel

    model = LMModel(cfg, device="meta")
    return {
        "tokens_new": _token_spec(cfg, B, 1),
        "cache": model.init_cache(B, S, cache_dtype),
        "index": torch.empty((), dtype=torch.int32, device="meta"),
    }


__all__ = ["ARCHS", "LONG_CONTEXT_ARCHS", "LM_SHAPES", "ShapeConfig",
           "get_config", "list_archs", "apply_sparsity", "reduce_config",
           "shape_cells", "input_specs", "ModelConfig", "MoEConfig", "MLAConfig",
           "MambaConfig", "RWKVConfig", "TrainConfig"]
