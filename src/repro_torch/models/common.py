"""Shared model components: RMSNorm, embedding table, rotary embeddings.

The port of ``repro/models/common.py``.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.device import resolve_device

__all__ = ["RMSNorm", "Embedding", "rope_frequencies", "apply_rope"]


class RMSNorm(nn.Module):
    """Normalizes in f32 and returns the input's dtype; ``scale`` is f32.
    ``device`` defaults to the card; without CUDA that raises, naming
    ``device="cpu"``."""

    def __init__(self, dim: int, eps: float = 1e-6, *, device=None):
        super().__init__()
        self.dim = dim
        self.eps = eps
        self.scale = nn.Parameter(
            torch.ones(dim, dtype=torch.float32,
                       device=resolve_device(device)),
            requires_grad=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        var = torch.mean(x32 * x32, dim=-1, keepdim=True)
        y = x32 * torch.rsqrt(var + self.eps)
        return (y * self.scale).to(x.dtype)


class Embedding(nn.Module):
    """Token table, stored in the compute dtype (the reference casts the
    whole table to it on every lookup; casting once is the same values).
    ``device`` defaults to the card, as ``RMSNorm``'s."""

    def __init__(self, vocab: int, dim: int, *, dtype=torch.float32,
                 param_dtype=torch.float32, device=None, generator=None):
        super().__init__()
        device = resolve_device(device)
        self.vocab = vocab
        self.dim = dim
        e = torch.randn((vocab, dim), generator=generator, device=device,
                        dtype=torch.float32) * (dim ** -0.5)
        self.embedding = nn.Parameter(e.to(param_dtype).to(dtype),
                                      requires_grad=False)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return F.embedding(tokens, self.embedding)


def rope_frequencies(head_dim: int, theta: float = 10000.0,
                     device=None) -> torch.Tensor:
    """(head_dim//2,) f32 inverse frequencies (computed in float64 first,
    as the reference does)."""
    inv = 1.0 / (theta ** (np.arange(0, head_dim, 2) / head_dim))
    return torch.tensor(inv, dtype=torch.float32, device=device)


def apply_rope(x: torch.Tensor, inv_freq: torch.Tensor,
               positions: torch.Tensor) -> torch.Tensor:
    """x: (B, S, H, hd); positions: (B, S) absolute positions."""
    ang = positions[:, :, None, None].float() * inv_freq
    c = torch.cos(ang)  # (B, S, 1, hd/2)
    s = torch.sin(ang)
    x1, x2 = x.float().chunk(2, dim=-1)
    y1 = x1 * c - x2 * s
    y2 = x2 * c + x1 * s
    return torch.cat([y1, y2], dim=-1).to(x.dtype)
