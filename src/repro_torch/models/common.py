"""Shared model components: RMSNorm, embedding table, rotary embeddings.

The port of ``repro/models/common.py``.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.device import resolve_device

__all__ = ["RMSNorm", "Embedding", "rope_frequencies", "apply_rope",
           "SCAN_CHUNK", "run_chunks"]

#: time steps whose per-step products the recurrent scans form at once
#: (``rwkv.wkv_scan``, ``ssm.selective_scan``): a prefill's memory for
#: them is bounded by this many steps, not by the prompt's length
SCAN_CHUNK = 64


#: where set, ``run_chunks`` hands its scan to it first:
#: ``scan_runner(body, n_steps, chunk, state)`` returns what ``run_chunks``
#: would, or None to leave the scan to the plain loop (the dry-run's op
#: counter sets it while it reckons a scan by its trip count,
#: ``analysis.OpCounter``)
scan_runner = None


def run_chunks(body, n_steps: int, chunk: int, state):
    """A scan over steps [0, n_steps) in chunks of ``chunk``: ``body(t0,
    n, state) -> (ys (B, n, ...), state)`` for each, in order; returns
    (the chunks' ys concatenated along dim 1, the last state).  A body
    reads its steps at ``t0``, whichever chunks ran before it
    (``scan_runner`` may run only some of them)."""
    if scan_runner is not None:
        out = scan_runner(body, n_steps, chunk, state)
        if out is not None:
            return out
    outs = []
    for t0 in range(0, n_steps, chunk):
        ys, state = body(t0, min(chunk, n_steps - t0), state)
        outs.append(ys)
    return (outs[0] if len(outs) == 1 else torch.cat(outs, 1)), state


class RMSNorm(nn.Module):
    """Normalizes in f32 and returns the input's dtype; ``scale`` is stored
    in ``dtype`` (the parameter dtype, as the reference's) and multiplies
    in f32.  ``device`` defaults to the card; without CUDA that raises,
    naming ``device="cpu"``."""

    def __init__(self, dim: int, eps: float = 1e-6, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.dim = dim
        self.eps = eps
        self.scale = nn.Parameter(
            torch.ones(dim, dtype=dtype, device=resolve_device(device)),
            requires_grad=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        var = torch.mean(x32 * x32, dim=-1, keepdim=True)
        y = x32 * torch.rsqrt(var + self.eps)
        return (y * self.scale).to(x.dtype)


class Embedding(nn.Module):
    """Token table, stored in the compute dtype (the reference casts the
    whole table to it on every lookup; casting once is the same values).
    ``device`` defaults to the card, as ``RMSNorm``'s.  ``tp`` (a
    ``parallel.VocabShard``, set by ``parallel.shard_module``) keeps rows
    [lo, hi) of the table: a lookup outside them gives zeros, summed over
    the ranks in rank order (one rank's row and zeros: exact); a tied
    head reads the same rows (``LMModel._logits``).  ``fsdp`` (a
    ``parallel.DataShard``) holds a data rank's share of the table's
    columns, gathered whole at each read (``parallel.on_use``)."""

    tp = None
    fsdp = None

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
        from repro_torch.parallel.tensor import on_use

        table = on_use(self, "embedding")
        if self.tp is None:
            return F.embedding(tokens, table)
        from repro_torch.parallel.comm import gather_sum

        lo, hi = self.tp.lo, self.tp.hi
        local = tokens - lo
        inside = (local >= 0) & (local < hi - lo)
        e = F.embedding(torch.where(inside, local, 0), table)
        return gather_sum(e * inside[..., None].to(e.dtype), self.tp.axis)


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
