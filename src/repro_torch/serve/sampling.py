"""Token sampling for the serving engine (the port of
``repro/serve/sampling.py``).

Greedy is ``argmax`` with the lowest index winning ties, applied the same
way by the engine and the sequential path.  Stochastic sampling is
reproducible per request: request r's step i draws from a
``torch.Generator`` seeded from (seed, r, i), whatever batch row or engine
step the request occupies.  The draws are not the reference's (JAX keys
and torch generators give different numbers), so the port's sampling is
checked against itself, by determinism.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = ["SamplingParams", "sample_token", "greedy"]


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    temperature: float = 0.0     # <= 0: greedy
    top_k: int = 0               # 0: no truncation
    seed: int = 0

    @property
    def is_greedy(self) -> bool:
        return self.temperature <= 0.0


def greedy(logits) -> np.ndarray:
    """argmax over the vocab axis (first maximum wins); (V,) or (..., V)."""
    return np.asarray(np.argmax(np.asarray(logits), axis=-1))


def _generator(seed: int, request_salt: int, step: int) -> torch.Generator:
    state = np.random.SeedSequence([seed, request_salt, step]).generate_state(2)
    return torch.Generator().manual_seed(
        (int(state[0]) << 32 | int(state[1])) & ((1 << 63) - 1))


def sample_token(logits, params: SamplingParams, *, request_salt: int = 0,
                 step: int = 0) -> np.ndarray:
    """Sample one token id from (V,) logits (host array)."""
    if params.is_greedy:
        return greedy(logits)
    z = torch.as_tensor(np.asarray(logits, np.float32))
    if 0 < params.top_k < z.shape[-1]:
        # exact-k: a stable descending sort ranks ties lowest-index-first,
        # so exactly k tokens survive and the tie-break is deterministic
        order = torch.sort(z, dim=-1, descending=True, stable=True).indices
        ranks = torch.empty_like(order)
        ranks.scatter_(-1, order, torch.arange(z.shape[-1]).expand_as(order))
        z = torch.where(ranks < params.top_k, z,
                        torch.full_like(z, -float("inf")))
    probs = torch.softmax(z / params.temperature, dim=-1)
    g = _generator(params.seed, request_salt, step)
    flat = probs.reshape(-1, probs.shape[-1])
    tok = torch.multinomial(flat, 1, generator=g).reshape(probs.shape[:-1])
    return np.asarray(tok.numpy())
