"""Deterministic synthetic token data (numpy): the port of the token parts
of ``repro/data/synthetic.py``.

  * TokenStream: affine-recurrence sequences (t_{i+1} = a*t_i + c mod V)
    with random restarts and noise; iterating it yields the training
    batches ``{"tokens": (B, S)}``;
  * RequestStream: the serving workload — mixed-length requests whose
    prompts come from the same token process, with optional arrivals;
  * GaussianClassImages: CIFAR-shaped (B, 32, 32, 3) NHWC images around
    fixed class prototypes, for the vision models;
  * Prefetcher: background-thread double buffering around any iterator.

The same seed gives the reference's tokens, requests and images (the same
numpy RNG calls; multi-codebook streams come with the audio models).
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np

__all__ = ["TokenStream", "RequestStream", "GaussianClassImages",
           "Prefetcher"]


class TokenStream:
    """Deterministic learnable token batches (B, S)."""

    def __init__(self, vocab: int, batch: int, seq_len: int, seed: int = 0,
                 noise: float = 0.05, restart_p: float = 0.02):
        self.vocab = vocab
        self.batch = batch
        self.seq = seq_len
        self.seed = seed
        self.noise = noise
        self.restart_p = restart_p
        rng = np.random.default_rng(seed)
        self.a = int(rng.integers(2, max(vocab - 1, 3)) | 1)
        self.c = int(rng.integers(1, vocab))

    def batch_at(self, step: int) -> np.ndarray:
        rng = np.random.default_rng((self.seed, step))
        toks = np.zeros((self.batch, self.seq), np.int32)
        cur = rng.integers(0, self.vocab, size=(self.batch,))
        for s in range(self.seq):
            toks[:, s] = cur
            cur = (self.a * cur + self.c) % self.vocab
            restart = rng.random(cur.shape) < self.restart_p
            cur = np.where(restart, rng.integers(0, self.vocab, cur.shape), cur)
            flip = rng.random(cur.shape) < self.noise
            cur = np.where(flip, rng.integers(0, self.vocab, cur.shape), cur)
        return toks

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield {"tokens": self.batch_at(step)}
            step += 1


class RequestStream:
    """Deterministic serving workload: mixed-length requests with arrivals.

    Prompt/generation lengths are drawn from small fixed menus;
    ``arrival_step`` spaces requests by a geometric inter-arrival gap
    (``arrival_rate == 0``: everything arrives up front).
    """

    def __init__(self, vocab: int, n_requests: int,
                 prompt_lens: tuple[int, ...] = (8, 16, 24, 32),
                 gen_lens: tuple[int, ...] = (4, 8, 16, 32),
                 seed: int = 0, arrival_rate: float = 0.0):
        self.vocab = vocab
        self.n = n_requests
        self.prompt_lens = tuple(prompt_lens)
        self.gen_lens = tuple(gen_lens)
        self.seed = seed
        self.arrival_rate = arrival_rate

    def requests(self) -> list[dict]:
        """[{'rid', 'prompt' (S,) int32, 'max_new_tokens', 'arrival_step'}],
        sorted by arrival."""
        rng = np.random.default_rng((self.seed, 7))
        ts = TokenStream(self.vocab, 1, max(self.prompt_lens), seed=self.seed)
        out, step = [], 0
        for i in range(self.n):
            S = int(rng.choice(self.prompt_lens))
            gen = int(rng.choice(self.gen_lens))
            prompt = ts.batch_at(i)[0, :S]
            out.append({"rid": i, "prompt": prompt.astype(np.int32),
                        "max_new_tokens": gen, "arrival_step": step})
            if self.arrival_rate > 0:
                step += int(rng.geometric(min(self.arrival_rate, 1.0)))
        return out


class GaussianClassImages:
    """CIFAR-shaped (B, 32, 32, 3) images from fixed class prototypes:
    ``batch_at(step)`` gives ``{"images": float32, "labels": int32}``."""

    def __init__(self, n_classes: int, batch: int, seed: int = 0,
                 noise: float = 0.6, size: int = 32):
        self.n = n_classes
        self.batch = batch
        self.noise = noise
        self.size = size
        rng = np.random.default_rng(seed)
        self.protos = rng.standard_normal(
            (n_classes, size, size, 3)).astype(np.float32)
        self.seed = seed

    def batch_at(self, step: int) -> dict:
        rng = np.random.default_rng((self.seed + 1, step))
        labels = rng.integers(0, self.n, self.batch)
        imgs = self.protos[labels] + self.noise * rng.standard_normal(
            (self.batch, self.size, self.size, 3)).astype(np.float32)
        return {"images": imgs.astype(np.float32),
                "labels": labels.astype(np.int32)}

    def __iter__(self):
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


class Prefetcher:
    """Background-thread double buffering around any batch iterator."""

    def __init__(self, it: Iterator):
        self._it = iter(it)
        self._q: queue.Queue = queue.Queue(maxsize=2)
        self._done = object()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        try:
            for item in self._it:
                self._q.put(item)
        finally:
            self._q.put(self._done)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._done:
            raise StopIteration
        return item
