"""Serving example: batched prefill + decode with an RBGP4-sparse LM.

The port of the reference's ``examples/serve_lm.py``: KV caches (full and
sliding-window: the gemma3-family reduced config interleaves 5 local
layers with 1 global one), greedy and temperature sampling, and the
compact-storage sparse projections (backend ``auto``: the
``rbgp4mm_rhs`` kernel on the card, its plain version on the CPU).
Greedy decoding is held against the teacher-forced forward of the same
tokens.

Run:  PYTHONPATH=src python -m repro_torch.examples.serve_lm [--device cpu]
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import apply_sparsity, get_config, reduce_config
from repro_torch.data import TokenStream
from repro_torch.device import synchronize
from repro_torch.models import LMModel
from repro_torch.serve.sampling import SamplingParams, sample_token

BATCH, PROMPT, GEN = 4, 24, 24


def build(device, n_layers: int = 6, sparsity: float = 0.5) -> LMModel:
    """The reduced gemma3-4b at ``n_layers``, RBGP4 compact storage."""
    cfg = reduce_config(get_config("gemma3-4b")).with_(n_layers=n_layers)
    cfg = apply_sparsity(cfg, pattern="rbgp4", sparsity=sparsity,
                         backend="auto", min_dim=64)
    model = LMModel(cfg, device=device, seed=0)
    print(f"serving {cfg.name}: {model.n_params():,} params, layer pattern "
          f"{cfg.layer_pattern} (window={cfg.sliding_window}) on "
          f"{model.device}")
    return model


def generate(model: LMModel, prompts: np.ndarray, gen: int,
             temperature: float = 0.0, seed: int = 0) -> np.ndarray:
    """Prefill ``prompts`` (B, S), then ``gen`` decode steps; greedy at
    temperature 0, else sampled (each row's draw seeded by (seed, row,
    step)).  Returns the continuation (B, gen)."""
    b, s = prompts.shape
    params = SamplingParams(temperature=temperature, seed=seed)

    def pick(logits, step):
        lg = logits.float().cpu().numpy()
        return np.stack([sample_token(lg[r], params, request_salt=r,
                                      step=step) for r in range(b)])

    cache = model.init_cache(b, s + gen, torch.float32)
    t0 = time.perf_counter()
    logits, cache = model.prefill(prompts, cache)
    synchronize(model.device)
    print(f"prefill {b}x{s}: {(time.perf_counter() - t0) * 1e3:.0f} ms")
    tok = pick(logits, 0)
    outs = []
    t0 = time.perf_counter()
    for i in range(gen):
        outs.append(tok)
        logits, cache = model.decode_step(tok[:, None], cache, s + i)
        tok = pick(logits, i + 1)
    synchronize(model.device)
    dt = time.perf_counter() - t0
    kind = "greedy" if params.is_greedy else f"temperature {temperature}"
    print(f"decode {gen} steps ({kind}): {dt * 1e3:.0f} ms "
          f"({b * gen / dt:.0f} tok/s, {dt / gen * 1e3:.1f} ms/step)")
    return np.stack(outs, 1)


@torch.no_grad()
def teacher_forced_agreement(model: LMModel, prompts: np.ndarray,
                             outs: np.ndarray) -> float:
    """The share of greedy tokens that the full forward of prompt +
    continuation predicts at the same positions."""
    full = np.concatenate([prompts, outs], 1)
    logits, _ = model(full)
    ref_next = logits[:, prompts.shape[1] - 1:-1].argmax(-1).cpu().numpy()
    return float(np.mean(ref_next == outs))


def main(argv=None) -> float:
    """Serve; returns the teacher-forced agreement of greedy decoding."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)
    model = build(args.device)
    prompts = TokenStream(model.cfg.vocab_size, BATCH, PROMPT,
                          seed=1).batch_at(0)
    outs = generate(model, prompts, GEN)
    print(f"continuation (req 0): {outs[0].tolist()}")
    match = teacher_forced_agreement(model, prompts, outs)
    print(f"teacher-forced agreement: {match:.2%}")
    assert match > 0.99, "incremental decode diverged from full forward"
    sampled = generate(model, prompts, GEN, temperature=0.8, seed=0)
    print(f"sampled at temperature 0.8 (req 0): {sampled[0].tolist()}")
    print("serve example OK")
    return match


if __name__ == "__main__":
    main()
