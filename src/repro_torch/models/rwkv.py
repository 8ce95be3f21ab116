"""RWKV-6 "Finch" block: data-dependent decay time-mix + channel-mix.

The port of ``repro/models/rwkv.py`` (arXiv:2404.05892): token shift with
data-dependent linear interpolation (ddlerp, LoRA-style), the per-channel
data-dependent decay ``w = exp(-exp(w_base + lora(x)))``, the per-head WKV
recurrence with bonus ``u`` in float32, a per-head group norm of the
read-out and the squared-ReLU channel mix.  The large projections
(r/k/v/g/o and the channel mix) are SparseLinear; the LoRA and mix vectors
are small and dense, kept in the parameter dtype (float32 unless the
config names another, as the reference's) and cast where the reference casts
them.  Both norms use the biased variance, as ``jnp.var`` does
(``torch.var`` defaults to the unbiased one).

The WKV recurrence (``wkv_scan``) is a Python loop over time in plain
torch, as the reference's is a ``lax.scan`` in plain JAX (no Pallas
kernel).  Its outer products ``k v^T`` are formed ``SCAN_CHUNK`` steps at
a time, so a prefill holds O(B * SCAN_CHUNK * H * hs^2) of them whatever
the prompt's length, as the reference's scan holds O(B * H * hs^2).
Decode carries ``x_tm`` / ``x_cm`` (the last normed input of each mix)
and ``state`` (B, H, hs, hs) in float32; each call replaces them with
new tensors.

Under ``tp`` (a ``parallel.RecurrentShard``, set by
``parallel.shard_module``) a rank runs the WKV recurrence, the decay, the
bonus and the group norm on its heads, and its ``state`` holds them.  The
token shift and the ddlerp read the whole normed input on every rank;
``r``, ``k``, ``v``, ``g`` and ``cmk`` are column-parallel (the rank's
heads, or its channels of d_ff), ``o`` is column-parallel too (the spec's
rule) and reads the whole read-out, gathered, its output gathered whole,
``cmv`` is row-parallel and ``cmr``'s output is gathered whole.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.sparsity import SparseLinear
from .common import SCAN_CHUNK, run_chunks

__all__ = ["RWKVBlock", "init_cache_rwkv", "wkv_scan"]


def init_cache_rwkv(batch: int, d_model: int, n_heads: int, head_size: int,
                    dtype=torch.bfloat16, device=None) -> dict:
    return {
        "x_tm": torch.zeros((batch, 1, d_model), dtype=dtype, device=device),
        "x_cm": torch.zeros((batch, 1, d_model), dtype=dtype, device=device),
        "state": torch.zeros((batch, n_heads, head_size, head_size),
                             dtype=torch.float32, device=device),
    }


def wkv_scan(r, k, v, wdec, u, s, chunk: int = SCAN_CHUNK):
    """The WKV recurrence: y_t = r_t (s + u k_t v_t^T), then
    s = w_t s + k_t v_t^T.  r, k, v, wdec (B, S, H, hs) and s (B, H, hs,
    hs) in float32, u (H, hs); returns (y (B, S, H, hs), the last s).
    ``chunk`` steps' outer products are formed at once (1: every step
    its own; the products are the same either way), each chunk's outputs
    stacked (``run_chunks``).  Steps are taken
    with ``unbind``, not by indexing: under autograd an index's backward
    writes a zero-filled gradient the size of the whole indexed tensor
    (a chunk's outer products, the whole prompt's r and w) every step,
    where ``unbind``'s stacks the steps' gradients once, the same
    values."""
    u = u[None, :, :, None]
    r_t, w_t = r.unbind(1), wdec.unbind(1)

    def body(t0, n, s):
        kv = k[:, t0:t0 + n, :, :, None] * v[:, t0:t0 + n, :, None, :]
        ys = []
        for i, (kv_i, ukv_i) in enumerate(zip(kv.unbind(1),
                                              (u * kv).unbind(1))):
            ys.append(torch.einsum("bhk,bhkv->bhv", r_t[t0 + i], s + ukv_i))
            s = w_t[t0 + i][..., None] * s + kv_i
        return torch.stack(ys, dim=1), s

    return run_chunks(body, k.shape[1], chunk, s)


def _shift(x: torch.Tensor, last: Optional[torch.Tensor]) -> torch.Tensor:
    """Token shift: y_t = x_{t-1}; position 0 comes from ``last`` (or 0)."""
    if last is None:
        return F.pad(x[:, :-1], (0, 0, 1, 0))
    return torch.cat([last.to(x.dtype), x[:, :-1]], dim=1)


class RWKVBlock(nn.Module):
    """A whole RWKV layer (time mix + channel mix, its own layer norms).
    The parameter names are the reference's.  ``device`` defaults to the
    card."""

    MIX = ("r", "k", "v", "w", "g")
    tp = None

    def __init__(self, cfg: ModelConfig, *, name: str = "rwkv", device=None,
                 dtype=torch.float32, param_dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if cfg.rwkv is None:
            raise ValueError(f"layer kind 'rwkv' needs cfg.rwkv ({cfg.name})")
        device = resolve_device(device)
        self.cfg = cfg
        self.rc = rc = cfg.rwkv
        d = cfg.d_model
        self.h = d // rc.head_size
        self.hs = rc.head_size
        sp = cfg.sparsity_rules
        kw = dict(device=device, dtype=dtype, param_dtype=param_dtype,
                  generator=generator)
        for nm in ("r", "k", "v", "g", "o"):
            self.add_module(nm, SparseLinear(d, d, sp, name=f"{name}.{nm}",
                                             **kw))
        self.cmk = SparseLinear(d, cfg.d_ff, sp, name=f"{name}.cmk", **kw)
        self.cmv = SparseLinear(cfg.d_ff, d, sp, name=f"{name}.cmv", **kw)
        self.cmr = SparseLinear(d, d, sp, name=f"{name}.cmr", **kw)

        def param(t):
            return nn.Parameter(t.float().to(param_dtype),
                                requires_grad=False)

        def randn(*shape):
            return torch.randn(shape, generator=generator, device=device)

        def rand(*shape):
            return torch.rand(shape, generator=generator, device=device)

        ones = lambda: torch.ones(d, device=device)
        zeros = lambda: torch.zeros(d, device=device)
        self.ln1_scale, self.ln1_bias = param(ones()), param(zeros())
        self.ln2_scale, self.ln2_bias = param(ones()), param(zeros())
        # ddlerp: base mixes + low-rank data-dependent adjustment
        self.mu_x = param(rand(d))
        self.mix_w1 = param(randn(d, 5 * rc.mix_lora) * 1e-2)
        self.mix_w2 = param(randn(5, rc.mix_lora, d) * 1e-2)
        # decay: per-channel base + LoRA
        self.w_base = param(torch.linspace(-6.0, -1.0, d, device=device))
        self.decay_w1 = param(randn(d, rc.decay_lora) * 1e-2)
        self.decay_w2 = param(randn(rc.decay_lora, d) * 1e-2)
        self.u = param(randn(d) * 0.1)
        self.gn_scale, self.gn_bias = param(ones()), param(zeros())
        self.mu_cm_k = param(rand(d))
        self.mu_cm_r = param(rand(d))
        for i, nm in enumerate(self.MIX):
            setattr(self, f"mu_{nm}",
                    param(torch.full((d,), (i + 1) / 6.0, device=device)))

    @staticmethod
    def _ln(x, scale, bias):
        x32 = x.float()
        m = torch.mean(x32, dim=-1, keepdim=True)
        v = torch.var(x32, dim=-1, keepdim=True, correction=0)
        y = (x32 - m) * torch.rsqrt(v + 1e-5)
        return (y * scale + bias).to(x.dtype)

    def _mine(self, t: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """A per-channel tensor at this rank's channels (whole unsharded)."""
        return t if self.tp is None else self.tp.read(t, dim)

    def _group_norm(self, x: torch.Tensor) -> torch.Tensor:
        """Per-head normalization of the WKV read-out; x: (B, S, H, hs)."""
        m = torch.mean(x, dim=-1, keepdim=True)
        v = torch.var(x, dim=-1, keepdim=True, correction=0)
        y = (x - m) * torch.rsqrt(v + 64e-5)
        B, S = x.shape[:2]
        return (y.reshape(B, S, -1) * self._mine(self.gn_scale)
                + self._mine(self.gn_bias))

    def _time_mix(self, x, cache):
        from repro_torch.parallel.tensor import whole_output

        B, S, D = x.shape
        tp, hs = self.tp, self.hs
        H = self.h if tp is None else (tp.hi - tp.lo) // hs
        dt_ = x.dtype
        xs = _shift(x, cache["x_tm"] if cache is not None else None)
        dx = xs - x
        # ddlerp: the token-shift amount is itself data-dependent (Finch)
        xxx = x + dx * self.mu_x.to(dt_)
        z = torch.tanh(xxx @ self.mix_w1.to(dt_)).reshape(B, S, 5, -1)
        adj = torch.einsum("bsfl,fld->bsfd", z, self.mix_w2.to(dt_))
        feeds = {nm: x + dx * (getattr(self, f"mu_{nm}").to(dt_)
                               + adj[:, :, i])
                 for i, nm in enumerate(self.MIX)}
        r = self.r(feeds["r"]).reshape(B, S, H, hs).float()
        k = self.k(feeds["k"]).reshape(B, S, H, hs).float()
        v = self.v(feeds["v"]).reshape(B, S, H, hs).float()
        g = F.silu(self.g(feeds["g"]))
        # data-dependent decay in (0, 1); the LoRA's inner product is
        # whole on every rank, its output read at the rank's channels
        lora = torch.tanh(feeds["w"].float() @ self.decay_w1.float())
        if tp is not None:
            from repro_torch.parallel.comm import to_ranks

            lora = to_ranks(lora, tp.axis)
        wdec = (self._mine(self.w_base).float()
                + lora @ self._mine(self.decay_w2).float())
        wdec = torch.exp(-torch.exp(wdec)).reshape(B, S, H, hs)
        s = (cache["state"] if cache is not None else
             torch.zeros((B, H, hs, hs), dtype=torch.float32,
                         device=x.device))
        y, s = wkv_scan(r, k, v, wdec,
                        self._mine(self.u).float().reshape(H, hs), s)
        y = self._group_norm(y).to(dt_) * g
        if tp is not None:
            from repro_torch.parallel.comm import gather_cat

            y = gather_cat(y, tp.axis)
        return whole_output(self.o, self.o(y)), x[:, -1:], s

    def _channel_mix(self, x, cache):
        from repro_torch.parallel.tensor import whole_output

        dt_ = x.dtype
        xs = _shift(x, cache["x_cm"] if cache is not None else None)
        dx = xs - x
        xk = x + dx * self.mu_cm_k.to(dt_)
        xr = x + dx * self.mu_cm_r.to(dt_)
        k = torch.relu(self.cmk(xk)) ** 2
        v = self.cmv(k)
        r = torch.sigmoid(whole_output(self.cmr, self.cmr(xr)))
        return r * v, x[:, -1:]

    def forward(self, x: torch.Tensor, positions: torch.Tensor, *,
                cache: Optional[dict] = None):
        """The whole layer, residuals included; returns (y, cache), the
        cache's entries replaced by new tensors."""
        h, last_tm, state = self._time_mix(
            self._ln(x, self.ln1_scale, self.ln1_bias), cache)
        x = x + h
        h2, last_cm = self._channel_mix(
            self._ln(x, self.ln2_scale, self.ln2_bias), cache)
        x = x + h2
        if cache is not None:
            cache["x_tm"] = last_tm.to(cache["x_tm"].dtype, copy=True)
            cache["x_cm"] = last_cm.to(cache["x_cm"].dtype, copy=True)
            cache["state"] = state
        return x, cache
