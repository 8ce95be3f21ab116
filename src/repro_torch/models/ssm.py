"""Mamba selective-SSM mixer (Jamba's sequence mixer).

The port of ``repro/models/ssm.py``.  The big in/out projections (and the
``x`` projection to dt, B and C) are SparseLinear; the depthwise causal
conv (``d_conv`` taps) and the SSM parameters are small and dense, kept in
the parameter dtype (float32 unless the config names another, as the
reference's) and cast where the reference casts them.  The selective scan is a
Python loop over time in plain torch with a float32 state, as the
reference's is a ``lax.scan`` in plain JAX: no Pallas kernel stands behind
it, so none stands behind it here.  The per-step decay ``exp(delta * A)``
and input ``delta * x * B`` are formed ``SCAN_CHUNK`` steps at a time
(``selective_scan``; the same elementwise products), so a step is three
tensor ops and a prefill holds O(B * SCAN_CHUNK * d_inner * d_state) of
them whatever the prompt's length.

Decode carries a (conv window, ssm state) cache of O(1) size: ``conv`` the
last ``d_conv - 1`` pre-activation inputs, ``h`` (B, d_inner, d_state) in
float32.  Each call replaces both with new tensors: nothing the next step
writes aliases them.

Under ``tp`` (a ``parallel.RecurrentShard``, set by
``parallel.shard_module``) a rank runs the conv, the scan, ``D`` and the
gate on its channels [lo, hi) of d_inner, and its cache holds them.
``in``'s rows are the spec's contiguous cut of [x; z], so its output is
gathered whole and x and z read at the rank's channels; ``x`` reads the
whole d_inner (gathered) and its dt | B | C are gathered whole; ``out``
is row-parallel over the rank's channels.  A channel's sums and their
order do not change.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.sparsity import SparseLinear
from .common import SCAN_CHUNK, run_chunks

__all__ = ["MambaMixer", "init_cache_mamba", "selective_scan", "softplus"]


def init_cache_mamba(batch: int, d_inner: int, d_conv: int, d_state: int,
                     dtype=torch.bfloat16, device=None) -> dict:
    return {
        "conv": torch.zeros((batch, d_conv - 1, d_inner), dtype=dtype,
                            device=device),
        "h": torch.zeros((batch, d_inner, d_state), dtype=torch.float32,
                         device=device),
    }


def softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + e^x) exactly, as ``jax.nn.softplus`` (``F.softplus`` returns
    x itself above its threshold of 20)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def selective_scan(delta, a, xb, b, c, h, chunk: int = SCAN_CHUNK):
    """h = exp(delta_t A) h + delta_t x_t B_t, y_t = h C_t, over time.
    delta and xb (B, S, d_inner), b and c (B, S, d_state), h (B, d_inner,
    d_state), all float32, a (d_inner, d_state); returns (y (B, S,
    d_inner), the last h).  ``chunk`` steps' decays and inputs are formed
    at once (1: every step its own; the products are the same either
    way), each chunk's outputs stacked (``run_chunks``).  Steps are taken
    with ``unbind``, not by indexing, whose backward would write a
    zero-filled gradient of the whole indexed tensor every step
    (``wkv_scan``)."""
    c_t = c.unbind(1)

    def body(t0, n, h):
        sl = slice(t0, t0 + n)
        da = torch.exp(delta[:, sl, :, None] * a)     # (B, n, di, ds)
        dbx = (delta[:, sl] * xb[:, sl])[..., None] * b[:, sl, None, :]
        ys = []
        for i, (da_i, dbx_i) in enumerate(zip(da.unbind(1), dbx.unbind(1))):
            h = da_i * h + dbx_i
            ys.append(torch.einsum("bds,bs->bd", h, c_t[t0 + i]))
        return torch.stack(ys, dim=1), h

    return run_chunks(body, delta.shape[1], chunk, h)


class MambaMixer(nn.Module):
    """in -> causal depthwise conv -> SiLU -> selective scan -> gate ->
    out.  The parameter names are the reference's: ``in``, ``x``, ``out``
    (SparseLinear), ``conv_w``, ``conv_b``, ``dt_w``, ``dt_bias``,
    ``a_log``, ``d``.  ``device`` defaults to the card."""

    tp = None

    def __init__(self, cfg: ModelConfig, *, name: str = "mamba", device=None,
                 dtype=torch.float32, param_dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if cfg.mamba is None:
            raise ValueError(f"layer kind 'mamba' needs cfg.mamba "
                             f"({cfg.name})")
        device = resolve_device(device)
        self.cfg = cfg
        self.mc = mc = cfg.mamba
        d = cfg.d_model
        self.d_inner = di = mc.expand * d
        self.dt_rank = mc.dt_rank or max(1, math.ceil(d / 16))
        sp = cfg.sparsity_rules
        kw = dict(device=device, dtype=dtype, param_dtype=param_dtype,
                  generator=generator)
        # ``in`` is a Python keyword: registered by name
        self.add_module("in", SparseLinear(d, 2 * di, sp, name=f"{name}.in",
                                           **kw))
        self.x = SparseLinear(di, self.dt_rank + 2 * mc.d_state, sp,
                              name=f"{name}.x", **kw)
        self.out = SparseLinear(di, d, sp, name=f"{name}.out", **kw)

        def param(t):
            return nn.Parameter(t.float().to(param_dtype),
                                requires_grad=False)

        def randn(*shape):
            return torch.randn(shape, generator=generator, device=device)

        dt = torch.exp(
            torch.rand((di,), generator=generator, device=device)
            * (math.log(0.1) - math.log(0.001)) + math.log(0.001))
        self.conv_w = param(randn(mc.d_conv, di) / math.sqrt(mc.d_conv))
        self.conv_b = param(torch.zeros(di, device=device))
        self.dt_w = param(randn(di, self.dt_rank) * self.dt_rank ** -0.5)
        # inverse softplus: softplus(dt_bias) == dt at init
        self.dt_bias = param(torch.log(torch.expm1(dt)))
        self.a_log = param(torch.log(
            torch.arange(1, mc.d_state + 1, dtype=torch.float32,
                         device=device).expand(di, mc.d_state)))
        self.d = param(torch.ones(di, device=device))

    def forward(self, x: torch.Tensor, positions: torch.Tensor, *,
                cache: Optional[dict] = None):
        """x: (B, S, D) -> (y, cache); the cache's window and state are
        replaced (new tensors), not written into."""
        mc, ds = self.mc, self.mc.d_state
        B, S, _ = x.shape
        dt_ = x.dtype
        tp, di = self.tp, self.d_inner
        proj = getattr(self, "in")
        if tp is None:
            xb, z = proj(x).chunk(2, dim=-1)
            mine = lambda t, dim=-1: t
        else:
            from repro_torch.parallel.comm import gather_cat, to_ranks
            from repro_torch.parallel.tensor import whole_output

            xz = to_ranks(whole_output(proj, proj(x)), tp.axis)
            xb = xz[..., tp.lo:tp.hi]
            z = xz[..., di + tp.lo:di + tp.hi]
            mine = tp.read

        # depthwise causal conv over time
        if cache is not None:
            ctx = torch.cat([cache["conv"].to(dt_), xb], dim=1)
        else:
            ctx = F.pad(xb, (0, 0, mc.d_conv - 1, 0))
        w = mine(self.conv_w).to(dt_)
        conv = 0
        for j in range(mc.d_conv):
            conv = conv + ctx[:, j:j + S, :] * w[j]
        xb = F.silu(conv + mine(self.conv_b).to(dt_))

        if tp is None:
            dbc = self.x(xb)
        else:
            dbc = to_ranks(whole_output(self.x, self.x(gather_cat(
                xb, tp.axis))), tp.axis)
        dt_r = dbc[..., :self.dt_rank]
        b_ssm = dbc[..., self.dt_rank:self.dt_rank + ds].float()
        c_ssm = dbc[..., self.dt_rank + ds:].float()
        delta = softplus(dt_r.float() @ mine(self.dt_w, 0).float().T
                         + mine(self.dt_bias))
        a = -torch.exp(mine(self.a_log, 0))           # (di, ds)
        h = (cache["h"] if cache is not None else
             torch.zeros((B, xb.shape[-1], ds), dtype=torch.float32,
                         device=x.device))
        y, h = selective_scan(delta, a, xb.float(), b_ssm, c_ssm, h)
        y = y.to(dt_)                                 # (B, S, di)
        y = y + xb * mine(self.d).to(dt_)
        y = y * F.silu(z)
        out = self.out(y)
        if cache is not None:
            # the last (d_conv - 1) pre-activation inputs, copied out of ctx
            cache["conv"] = ctx[:, -(mc.d_conv - 1):].to(cache["conv"].dtype,
                                                          copy=True)
            cache["h"] = h
        return out, cache
