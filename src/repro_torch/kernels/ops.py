"""The differentiable sparse projections: ``RBGP4Linear``, for the stacked
experts of a MoE layer ``RBGP4LinearStacked``, and for deep-chain storage
``ChainLinear``.

The port of ``repro/kernels/ops.py`` ``RBGP4Op._build_linear_rhs``: the
token-major ``y = act(x @ W_s^T + b) + r`` with its transpose-free
backward, all three products on the hand-written kernels (on the card) or
their plain versions (on the CPU):

  forward  ``rbgp4mm_rhs``, with the pre-activation Z saved only where an
           activation is fused (``save_preact``);
  backward gz = g * act'(z) in f32, cast back to g's dtype;
           db = gz.sum(0); dr = g;
           dW = ``rbgp4_sddmm_rhs(gz, x)``, in compact storage;
           dX = ``rbgp4mm_rhs`` on the transposed layout's tables, over
           the values permuted into that layout.

``RBGP4LinearStacked`` is ``RBGP4Op._build_linear_stacked``: the same
three products for all experts at once, each one launch of the stacked
kernels (``rbgp4mm_rhs_stacked``, ``rbgp4_sddmm_rhs_stacked``), with
db = gz.sum(1), no residual, and dX over the values permuted per expert.

``ChainLinear`` is ``repro/kernels/chainmm.py`` ``ChainOp``'s custom VJP:
y = ``chainmm_rhs``; dW = ``chain_sddmm_rhs(g, x)``; dX = ``chainmm_rhs``
on the transposed layout's tables over the permuted values.  It has no
epilogue: ``sparse_linear`` adds bias, activation and residual in torch
after it, and autograd differentiates them.

Unlike the reference's ``jax.custom_vjp``, a gradient is computed only
for the inputs that need one.  The layer's tables (forward and
transposed) are built once by the owning module and passed in.
"""
from __future__ import annotations

from typing import Optional

import torch

from .chainmm import (ChainTables, ChainTransposeTables, chain_sddmm_rhs,
                      chainmm_rhs)
from .rbgp4mm import (EPILOGUE_ACTS, KernelTables, TransposeTables,
                      rbgp4_sddmm_rhs, rbgp4_sddmm_rhs_stacked, rbgp4mm_rhs,
                      rbgp4mm_rhs_stacked)

__all__ = ["RBGP4Linear", "RBGP4LinearStacked", "ChainLinear", "act_bwd"]


def act_bwd(fuse: str, z: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """gz = g * act'(z), in f32 and returned in g's dtype (the reference's
    ``_act_bwd``: the vjp of the activation at the saved pre-activation)."""
    with torch.enable_grad():
        z32 = z.detach().float().requires_grad_()
        y = EPILOGUE_ACTS[fuse](z32)
    (gz,) = torch.autograd.grad(y, z32, g.float())
    return gz.to(g.dtype)


class RBGP4Linear(torch.autograd.Function):
    """``RBGP4Linear.apply(x2, w_data, bias, residual, tables, tables_t,
    fuse)`` -> y (N, M) for x2 (N, K); ``bias``, ``residual`` and ``fuse``
    may be None.  ``tables_t`` (the transposed layout's tables) is needed
    only when x2 needs a gradient."""

    @staticmethod
    def forward(ctx, x2: torch.Tensor, w_data: torch.Tensor,
                bias: Optional[torch.Tensor],
                residual: Optional[torch.Tensor], tables: KernelTables,
                tables_t: Optional[TransposeTables],
                fuse: Optional[str]) -> torch.Tensor:
        if tables_t is None and ctx.needs_input_grad[0]:
            raise ValueError("dX needs the transposed layout's tables")
        z = None
        if fuse is None:
            # no activation: Z is never read by the backward, so it is
            # not stored
            y = rbgp4mm_rhs(tables, x2, w_data, bias=bias, residual=residual)
        else:
            y, z = rbgp4mm_rhs(tables, x2, w_data, bias=bias, act=fuse,
                               residual=residual, save_preact=True)
        ctx.save_for_backward(x2, w_data, z)
        ctx.tables, ctx.tables_t, ctx.fuse = tables, tables_t, fuse
        ctx.bias_dtype = bias.dtype if bias is not None else None
        ctx.residual_dtype = residual.dtype if residual is not None else None
        return y

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        x2, w_data, z = ctx.saved_tensors
        need_x, need_w, need_b, need_r = ctx.needs_input_grad[:4]
        g = g.to(x2.dtype).contiguous()
        gz = act_bwd(ctx.fuse, z, g) if ctx.fuse is not None else g
        db = gz.sum(0).to(ctx.bias_dtype) if need_b else None
        dr = g.to(ctx.residual_dtype) if need_r else None
        dw = (rbgp4_sddmm_rhs(ctx.tables, gz, x2).to(w_data.dtype)
              if need_w else None)
        dx = None
        if need_x:
            t = ctx.tables_t
            dx = rbgp4mm_rhs(t.tables, gz, t.values(w_data)).to(x2.dtype)
        return dx, dw, db, dr, None, None, None


class RBGP4LinearStacked(torch.autograd.Function):
    """``RBGP4LinearStacked.apply(x3, w_data, bias, tables, tables_t,
    fuse)`` -> y (E, N, M) for x3 (E, N, K) and stacked w_data
    (E, M, nnz_row); ``bias`` (E, M) and ``fuse`` may be None.
    ``tables_t`` is needed only when x3 needs a gradient."""

    @staticmethod
    def forward(ctx, x3: torch.Tensor, w_data: torch.Tensor,
                bias: Optional[torch.Tensor], tables: KernelTables,
                tables_t: Optional[TransposeTables],
                fuse: Optional[str]) -> torch.Tensor:
        if tables_t is None and ctx.needs_input_grad[0]:
            raise ValueError("dX needs the transposed layout's tables")
        z = None
        if fuse is None:
            y = rbgp4mm_rhs_stacked(tables, x3, w_data, bias=bias)
        else:
            y, z = rbgp4mm_rhs_stacked(tables, x3, w_data, bias=bias,
                                       act=fuse, save_preact=True)
        ctx.save_for_backward(x3, w_data, z)
        ctx.tables, ctx.tables_t, ctx.fuse = tables, tables_t, fuse
        ctx.bias_dtype = bias.dtype if bias is not None else None
        return y

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        x3, w_data, z = ctx.saved_tensors
        need_x, need_w, need_b = ctx.needs_input_grad[:3]
        g = g.to(x3.dtype).contiguous()
        gz = act_bwd(ctx.fuse, z, g) if ctx.fuse is not None else g
        db = gz.sum(1).to(ctx.bias_dtype) if need_b else None
        dw = (rbgp4_sddmm_rhs_stacked(ctx.tables, gz, x3).to(w_data.dtype)
              if need_w else None)
        dx = None
        if need_x:
            t = ctx.tables_t
            dx = rbgp4mm_rhs_stacked(t.tables, gz,
                                     t.values(w_data)).to(x3.dtype)
        return dx, dw, db, None, None, None


class ChainLinear(torch.autograd.Function):
    """``ChainLinear.apply(x2, w_data, tables, tables_t)`` -> y (N, M) for
    x2 (N, K) and chain values w_data (M, nnz_row).  ``tables_t`` (the
    transposed layout's tables and permutation) is needed only when x2
    needs a gradient."""

    @staticmethod
    def forward(ctx, x2: torch.Tensor, w_data: torch.Tensor,
                tables: ChainTables,
                tables_t: Optional[ChainTransposeTables]) -> torch.Tensor:
        if tables_t is None and ctx.needs_input_grad[0]:
            raise ValueError("dX needs the transposed layout's tables")
        ctx.save_for_backward(x2, w_data)
        ctx.tables, ctx.tables_t = tables, tables_t
        return chainmm_rhs(tables, x2, w_data)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        x2, w_data = ctx.saved_tensors
        need_x, need_w = ctx.needs_input_grad[:2]
        g = g.to(x2.dtype).contiguous()
        dw = (chain_sddmm_rhs(ctx.tables, g, x2).to(w_data.dtype)
              if need_w else None)
        dx = None
        if need_x:
            t = ctx.tables_t
            dx = chainmm_rhs(t.tables, g, t.values(w_data)).to(x2.dtype)
        return dx, dw, None, None
