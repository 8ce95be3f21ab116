"""The differentiable sparse products: ``RBGP4Linear``, for the stacked
experts of a MoE layer ``RBGP4LinearStacked``, for deep-chain storage
``ChainLinear``, the paper's feature-major ``RBGP4MatMul``, and the
per-layer bundle ``RBGP4Op`` (with its cache ``get_op``) over them.

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

``RBGP4MatMul`` is the custom VJP of the reference's ``RBGP4Op.matmul``,
O = W_s @ I for feature-major I (K, N): O = ``rbgp4mm``; dW =
``rbgp4_sddmm(g, x)``; dI = ``rbgp4mm`` on the transposed layout's tables
over the permuted values.

Unlike the reference's ``jax.custom_vjp``, a gradient is computed only
for the inputs that need one.  The layer's tables (forward and
transposed) are built once by the owning module and passed in.

``compact_linear``, ``compact_linear_stacked``, ``compact_matmul`` and
``chain_linear`` are the one dispatch of compact and chain storage that
``sparse_linear``, ``sparse_linear_batched``, ``sparse_matmul`` and
``RBGP4Op`` share: the autograd function where a gradient is asked for,
else the kernel directly, so that serving stores no pre-activation and
never builds the transposed tables.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device

from .chainmm import (ChainTables, ChainTransposeTables, chain_sddmm_rhs,
                      chainmm_rhs)
from .rbgp4mm import (EPILOGUE_ACTS, KernelTables, TransposeTables,
                      rbgp4_sddmm, rbgp4_sddmm_rhs, rbgp4_sddmm_rhs_stacked,
                      rbgp4mm, rbgp4mm_rhs, rbgp4mm_rhs_stacked)

__all__ = ["RBGP4Linear", "RBGP4LinearStacked", "ChainLinear",
           "RBGP4MatMul", "RBGP4Op", "get_op", "compact_linear",
           "compact_linear_stacked", "compact_matmul", "chain_linear",
           "layout_cache_key",
           "needs_grad", "act_bwd"]


def needs_grad(*tensors) -> bool:
    """Whether autograd will ask for a gradient of any of ``tensors``
    (None entries ignored)."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


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


class RBGP4MatMul(torch.autograd.Function):
    """``RBGP4MatMul.apply(w_data, x, tables, tables_t)`` -> O (M, N) =
    W_s @ I for feature-major x = I (K, N) and compact w_data (M,
    nnz_row).  ``tables_t`` (the transposed layout's tables and
    permutation) is needed only when x needs a gradient."""

    @staticmethod
    def forward(ctx, w_data: torch.Tensor, x: torch.Tensor,
                tables: KernelTables,
                tables_t: Optional[TransposeTables]) -> torch.Tensor:
        if tables_t is None and ctx.needs_input_grad[1]:
            raise ValueError("dI needs the transposed layout's tables")
        ctx.save_for_backward(w_data, x)
        ctx.tables, ctx.tables_t = tables, tables_t
        return rbgp4mm(tables, x, w_data)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        w_data, x = ctx.saved_tensors
        need_w, need_x = ctx.needs_input_grad[:2]
        g = g.to(x.dtype).contiguous()
        dw = (rbgp4_sddmm(ctx.tables, g, x).to(w_data.dtype)
              if need_w else None)
        dx = None
        if need_x:
            t = ctx.tables_t
            dx = rbgp4mm(t.tables, g, t.values(w_data)).to(x.dtype)
        return dw, dx, None, None


def layout_cache_key(layout) -> tuple:
    """Content key of an RBGP4 layout: its spec and adjacency bytes.  A
    ``transpose_layout()`` product shares the forward graph samples, which
    a layout designed from the transposed spec does not (and a square spec
    transposes to itself), so the spec alone is no key."""
    return (layout.spec, np.asarray(layout.adj_o).tobytes(),
            np.asarray(layout.adj_i).tobytes())


def _tables_t(tables_t: Optional[Callable[[], object]],
              x: torch.Tensor) -> Optional[object]:
    """The transposed layout's tables, asked of ``tables_t`` only when x
    needs a gradient (serving never builds them)."""
    return tables_t() if x.requires_grad and tables_t is not None else None


def compact_linear(tables: KernelTables, x: torch.Tensor,
                   w_data: torch.Tensor, *,
                   bias: Optional[torch.Tensor] = None,
                   fuse: Optional[str] = None,
                   residual: Optional[torch.Tensor] = None,
                   tables_t: Optional[Callable[[], TransposeTables]] = None
                   ) -> torch.Tensor:
    """y = act(x @ W_s^T + bias) + residual, token-major; x (..., K) ->
    (..., M): through ``RBGP4Linear`` where a gradient is asked for, else
    the kernel directly (no pre-activation stored).  ``tables_t`` returns
    the transposed layout's tables."""
    d = tables.dims
    lead = x.shape[:-1]
    x2 = x.reshape(-1, d.k).contiguous()
    r2 = (residual.reshape(-1, d.m).contiguous()
          if residual is not None else None)
    if needs_grad(x2, w_data, bias, r2):
        y = RBGP4Linear.apply(x2, w_data, bias, r2, tables,
                              _tables_t(tables_t, x2), fuse)
    else:
        y = rbgp4mm_rhs(tables, x2, w_data, bias=bias, act=fuse, residual=r2)
    return y.reshape(*lead, d.m)


def compact_linear_stacked(tables: KernelTables, x: torch.Tensor,
                           w_data: torch.Tensor, *,
                           bias: Optional[torch.Tensor] = None,
                           fuse: Optional[str] = None,
                           tables_t: Optional[Callable[[], TransposeTables]]
                           = None) -> torch.Tensor:
    """Stacked experts over one layout: x (E, ..., K), w_data (E, M,
    nnz_row) -> (E, ..., M), one launch for all experts; through
    ``RBGP4LinearStacked`` where a gradient is asked for."""
    d = tables.dims
    e = x.shape[0]
    x3 = x.reshape(e, -1, d.k).contiguous()
    if needs_grad(x3, w_data, bias):
        y = RBGP4LinearStacked.apply(x3, w_data, bias, tables,
                                     _tables_t(tables_t, x3), fuse)
    else:
        y = rbgp4mm_rhs_stacked(tables, x3, w_data, bias=bias, act=fuse)
    return y.reshape(*x.shape[:-1], d.m)


def compact_matmul(tables: KernelTables, w_data: torch.Tensor,
                   x: torch.Tensor, *,
                   tables_t: Optional[Callable[[], TransposeTables]] = None
                   ) -> torch.Tensor:
    """O = W_s @ I, feature-major; x (K, N) -> (M, N): through
    ``RBGP4MatMul`` where a gradient is asked for, else the kernel
    directly."""
    w, x = w_data.contiguous(), x.contiguous()
    if needs_grad(w, x):
        return RBGP4MatMul.apply(w, x, tables, _tables_t(tables_t, x))
    return rbgp4mm(tables, x, w)


def chain_linear(tables: ChainTables, x: torch.Tensor, w_data: torch.Tensor,
                 *, tables_t: Optional[Callable[[], ChainTransposeTables]]
                 = None) -> torch.Tensor:
    """y = x @ W_s^T from deep-chain storage; x (..., K) -> (..., M):
    through ``ChainLinear`` where a gradient is asked for, else the kernel
    directly."""
    x2 = x.reshape(-1, tables.k).contiguous()
    if needs_grad(x2, w_data):
        y = ChainLinear.apply(x2, w_data, tables, _tables_t(tables_t, x2))
    else:
        y = chainmm_rhs(tables, x2, w_data)
    return y.reshape(*x.shape[:-1], tables.m)


class RBGP4Op:
    """One RBGP4 layout's kernels on one device (the reference's
    ``RBGP4Op``): the forward tables are built here, the transposed
    layout's tables (dI, dX, ``transpose_data``) at their first use.

    ``matmul`` is the paper's feature-major product with its VJP;
    ``linear`` and ``linear_stacked`` are the token-major projections.
    ``device`` defaults to the card; without CUDA that raises, naming
    ``device="cpu"``.
    """

    def __init__(self, layout, device=None):
        self.layout = layout
        self.device = resolve_device(device)
        self.tables = KernelTables.build(layout, self.device)
        self.dims = self.tables.dims
        self._tables_t: Optional[TransposeTables] = None

    def transpose_tables(self) -> TransposeTables:
        """The transposed layout's tables and slot permutation (built at
        the first call, then kept)."""
        if self._tables_t is None:
            self._tables_t = TransposeTables.build(self.layout, self.device)
        return self._tables_t

    def transpose_data(self, w_data: torch.Tensor) -> torch.Tensor:
        """The compact values of W^T in the transposed layout."""
        if w_data.ndim != 2:
            raise ValueError(f"w_data {tuple(w_data.shape)} is not (M, "
                             f"nnz_row); use transpose_data_stacked")
        return self.transpose_tables().values(w_data)

    def transpose_data_stacked(self, w_data: torch.Tensor) -> torch.Tensor:
        """Per-expert transpose of stacked (E, M, nnz_row) values."""
        if w_data.ndim != 3:
            raise ValueError(f"w_data {tuple(w_data.shape)} is not (E, M, "
                             f"nnz_row)")
        return self.transpose_tables().values(w_data)

    def matmul(self, w_data: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """O = W_s @ I; w_data (M, nnz_row), x (K, N) -> (M, N)."""
        return compact_matmul(self.tables, w_data, x,
                              tables_t=self.transpose_tables)

    def linear(self, x: torch.Tensor, w_data: torch.Tensor, *,
               bias: Optional[torch.Tensor] = None,
               fuse: Optional[str] = None,
               residual: Optional[torch.Tensor] = None) -> torch.Tensor:
        """y = act(x @ W_s^T + bias) + residual, token-major; x (..., K)
        -> (..., M)."""
        return compact_linear(self.tables, x, w_data, bias=bias, fuse=fuse,
                              residual=residual,
                              tables_t=self.transpose_tables)

    def linear_stacked(self, x: torch.Tensor, w_data: torch.Tensor, *,
                       bias: Optional[torch.Tensor] = None,
                       fuse: Optional[str] = None) -> torch.Tensor:
        """Batched-expert linear over this one layout: x (E, ..., K),
        w_data (E, M, nnz_row) -> (E, ..., M)."""
        return compact_linear_stacked(self.tables, x, w_data, bias=bias,
                                      fuse=fuse,
                                      tables_t=self.transpose_tables)

    def init_data(self, generator: Optional[torch.Generator] = None,
                  dtype=torch.float32,
                  scale: Optional[float] = None) -> torch.Tensor:
        """He init over the present connections, on the op's device: every
        row's fan-in is ``nnz_per_row``."""
        scale = (scale if scale is not None
                 else (2.0 / self.layout.spec.nnz_per_row) ** 0.5)
        w = torch.randn(self.layout.data_shape, generator=generator,
                        device=self.device, dtype=torch.float32) * scale
        return w.to(dtype)


_OP_CACHE: dict[tuple, RBGP4Op] = {}


def get_op(layout, device=None) -> RBGP4Op:
    """``RBGP4Op(layout, device)``, cached on the layout's content (spec
    and adjacency bytes, ``layout_cache_key``) and the device: every layer
    of one layout shares one op and its tables."""
    dev = resolve_device(device)
    key = (layout_cache_key(layout), str(dev))
    op = _OP_CACHE.get(key)
    if op is None:
        op = _OP_CACHE[key] = RBGP4Op(layout, dev)
    return op
