"""Weight containers and the one dispatch point of every projection.

The port of ``repro/sparsity/api.py`` for the storages ported so far:

  ``DenseWeight``    plain (M, K) values: ``x @ w.T`` with ``torch.matmul``
                     (the reference computes it outside Pallas too).
  ``CompactWeight``  compact RBGP4 (M, nnz_row) values + their layout's
                     kernel tables: the ``rbgp4mm_rhs`` kernel on the
                     card, its plain version on the CPU, with bias,
                     activation and residual fused into the kernel's
                     epilogue.  Where a gradient is asked for, the call
                     goes through ``RBGP4Linear`` (dW and dX on the
                     kernels too); without one it calls the kernel
                     directly, so serving stores no pre-activation.
  ``ChainWeight``    deep-chain (M, nnz_row) values + their layout's table
                     (``sparsity/chain.py``): the ``chainmm_rhs`` kernel,
                     through ``ChainLinear`` where a gradient is asked
                     for; no fused epilogue: bias, activation and residual
                     follow in torch, as in the reference.

``sparse_linear_batched`` is the stacked-expert projection of a MoE layer,
x (E, ..., K) -> (E, ..., M): a ``CompactWeight`` with stacked
``w_data`` (E, M, nnz_row) over one layout runs one launch of the
``rbgp4mm_rhs_stacked`` kernel for all experts (through
``RBGP4LinearStacked`` where a gradient is asked for); a ``DenseWeight``
with stacked ``w`` (E, M, K) is the dense path for shapes the pattern does
not apply to.

``sparse_matmul`` is the paper's feature-major product, O = W_s @ I (+ b
per row) for I (K, N): a ``CompactWeight`` runs the ``rbgp4mm`` kernel
(through ``RBGP4MatMul`` where a gradient is asked for: dW on
``rbgp4_sddmm``, dI on ``rbgp4mm`` over the transposed layout); a
``DenseWeight`` and a ``ChainWeight`` are one ``torch.matmul`` of the dense
matrix, as the reference computes them outside any kernel (a chain's dW
reaches its compact values through autograd).

``QuantizedWeight`` is the reference's weight-only int8 storage of a
compact or chain container (``sparsity/quant.py`` makes it): int8 leaf
blocks ``q_data`` and one float32 scale per (G, C) leaf block.  It is the
reference's ``QuantBackend``, a branch of each dispatch: on the card
``sparse_linear`` launches the int8 path of ``rbgp4mm_rhs`` or
``chainmm_rhs`` and ``sparse_linear_batched`` that of
``rbgp4mm_rhs_stacked``, with no epilogue in the kernel (bias, activation
and residual follow in torch, as the reference's dispatcher applies
them); on the CPU the container is dequantized and the call delegated to
the wrapped container's own path, as the reference does off the TPU, so
the result is bit for bit that of the dequantized weights.
``sparse_matmul`` dequantizes and delegates everywhere, and chain storage
has no stacked experts.  PTQ storage is inference-only: an input that
needs a gradient raises.

``dense_weight`` materializes the dense (M, K) matrix of any of them.  The
reference's masked storage and its backend registry come with later
slices.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Union

import torch

from repro_torch.kernels import (EPILOGUE_ACTS, ChainTables, KernelTables,
                                 TransposeTables, chainmm_rhs, rbgp4mm_rhs,
                                 rbgp4mm_rhs_stacked)
from repro_torch.kernels.ops import (chain_linear, compact_linear,
                                     compact_linear_stacked, compact_matmul,
                                     needs_grad)

from .chain import ChainWeight

__all__ = ["DenseWeight", "CompactWeight", "ChainWeight", "QuantizedWeight",
           "SparseWeight", "sparse_linear", "sparse_linear_batched",
           "sparse_matmul", "dense_weight"]


@dataclasses.dataclass
class DenseWeight:
    """Plain dense values: ``w`` (M, K), optional bias ``b`` (M,); stacked
    over experts, (E, M, K) and (E, M)."""

    w: torch.Tensor
    b: Optional[torch.Tensor] = None


@dataclasses.dataclass
class CompactWeight:
    """Compact RBGP4 storage: ``w_data`` (M, nnz_row) + the kernel tables
    of its layout, and ``tables_t``, which returns the tables of its
    transpose (built once by the owning module); it is called only when
    the input needs a gradient.  Stacked experts share one layout:
    ``w_data`` (E, M, nnz_row), ``b`` (E, M)."""

    w_data: torch.Tensor
    tables: KernelTables
    b: Optional[torch.Tensor] = None
    tables_t: Optional[Callable[[], TransposeTables]] = None


@dataclasses.dataclass
class QuantizedWeight:
    """int8 leaf-block storage of a compact or chain container (weight-only
    PTQ): ``q_data`` int8 of the wrapped ``w_data``'s shape, ``scales``
    float32 (..., M/G, S), one per (G, C) leaf block, ``b`` the bias in
    full precision, the wrapped container's kernel ``tables`` (which give
    (G, C)), ``kind`` ('compact' | 'chain') and ``orig_dtype``, the value
    dtype ``dequantize`` returns by default."""

    q_data: torch.Tensor
    scales: torch.Tensor
    tables: Union[KernelTables, ChainTables]
    b: Optional[torch.Tensor] = None
    kind: str = "compact"
    orig_dtype: torch.dtype = torch.float32

    def dequantize(self, dtype=None) -> Union[CompactWeight, ChainWeight]:
        """The wrapped full-precision container."""
        from .quant import dequantize_block_values, leaf_block_dims

        G, C = leaf_block_dims(self.tables)
        w = dequantize_block_values(self.q_data, self.scales, G, C,
                                    dtype=dtype or self.orig_dtype)
        cls = ChainWeight if self.kind == "chain" else CompactWeight
        return cls(w_data=w, tables=self.tables, b=self.b)


SparseWeight = Union[DenseWeight, CompactWeight, ChainWeight,
                     QuantizedWeight]


def _check_fuse(fuse: Optional[str]) -> None:
    if fuse is not None and fuse not in EPILOGUE_ACTS:
        raise ValueError(
            f"fuse {fuse!r} not a fusable activation "
            f"{sorted(EPILOGUE_ACTS)}; apply it outside sparse_linear"
        )


def _no_grad_through(weight: QuantizedWeight, *tensors) -> None:
    if needs_grad(weight.b, *tensors):
        raise RuntimeError(
            "weight-only int8 (PTQ) storage is inference-only: it has no "
            "gradient; run it under torch.no_grad(), or train the "
            "full-precision container (dequantize_weights)")


def _quant_linear(weight: QuantizedWeight, x: torch.Tensor) -> torch.Tensor:
    """x (..., K) @ W^T from int8 storage on the card: the int8 kernel,
    no epilogue."""
    t = weight.tables
    m, k = (t.dims.m, t.dims.k) if weight.kind == "compact" else (t.m, t.k)
    x2 = x.reshape(-1, k).contiguous()
    run = rbgp4mm_rhs if weight.kind == "compact" else chainmm_rhs
    y = run(t, x2, weight.q_data, scales=weight.scales)
    return y.reshape(*x.shape[:-1], m)


def sparse_linear(weight: SparseWeight, x: torch.Tensor, *, dtype=None,
                  fuse: Optional[str] = None,
                  residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """y = act(x @ W_s^T + b) + residual; x (..., K) token-major -> (..., M)."""
    _check_fuse(fuse)
    if isinstance(weight, QuantizedWeight):
        _no_grad_through(weight, x, residual)
        if x.device.type == "cpu":
            return sparse_linear(weight.dequantize(), x, dtype=dtype,
                                 fuse=fuse, residual=residual)
    dtype = dtype or x.dtype
    xc = x.to(dtype)
    b = weight.b.to(dtype) if weight.b is not None else None
    if isinstance(weight, CompactWeight):
        return compact_linear(
            weight.tables, xc, weight.w_data.to(dtype), bias=b, fuse=fuse,
            residual=residual.to(dtype) if residual is not None else None,
            tables_t=weight.tables_t)
    if isinstance(weight, ChainWeight):
        y = chain_linear(weight.tables, xc, weight.w_data.to(dtype),
                         tables_t=weight.tables_t)
    elif isinstance(weight, QuantizedWeight):
        y = _quant_linear(weight, xc)
    elif isinstance(weight, DenseWeight):
        y = xc @ weight.w.to(dtype).T
    else:
        raise TypeError(f"not a weight container: {type(weight).__name__}")
    if b is not None:
        y = y + b
    if fuse is not None:
        y = EPILOGUE_ACTS[fuse](y)
    if residual is not None:
        y = y + residual.to(dtype)
    return y


def sparse_linear_batched(weight: SparseWeight, x: torch.Tensor, *,
                          dtype=None,
                          fuse: Optional[str] = None) -> torch.Tensor:
    """Stacked-expert linear: y[e] = act(x[e] @ W_s[e]^T + b[e]);
    x (E, ..., K) -> (E, ..., M)."""
    _check_fuse(fuse)
    if isinstance(weight, QuantizedWeight):
        if weight.kind == "chain":
            raise NotImplementedError(
                "stacked-expert execution is compact-storage only (chain "
                "layers are not expert-stacked)")
        _no_grad_through(weight, x)
        if x.device.type == "cpu":
            return sparse_linear_batched(weight.dequantize(), x, dtype=dtype,
                                         fuse=fuse)
    dtype = dtype or x.dtype
    xc = x.to(dtype)
    e = xc.shape[0]
    b = weight.b.to(dtype) if weight.b is not None else None
    if isinstance(weight, CompactWeight):
        return compact_linear_stacked(weight.tables, xc,
                                      weight.w_data.to(dtype), bias=b,
                                      fuse=fuse, tables_t=weight.tables_t)
    x3 = xc.reshape(e, -1, xc.shape[-1])
    if isinstance(weight, QuantizedWeight):
        y = rbgp4mm_rhs_stacked(weight.tables, x3.contiguous(),
                                weight.q_data, scales=weight.scales)
    elif isinstance(weight, DenseWeight):
        y = torch.einsum("enk,emk->enm", x3, weight.w.to(dtype))
    else:
        raise TypeError(f"not a weight container: {type(weight).__name__}")
    if b is not None:
        y = y + b[:, None, :]
    if fuse is not None:
        y = EPILOGUE_ACTS[fuse](y)
    return y.reshape(*xc.shape[:-1], y.shape[-1])


def sparse_matmul(weight: SparseWeight, x: torch.Tensor, *,
                  dtype=None) -> torch.Tensor:
    """O = W_s @ I (+ b per row); x (K, N) feature-major -> (M, N)."""
    if isinstance(weight, QuantizedWeight):
        # no int8 feature-major kernel: dequantize and delegate, on every
        # device (the reference's QuantBackend.matmul)
        _no_grad_through(weight, x)
        return sparse_matmul(weight.dequantize(), x, dtype=dtype)
    dtype = dtype or x.dtype
    xc = x.to(dtype)
    if isinstance(weight, CompactWeight):
        out = compact_matmul(weight.tables, weight.w_data.to(dtype), xc,
                             tables_t=weight.tables_t)
    elif isinstance(weight, ChainWeight):
        out = dense_weight(weight, dtype) @ xc
    elif isinstance(weight, DenseWeight):
        out = weight.w.to(dtype) @ xc
    else:
        raise TypeError(f"not a weight container: {type(weight).__name__}")
    if weight.b is not None:
        out = out + weight.b.to(dtype)[:, None]
    return out


def _unpack(col0: torch.Tensor, G: int, C: int, w_data: torch.Tensor,
            k: int) -> torch.Tensor:
    """Scatter compact values (..., M, nnz_row) to dense (..., M, K) through
    a ``col0`` table, whose rows ``rg*G + g`` read columns
    ``col0[rg, s] + c`` at slot ``s*C + c`` (RBGP4 and chain tables
    alike)."""
    c = torch.arange(C, dtype=torch.int64, device=col0.device)
    ci = (col0.to(torch.int64)[:, None, :, None] + c).expand(
        -1, G, -1, -1).reshape(w_data.shape[-2:])
    lead = w_data.shape[:-2]
    dense = torch.zeros((*lead, w_data.shape[-2], k), dtype=w_data.dtype,
                        device=w_data.device)
    return dense.scatter_(-1, ci.to(w_data.device).expand(*lead, -1, -1),
                          w_data)


def dense_weight(weight: SparseWeight, dtype=None) -> torch.Tensor:
    """The effective dense (M, K) matrix ((E, M, K) for stacked experts),
    zeros off the mask (tests, export)."""
    if isinstance(weight, QuantizedWeight):
        return dense_weight(weight.dequantize(), dtype)
    if isinstance(weight, DenseWeight):
        w = weight.w
    elif isinstance(weight, CompactWeight):
        d = weight.tables.dims
        w = _unpack(weight.tables.col0, d.group_rows, d.chunk_cols,
                    weight.w_data, d.k)
    elif isinstance(weight, ChainWeight):
        t = weight.tables
        w = _unpack(t.col0, t.group_rows, t.chunk_cols, weight.w_data, t.k)
    else:
        raise TypeError(f"not a weight container: {type(weight).__name__}")
    return w.to(dtype) if dtype is not None else w
