"""Weight containers and the one dispatch point of every projection.

The port of ``repro/sparsity/api.py`` for the two storages the serving
path uses:

  ``DenseWeight``    plain (M, K) values: ``x @ w.T`` with ``torch.matmul``
                     (the reference computes it outside Pallas too).
  ``CompactWeight``  compact RBGP4 (M, nnz_row) values + their layout's
                     kernel tables: the ``rbgp4mm_rhs`` kernel on the
                     card, its plain version on the CPU, with bias,
                     activation and residual fused into the kernel's
                     epilogue.

The reference's masked, chain and int8 storages and its backend registry
come with later slices.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch

from repro_torch.kernels import EPILOGUE_ACTS, KernelTables, rbgp4mm_rhs

__all__ = ["DenseWeight", "CompactWeight", "SparseWeight", "sparse_linear"]


@dataclasses.dataclass
class DenseWeight:
    """Plain dense values: ``w`` (M, K), optional bias ``b`` (M,)."""

    w: torch.Tensor
    b: Optional[torch.Tensor] = None


@dataclasses.dataclass
class CompactWeight:
    """Compact RBGP4 storage: ``w_data`` (M, nnz_row) + the kernel tables
    of its layout (built once by the owning ``SparseLinear``)."""

    w_data: torch.Tensor
    tables: KernelTables
    b: Optional[torch.Tensor] = None


SparseWeight = Union[DenseWeight, CompactWeight]


def _check_fuse(fuse: Optional[str]) -> None:
    if fuse is not None and fuse not in EPILOGUE_ACTS:
        raise ValueError(
            f"fuse {fuse!r} not a fusable activation "
            f"{sorted(EPILOGUE_ACTS)}; apply it outside sparse_linear"
        )


def sparse_linear(weight: SparseWeight, x: torch.Tensor, *, dtype=None,
                  fuse: Optional[str] = None,
                  residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """y = act(x @ W_s^T + b) + residual; x (..., K) token-major -> (..., M)."""
    _check_fuse(fuse)
    dtype = dtype or x.dtype
    xc = x.to(dtype)
    b = weight.b.to(dtype) if weight.b is not None else None
    if isinstance(weight, CompactWeight):
        dims = weight.tables.dims
        lead = xc.shape[:-1]
        r2 = None
        if residual is not None:
            r2 = residual.to(dtype).reshape(-1, dims.m).contiguous()
        y = rbgp4mm_rhs(
            weight.tables, xc.reshape(-1, dims.k).contiguous(),
            weight.w_data.to(dtype), bias=b, act=fuse, residual=r2,
        )
        return y.reshape(*lead, dims.m)
    if not isinstance(weight, DenseWeight):
        raise TypeError(f"not a weight container: {type(weight).__name__}")
    y = xc @ weight.w.to(dtype).T
    if b is not None:
        y = y + b
    if fuse is not None:
        y = EPILOGUE_ACTS[fuse](y)
    if residual is not None:
        y = y + residual.to(dtype)
    return y
