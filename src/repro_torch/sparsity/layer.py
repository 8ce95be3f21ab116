"""SparseLinear: every projection of the port goes through this module.

The port of ``repro/sparsity/layer.py``.  The storage is decided at
construction: ``dense`` when the pattern does not apply to the shape,
``compact`` RBGP4 storage otherwise, with the layout's kernel tables built
once on the layer's device.  The tables of the transposed layout (for dX)
are built once too, the first time a gradient of the layer's input is
asked for: serving never builds them.  Values are kept in the compute dtype (the
reference casts them to the activation dtype on every call; casting once
at load is the same arithmetic).  Training keeps its float32 master
values apart (``repro_torch.train``) and writes the compute-dtype copy
back here after each update.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.kernels import KernelTables, TransposeTables

from .api import CompactWeight, DenseWeight, sparse_linear
from .patterns import PatternInstance, SparsityConfig, make_pattern

__all__ = ["SparseLinear"]


class SparseLinear(nn.Module):
    """y = x @ W_s^T (+ b) with a configurable sparsity pattern."""

    def __init__(self, in_features: int, out_features: int,
                 cfg: Optional[SparsityConfig] = None, *,
                 use_bias: bool = False, dtype=torch.float32,
                 param_dtype=torch.float32, device=None,
                 generator: Optional[torch.Generator] = None,
                 name: str = "linear"):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.use_bias = use_bias
        self.name = name
        self.cfg = cfg or SparsityConfig()
        m, k = out_features, in_features
        self.pattern: Optional[PatternInstance] = None
        self.mode = "dense"
        if self.cfg.applies_to(m, k):
            if self.cfg.backend != "auto":
                raise NotImplementedError(
                    f"sparsity backend {self.cfg.backend!r} is not yet "
                    f"ported; the port serves compact storage ('auto')")
            self.pattern = make_pattern(self.cfg, m, k)
            if self.pattern.layout is not None:
                self.mode = "compact"
            elif self.pattern.name != "dense":
                raise NotImplementedError(
                    f"masked storage of pattern {self.pattern.name!r} is "
                    f"not yet ported")
        # Kaiming init over the fan-in each row actually has (layer.py:139)
        if self.mode == "compact":
            shape = self.layout.data_shape
            fan_in = self.layout.spec.nnz_per_row
        else:
            shape = (m, k)
            fan_in = k
        w = torch.randn(shape, generator=generator, device=device,
                        dtype=torch.float32) * (2.0 / fan_in) ** 0.5
        w = nn.Parameter(w.to(param_dtype).to(dtype), requires_grad=False)
        if self.mode == "compact":
            self.w_data = w
            self.tables = KernelTables.build(self.layout, device)
            self._tables_t: Optional[TransposeTables] = None
        else:
            self.w = w
        self.b = (nn.Parameter(torch.zeros(m, dtype=dtype, device=device),
                               requires_grad=False) if use_bias else None)

    @property
    def layout(self):
        return self.pattern.layout if self.pattern is not None else None

    def transpose_tables(self) -> TransposeTables:
        """The transposed layout's tables on the layer's device (built at
        the first call, then kept)."""
        if self._tables_t is None:
            self._tables_t = TransposeTables.build(self.layout,
                                                   self.w_data.device)
        return self._tables_t

    def weight(self):
        """The storage container handed to ``sparse_linear``."""
        if self.mode == "compact":
            return CompactWeight(w_data=self.w_data, tables=self.tables,
                                 b=self.b, tables_t=self.transpose_tables)
        return DenseWeight(w=self.w, b=self.b)

    def forward(self, x: torch.Tensor, *, fuse: Optional[str] = None,
                residual: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x (..., in_features) -> (..., out_features); ``fuse``/``residual``
        request the epilogue ``y = act(x W^T + b) + residual``."""
        return sparse_linear(self.weight(), x, fuse=fuse, residual=residual)
