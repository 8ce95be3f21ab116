"""SparseLinear: every projection of the port goes through this module.

The port of ``repro/sparsity/layer.py``.  ``cfg`` is a ``SparsityConfig``
(applied by value) or a ``SparsityPlan``, in which case the layer resolves
its pattern by module path: ``name`` is matched against the plan's
ordered rules.  The storage is decided at construction
(``storage_kind``): ``dense`` when the pattern does not apply to the
shape, ``compact`` RBGP4 storage, ``chain`` storage for a product chain
of more than two Ramanujan factors, or ``masked`` storage: dense values
``w`` under a fixed mask, held as the integer buffers ``ba_o``/``ba_i``
(an RBGP4 layout's base-graph factors, expanded at each call) or ``mask``
(unstructured, block and deep chains), which no optimizer takes.  Masked
values are drawn Kaiming over the fan-in each row keeps, as the
reference's; weight decay still moves their off-mask entries, as it does
there.  The layout's kernel tables are built once on the
layer's device (chain tables are shared by every layer of one layout).
The tables of the transposed layout (for dX) are built once too, the
first time a gradient of the layer's input is asked for: serving never
builds them.  Values are kept in the compute dtype (the reference casts
them to the activation dtype on every call; casting once at load is the
same arithmetic).  Training keeps its float32 master values apart
(``repro_torch.train``) and writes the compute-dtype copy back here after
each update.

``quantize_()`` turns compact or chain storage into the reference's
weight-only int8 storage in place (``sparsity/quant.py``): ``w_data`` gives
way to ``q_data`` (int8, a parameter that no optimizer takes) and the
``scales`` buffer (float32, one per leaf block), so the state_dict names
are the reference's ``QuantizedWeight`` fields; ``weight()`` then hands
over a ``QuantizedWeight`` and the kernel tables stay as they are.
``dequantize_()`` inverts it.
"""
from __future__ import annotations

from typing import Optional, Union

import torch
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.kernels import (ChainTransposeTables, KernelTables,
                                 TransposeTables, chain_tables,
                                 chain_transpose_tables)

from .api import (ChainWeight, CompactWeight, DenseWeight, MaskedWeight,
                  QuantizedWeight, sparse_linear)
from .patterns import PatternInstance, SparsityConfig, make_pattern
from .plan import SparsityPlan, storage_kind
from .quant import (dequantize_block_values, leaf_block_dims,
                    quantize_block_values)

__all__ = ["SparseLinear"]


class SparseLinear(nn.Module):
    """y = x @ W_s^T (+ b) with a configurable sparsity pattern.

    ``device`` defaults to the card; without CUDA that raises, naming
    ``device="cpu"``."""

    def __init__(self, in_features: int, out_features: int,
                 cfg: Optional[Union[SparsityConfig, SparsityPlan]] = None,
                 *, use_bias: bool = False, dtype=torch.float32,
                 param_dtype=torch.float32, device=None,
                 generator: Optional[torch.Generator] = None,
                 name: str = "linear"):
        super().__init__()
        device = resolve_device(device)
        self.in_features = in_features
        self.out_features = out_features
        self.use_bias = use_bias
        self.name = name
        m, k = out_features, in_features
        if isinstance(cfg, SparsityPlan):
            cfg = cfg.resolve(name, m, k).to_config()
        self.cfg = cfg or SparsityConfig()
        self.pattern: Optional[PatternInstance] = None
        self.mode = "dense"
        if self.cfg.applies_to(m, k):
            self.pattern = make_pattern(self.cfg, m, k)
            self.mode = storage_kind(
                self.cfg.backend, has_layout=self.pattern.layout is not None,
                chain=self.pattern.chain_layout is not None)
        # Kaiming init over the fan-in each row actually has (layer.py:139)
        if self.mode == "dense":
            shape, fan_in = (m, k), k
        elif self.mode == "masked":
            shape = (m, k)
            fan_in = max(round((1 - self.pattern.sparsity) * k), 1)
        else:
            lay = self.layout if self.mode == "compact" else self.chain_layout
            shape, fan_in = lay.data_shape, lay.spec.nnz_per_row
        w = torch.randn(shape, generator=generator, device=device,
                        dtype=torch.float32) * (2.0 / fan_in) ** 0.5
        w = nn.Parameter(w.to(param_dtype).to(dtype), requires_grad=False)
        if self.mode in ("dense", "masked"):
            self.w = w
            if self.mode == "masked":
                self._init_mask(device)
        else:
            self.w_data = w
            self.tables = (KernelTables.build(self.layout, device)
                           if self.mode == "compact"
                           else chain_tables(self.chain_layout, device))
            self._tables_t = None
        self.b = (nn.Parameter(torch.zeros(m, dtype=dtype, device=device),
                               requires_grad=False) if use_bias else None)

    def _init_mask(self, device) -> None:
        lay = self.layout
        if lay is not None:
            ba = lambda g: torch.as_tensor(g.biadjacency, device=device)
            self.register_buffer("ba_o", ba(lay.graph_o))
            self.register_buffer("ba_i", ba(lay.graph_i))
            self.group_rows = lay.spec.group_rows
            self.chunk_cols = lay.spec.chunk_cols
        else:
            self.register_buffer("mask", torch.as_tensor(
                self.pattern.mask(), device=device))

    def n_params(self) -> int:
        """Stored values (masked storage stores all M x K), bias included."""
        if self.mode in ("dense", "masked"):
            n = self.in_features * self.out_features
        else:
            n = self.pattern.nnz
        return n + (self.out_features if self.use_bias else 0)

    def n_effective_params(self) -> int:
        """Values that are trained and used (masked storage counts only its
        on-mask entries), bias included."""
        n = (self.pattern.nnz if self.pattern is not None
             else self.in_features * self.out_features)
        return n + (self.out_features if self.use_bias else 0)

    @property
    def layout(self):
        """The RBGP4 layout of compact storage, else None."""
        return self.pattern.layout if self.pattern is not None else None

    @property
    def chain_layout(self):
        """The ``ChainLayout`` of chain storage, else None."""
        return self.pattern.chain_layout if self.pattern is not None else None

    def transpose_tables(self) -> Union[TransposeTables,
                                        ChainTransposeTables]:
        """The transposed layout's tables on the layer's device (built at
        the first call, then kept)."""
        if self._tables_t is None:
            device = self.tables.col0.device
            self._tables_t = (
                TransposeTables.build(self.layout, device)
                if self.mode == "compact"
                else chain_transpose_tables(self.chain_layout, device))
        return self._tables_t

    @property
    def quantized(self) -> bool:
        """Whether the values are stored as int8 leaf blocks."""
        return "q_data" in self._parameters

    def quantize_(self, w_data: Optional[torch.Tensor] = None) -> None:
        """Weight-only PTQ in place: ``w_data`` becomes int8 ``q_data`` and
        float32 ``scales``, one per (G, C) leaf block.  ``w_data`` given
        (a float32 master copy) is quantized in place of the layer's own
        values.  No-op when already quantized."""
        if self.mode not in ("compact", "chain"):
            raise TypeError(f"only compact/chain storage quantizes; "
                            f"{self.name!r} is {self.mode}")
        if self.quantized:
            return
        own = self.w_data
        src = own.detach() if w_data is None else w_data.to(own.device)
        q, scales = quantize_block_values(src, *leaf_block_dims(self.tables))
        self.orig_dtype = own.dtype
        del self.w_data
        self.q_data = nn.Parameter(q, requires_grad=False)
        self.register_buffer("scales", scales)

    def dequantize_(self) -> None:
        """Invert ``quantize_``: ``w_data`` in the values' dtype before
        quantization.  No-op when not quantized."""
        if not self.quantized:
            return
        w = dequantize_block_values(self.q_data, self.scales,
                                    *leaf_block_dims(self.tables),
                                    dtype=self.orig_dtype)
        del self.q_data
        del self.scales
        self.w_data = nn.Parameter(w, requires_grad=False)

    def weight(self):
        """The storage container handed to ``sparse_linear``."""
        if self.quantized:
            return QuantizedWeight(q_data=self.q_data, scales=self.scales,
                                   tables=self.tables, b=self.b,
                                   kind=self.mode,
                                   orig_dtype=self.orig_dtype)
        if self.mode == "compact":
            return CompactWeight(w_data=self.w_data, tables=self.tables,
                                 b=self.b, tables_t=self.transpose_tables)
        if self.mode == "chain":
            return ChainWeight(w_data=self.w_data, tables=self.tables,
                               b=self.b, tables_t=self.transpose_tables)
        if self.mode == "masked":
            if self.layout is not None:
                return MaskedWeight(w=self.w, ba_o=self.ba_o, ba_i=self.ba_i,
                                    b=self.b, group_rows=self.group_rows,
                                    chunk_cols=self.chunk_cols)
            return MaskedWeight(w=self.w, mask=self.mask, b=self.b)
        return DenseWeight(w=self.w, b=self.b)

    def forward(self, x: torch.Tensor, *, fuse: Optional[str] = None,
                residual: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x (..., in_features) -> (..., out_features); ``fuse``/``residual``
        request ``y = act(x W^T + b) + residual`` (in the kernel's epilogue
        for compact storage, in torch after it otherwise)."""
        return sparse_linear(self.weight(), x, fuse=fuse, residual=residual)
