"""SparseLinear: every projection of the port goes through this module.

The port of ``repro/sparsity/layer.py``.  ``cfg`` is a ``SparsityConfig``
(applied by value) or a ``SparsityPlan``, in which case the layer resolves
its pattern by module path: ``name`` is matched against the plan's
ordered rules.  The storage is decided at construction
(``api.storage_kind``, from the capabilities of the backend the config
names): ``dense`` when the pattern does not apply to the shape,
``compact`` RBGP4 storage, ``chain`` storage for a product chain
of more than two Ramanujan factors, or ``masked`` storage: dense values
``w`` under a fixed mask, held as the integer buffers ``ba_o``/``ba_i``
(an RBGP4 layout's base-graph factors, expanded at each call) or ``mask``
(unstructured, block and deep chains), which no optimizer takes.
``backend_name`` is the registered backend every product of the layer
runs on (``sparse_linear(..., backend=)``): the config's, or 'auto' for
dense storage and in the recording pass, as in the reference.  Masked
values are drawn Kaiming over the fan-in each row keeps, as the
reference's; weight decay still moves their off-mask entries, as it does
there.  The layout's kernel tables are built once on the layer's device
and shared by every layer of one layout (``get_op``'s ``RBGP4Op`` for
compact storage, ``chain_tables`` for chains).  The tables of the
transposed layout (for dX) are built the first time a gradient of the
layer's input is asked for, shared alike: serving never builds them.
Values are kept in the compute dtype (the reference casts them to the activation dtype on every call; casting once at load is the
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

Under ``plan.recording_shapes()`` the constructor records its
``(name, m, k)`` and returns before any pattern, storage or device is
made (``model_matmul_shapes``).
"""
from __future__ import annotations

from typing import Optional, Union

import torch
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.parallel.tensor import on_use
from repro_torch.kernels import (ChainTransposeTables, TransposeTables,
                                 chain_tables, chain_transpose_tables,
                                 get_op)

from .api import (ChainWeight, CompactWeight, DenseWeight, MaskedWeight,
                  QuantizedWeight, sparse_linear, storage_kind)
from .patterns import PatternInstance, SparsityConfig, make_pattern
from .plan import SparsityPlan, record_shape, recording_active
from .quant import (dequantize_block_values, leaf_block_dims,
                    quantize_block_values)

__all__ = ["SparseLinear"]


class SparseLinear(nn.Module):
    """y = x @ W_s^T (+ b) with a configurable sparsity pattern.

    ``device`` defaults to the card; without CUDA that raises, naming
    ``device="cpu"``.  ``tp`` is the layer's ``parallel.LinearShard``
    once ``parallel.shard_module`` cut it to a rank's share (None
    otherwise), ``share`` the ``RankSlice`` of a compact or chain layer
    it cut (whose dX runs on ``share.transpose`` of the full layout's
    transposed tables), ``mask_window`` the part of a masked layer's
    mask its share stands under, and ``fsdp`` the ``parallel.DataShard``
    of values held as a data rank's share."""

    tp = None
    share = None
    mask_window = None
    fsdp = None

    def __init__(self, in_features: int, out_features: int,
                 cfg: Optional[Union[SparsityConfig, SparsityPlan]] = None,
                 *, use_bias: bool = False, dtype=torch.float32,
                 param_dtype=torch.float32, device=None,
                 generator: Optional[torch.Generator] = None,
                 name: str = "linear"):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.use_bias = use_bias
        self.name = name
        m, k = out_features, in_features
        record_shape(name, m, k)
        if recording_active():
            # shape-recording pass: no pattern, storage or device
            self.cfg = SparsityConfig()
            self.pattern = None
            self.mode = "dense"
            self.backend_name = "auto"
            return
        device = resolve_device(device)
        if isinstance(cfg, SparsityPlan):
            cfg = cfg.resolve(name, m, k).to_config()
        self.cfg = cfg or SparsityConfig()
        self.pattern: Optional[PatternInstance] = None
        self.mode = "dense"
        if self.cfg.applies_to(m, k):
            self.pattern = make_pattern(self.cfg, m, k)
            # checks the backend name against the registry and takes the
            # storage from its declared capabilities
            self.mode = storage_kind(
                self.cfg.backend, has_layout=self.pattern.layout is not None,
                chain=self.pattern.chain_layout is not None)
        # the backend every product of the layer runs on ('auto' picks by
        # the container's type: dense storage runs on 'ref')
        self.backend_name = ("auto" if self.mode == "dense"
                             else self.cfg.backend)
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
            self.tables = (get_op(self.layout, device).tables
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
                get_op(self.layout, device).transpose_tables()
                if self.mode == "compact"
                else chain_transpose_tables(self.chain_layout, device))
            if self.share is not None:
                self._tables_t = self.share.transpose(self._tables_t)
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
        """The storage container handed to ``sparse_linear``; values that
        ``shard_module`` cut over the data axes are gathered whole
        (``parallel.on_use``)."""
        if self.quantized:
            return QuantizedWeight(q_data=self.q_data, scales=self.scales,
                                   tables=self.tables, b=self.b,
                                   kind=self.mode,
                                   orig_dtype=self.orig_dtype)
        if self.mode == "compact":
            return CompactWeight(w_data=on_use(self, "w_data"),
                                 tables=self.tables, b=self.b,
                                 tables_t=self.transpose_tables)
        if self.mode == "chain":
            return ChainWeight(w_data=on_use(self, "w_data"),
                               tables=self.tables, b=self.b,
                               tables_t=self.transpose_tables)
        w = on_use(self, "w")
        if self.mode == "masked":
            if self.layout is not None:
                return MaskedWeight(w=w, ba_o=self.ba_o, ba_i=self.ba_i,
                                    b=self.b, group_rows=self.group_rows,
                                    chunk_cols=self.chunk_cols,
                                    window=self.mask_window)
            return MaskedWeight(w=w, mask=self.mask, b=self.b,
                                window=self.mask_window)
        return DenseWeight(w=w, b=self.b)

    def forward(self, x: torch.Tensor, *, fuse: Optional[str] = None,
                residual: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x (..., in_features) -> (..., out_features); ``fuse``/``residual``
        request ``y = act(x W^T + b) + residual`` (in the kernel's epilogue
        on a backend that declares one, in torch after it otherwise), on
        the backend ``backend_name``.  A sharded layer
        runs ``parallel.tensor.linear_forward``: its input and output are
        its rank's share of the activation."""
        if self.tp is not None:
            from repro_torch.parallel.tensor import linear_forward

            return linear_forward(self, x, fuse=fuse, residual=residual)
        return sparse_linear(self.weight(), x, backend=self.backend_name,
                             fuse=fuse, residual=residual)
