"""Weight-only int8 storage: int8 leaf blocks + one float32 scale each.

The port of ``repro/sparsity/quant.py``.  Both succinct containers store
their values as dense ``(G, C)`` leaf blocks — ``CompactWeight`` ``w_data``
(M, d_o*d_i*C), each row group of G rows holding d_o*d_i blocks of C
contiguous columns; ``ChainWeight`` ``w_data`` (M, n_chunks*C) with the
chain's leaf (G, C) — so one symmetric int8 scheme covers both: each
leaf block is quantized against its own max-abs scale
(``train/compress.py``'s quantizer over the block's axes) into

  * ``q_data``  int8, the shape of the wrapped ``w_data``;
  * ``scales``  float32 (..., M/G, S), S = stored columns / C, one per
                leaf block: ``scales[rg, s]`` scales
                ``w_data[rg*G:(rg+1)*G, s*C:(s+1)*C]``, the (row group,
                slot) order the int8 kernels read;
  * ``b``       the bias, untouched.

The arithmetic is the reference's, so the same values give the same
``q_data`` and ``scales`` bit for bit.  ``QuantizedWeight`` (defined in
``api.py`` beside the other containers) executes through the int8 paths of
the kernels on the card and dequantizes and delegates on the CPU.

In the port a model holds its weights, so ``quantize_weights`` and
``dequantize_weights`` convert an ``nn.Module`` in place, where the
reference maps a params pytree: every compact or chain ``SparseLinear``
and every compact ``StackedExperts`` (``quantize_()``), dense layers left
alone.  The state_dict names follow the reference's ``QuantizedWeight``
fields: ``<path>.q_data`` and ``<path>.scales`` in place of
``<path>.w_data``.  Weight-only PTQ: nothing quantized is trainable.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import ChainLayout, RBGP4Layout
from repro_torch.kernels import ChainTables, KernelTables
from repro_torch.kernels.chainmm import _leaf
from repro_torch.kernels.ref import dequant_leaf_blocks

from .api import ChainWeight, CompactWeight, QuantizedWeight

__all__ = [
    "QuantizedWeight",
    "leaf_block_dims",
    "quantize_block_values",
    "dequantize_block_values",
    "quantize_weight",
    "quantize_weights",
    "dequantize_weights",
    "quant_storage_bytes",
    "weight_bytes",
]


def _quantize_int8():
    # repro_torch.train imports repro_torch.configs, which imports this
    # package: importing at module scope would cycle
    from repro_torch.train.compress import quantize_int8

    return quantize_int8


def leaf_block_dims(layout) -> tuple[int, int]:
    """(G, C) dense leaf-block shape of a succinct layout (or of its
    kernel tables): RBGP4 (group_rows, chunk_cols); a chain the sides of
    its trailing complete factors, the blocked-CSR leaf."""
    if isinstance(layout, RBGP4Layout):
        return layout.spec.group_rows, layout.spec.chunk_cols
    if isinstance(layout, ChainLayout):
        return _leaf(layout)
    if isinstance(layout, KernelTables):
        return layout.dims.group_rows, layout.dims.chunk_cols
    if isinstance(layout, ChainTables):
        return layout.group_rows, layout.chunk_cols
    raise TypeError(f"no leaf blocks on {type(layout).__name__}")


def quantize_block_values(w_data: torch.Tensor, G: int, C: int
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """``w_data`` (..., M, S*C) -> (``q_data`` int8 of the same shape,
    ``scales`` float32 (..., M/G, S)): each (G, C) leaf block gets its own
    max-abs scale; leading dims (stacked experts) quantize apart."""
    quantize_int8 = _quantize_int8()
    *lead, m, nc = w_data.shape
    if m % G or nc % C:
        raise ValueError(f"values {tuple(w_data.shape)} not tiled by leaf "
                         f"blocks ({G}, {C})")
    wr = w_data.reshape(*lead, m // G, G, nc // C, C)
    q, scales = quantize_int8(wr, axis=(-3, -1))
    return q.reshape(w_data.shape), scales


def dequantize_block_values(q_data: torch.Tensor, scales: torch.Tensor,
                            G: int, C: int, dtype=None) -> torch.Tensor:
    """Invert :func:`quantize_block_values`: the float32 values the int8
    kernels compute with (``q * scale``), then ``dtype`` (defaults to
    float32)."""
    out = dequant_leaf_blocks(q_data, scales, G, C)
    return out.to(dtype) if dtype is not None else out


def quantize_weight(weight) -> QuantizedWeight:
    """PTQ of one compact or chain container (idempotent on a
    ``QuantizedWeight``)."""
    if isinstance(weight, QuantizedWeight):
        return weight
    if isinstance(weight, ChainWeight):
        kind = "chain"
    elif isinstance(weight, CompactWeight):
        kind = "compact"
    else:
        raise TypeError(
            f"only compact/chain storage quantizes (leaf-block structure); "
            f"got {type(weight).__name__}")
    G, C = leaf_block_dims(weight.tables)
    q_data, scales = quantize_block_values(weight.w_data.detach(), G, C)
    return QuantizedWeight(q_data=q_data, scales=scales, tables=weight.tables,
                           b=weight.b, kind=kind,
                           orig_dtype=weight.w_data.dtype)


def _quantizable(model: torch.nn.Module):
    """(module, its name in ``model``, its plan path) of every compact or
    chain ``SparseLinear`` and every compact ``StackedExperts``."""
    from repro_torch.models.moe import StackedExperts

    from .layer import SparseLinear

    for name, mod in model.named_modules():
        if isinstance(mod, SparseLinear) and mod.mode in ("compact",
                                                          "chain"):
            yield mod, name, mod.name
        elif isinstance(mod, StackedExperts) and mod.compact:
            yield mod, name, f"{mod.name}.experts.in"


def quantize_weights(model: torch.nn.Module, plan=None, *,
                     values: Optional[dict] = None) -> torch.nn.Module:
    """Weight-only PTQ of ``model``, in place; returns it.

    Every compact or chain projection stores int8 leaf blocks; dense
    layers, norms, embedding and head are left alone.  With a ``plan``,
    only projections whose plan path (the module path the layer resolved
    its rule by) resolves to a rule with ``quant='int8'`` convert.
    ``values`` maps state_dict names (``<name>.w_data``) to full-precision
    values to quantize in place of the modules' own (a trainer's float32
    masters)."""
    from .layer import SparseLinear

    values = values or {}
    for mod, name, path in list(_quantizable(model)):
        if plan is not None and plan.resolve(path).quant != "int8":
            continue
        if isinstance(mod, SparseLinear):
            mod.quantize_(values.get(f"{name}.w_data"))
        else:
            mod.quantize_({p: values[f"{name}.{p}.w_data"]
                           for p in ("gate", "up", "down")
                           if f"{name}.{p}.w_data" in values})
    return model


def dequantize_weights(model: torch.nn.Module) -> torch.nn.Module:
    """Invert :func:`quantize_weights`, in place (values back in their
    dtype before quantization); returns ``model``."""
    for mod, _, _ in list(_quantizable(model)):
        mod.dequantize_()
    return model


def weight_bytes(model: torch.nn.Module) -> dict:
    """Bytes the model stores: ``values`` of its compact, chain and stacked
    projections (full-precision ``w_data`` or int8 ``q_data``), their
    ``scales``, and ``other`` (dense layers, norms, embedding, head)."""
    out = {"values": 0, "scales": 0, "other": 0}
    for name, t in model.state_dict().items():
        leaf = name.rsplit(".", 1)[-1]
        key = {"w_data": "values", "q_data": "values",
               "scales": "scales"}.get(leaf, "other")
        out[key] += t.numel() * t.element_size()
    return out


def quant_storage_bytes(layout, *, scale_bytes: int = 4,
                        index_bytes: int = 4,
                        f32_value_bytes: int = 4) -> dict:
    """Bytes of one quantized layer against its f32 succinct form: values
    nnz int8; scales one f32 per (G, C) leaf block; index unchanged.
    ``ratio_values`` is (int8 values + scales) / f32 values."""
    G, C = leaf_block_dims(layout)
    cols = layout.data_shape[1]  # stored columns per row (both layouts)
    nnz = layout.m * cols
    n_scales = (layout.m // G) * (cols // C)
    mem = layout.memory_bytes(value_bytes=1, index_bytes=index_bytes)
    index = mem.get("index_succinct", mem.get("index", 0))
    values = nnz
    scales = n_scales * scale_bytes
    f32_values = nnz * f32_value_bytes
    return {
        "values": values,
        "scales": scales,
        "index": index,
        "total": values + scales + index,
        "f32_values": f32_values,
        "f32_total": f32_values + index,
        "ratio_values": (values + scales) / f32_values,
    }
