"""Symmetric int8 quantization with a max-abs scale.

The port of ``quantize_int8`` / ``dequantize_int8`` of
``repro/train/compress.py``, the Q/DQ pair that the weight-only int8
storage of ``repro_torch.sparsity.quant`` is built on.  The arithmetic is
the reference's, step for step in float32, so the same input gives the
same int8 values and the same scales, bit for bit: scale = max|x| / 127 +
1e-12; q = clip(round(x / scale), -127, 127), rounding half to even
(``torch.round``, as ``jnp.round``).

The error-feedback half of the reference module (gradient compression)
is not yet ported.
"""
from __future__ import annotations

from typing import Optional, Sequence, Union

import torch

__all__ = ["quantize_int8", "dequantize_int8"]

Axis = Union[int, Sequence[int], None]


def _axes(axis: Axis) -> Optional[tuple[int, ...]]:
    if axis is None:
        return None
    return (axis,) if isinstance(axis, int) else tuple(axis)


def _expand(scale: torch.Tensor, axes: tuple[int, ...],
            ndim: int) -> torch.Tensor:
    """``jnp.expand_dims(scale, axes)``: the reduced axes put back with
    length 1, negative axes counted in the ``ndim``-dim result."""
    for a in sorted(a % ndim for a in axes):
        scale = scale.unsqueeze(a)
    return scale


def quantize_int8(x: torch.Tensor, axis: Axis = None,
                  keepdims: bool = False
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """(q int8, scale float32).

    ``axis=None`` reduces over the whole tensor (one scalar scale); with
    ``axis`` the scale is per slice along the kept dimensions (per leaf
    block for quantized weight storage), and ``keepdims=True`` keeps the
    reduced axes so that it broadcasts against ``q``.
    """
    axes = _axes(axis)
    x32 = x.float()
    a = x32.abs()
    m = a.amax() if axes is None else a.amax(dim=axes, keepdim=keepdims)
    scale = m / 127.0 + 1e-12
    s_b = scale if (axes is None or keepdims) else _expand(scale, axes,
                                                           x.ndim)
    q = torch.clamp(torch.round(x32 / s_b), -127, 127).to(torch.int8)
    return q, scale.float()


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor, axis: Axis = None,
                    dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Invert :func:`quantize_int8`: q * scale in float32, then ``dtype``.

    ``axis`` must match the quantize call when its scales were made
    without ``keepdims``."""
    axes = _axes(axis)
    s_b = (scale if axes is None or scale.ndim == q.ndim
           else _expand(scale, axes, q.ndim))
    out = q.float() * s_b
    return out.to(dtype) if dtype is not None else out
