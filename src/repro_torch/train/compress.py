"""Symmetric int8 quantization with a max-abs scale, and gradient
compression with error feedback.

The port of ``repro/train/compress.py``.  ``quantize_int8`` /
``dequantize_int8`` are the Q/DQ pair that the weight-only int8 storage of
``repro_torch.sparsity.quant`` is built on.  The arithmetic is the
reference's, step for step in float32, so the same input gives the same
int8 values and the same scales, bit for bit: scale = max|x| / 127 +
1e-12; q = clip(round(x / scale), -127, 127), rounding half to even
(``torch.round``, as ``jnp.round``).

``init_error_feedback`` / ``compress_decompress`` are the gradient
transform ``TrainConfig.grad_compression == "int8"`` applies: each
gradient, plus the residual carried from the step before, goes through
the per-tensor Q/DQ round trip, and the new residual is what the round
trip lost (e_{t+1} = g_t + e_t - Q(g_t + e_t)).  ``group`` is the
reference's ``axis_name``: the int8 payload is summed as int32 over the
group's ranks (exact in any order), the scales averaged over them (added
in rank order) and the sum divided by the group's size.
"""
from __future__ import annotations

from typing import Optional, Sequence, Union

import torch

__all__ = ["quantize_int8", "dequantize_int8", "init_error_feedback",
           "compress_decompress"]

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


def _tmap(f, *trees):
    """``f`` over the tensors of nested dicts of tensors (None kept)."""
    head = trees[0]
    if head is None:
        return None
    if isinstance(head, dict):
        return {k: _tmap(f, *(t[k] if t is not None else None
                              for t in trees)) for k in head}
    return f(*trees)


def init_error_feedback(grads_like):
    """Zero float32 residuals shaped like every tensor of ``grads_like`` (a
    tensor, or nested dicts of them)."""
    return _tmap(lambda g: torch.zeros_like(g, dtype=torch.float32),
                 grads_like)


def _axis(group):
    """A ``parallel.MeshAxis`` of ``group`` (a process group, or a
    MeshAxis already)."""
    from repro_torch.parallel import MeshAxis

    if isinstance(group, MeshAxis):
        return group
    import torch.distributed as dist

    return MeshAxis(group, dist.get_rank(group), dist.get_world_size(group))


def compress_decompress(grads, error=None, group=None):
    """Quantize (with error feedback) -> [sum over ``group``] ->
    dequantize, tensor by tensor.

    ``grads`` is a tensor or nested dicts of them, ``error`` the residuals
    of the step before (None: no feedback).  Returns (new_grads, new_error):
    each gradient dequantized in its own dtype, and the float32 residual
    g32 + e - Q(g32 + e), the reference's arithmetic bit for bit.  With
    ``group`` (a process group or a ``parallel.MeshAxis``, the counterpart
    of the reference's ``axis_name``) each rank's int8 payload is summed
    over the group as int32, the scales are averaged, and the result is
    divided by the group's size: the mean of the ranks' round trips."""
    axis = _axis(group) if group is not None else None

    def one(g, e):
        g32 = g.float()
        if e is not None:
            g32 = g32 + e
        q, scale = quantize_int8(g32)
        local = dequantize_int8(q, scale)
        if axis is None:
            return local.to(g.dtype), g32 - local
        from repro_torch.parallel.comm import all_reduce_sum, gather_sum

        q_sum = all_reduce_sum(q.to(torch.int32), axis)
        mean_scale = gather_sum(scale.reshape(1), axis)[0] / axis.size
        deq = q_sum.float() * mean_scale / axis.size
        return deq.to(g.dtype), g32 - local

    pairs = _tmap(one, grads, error) if error is not None else \
        _tmap(lambda g: one(g, None), grads)

    def unzip(i, node):
        if node is None:
            return None
        if isinstance(node, dict):
            return {k: unzip(i, v) for k, v in node.items()}
        return node[i]

    return unzip(0, pairs), unzip(1, pairs)
