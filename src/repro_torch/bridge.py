"""Weight bridge: the reference's parameters into a port model.

``load_jax_params(model, tree)`` takes the JAX package's ``LMModel.init``
parameters as nested dicts and lists of numpy arrays — every weight
container given as its dict of fields (``{"w_data": ..., "b": ...}`` for
a ``CompactWeight`` or a ``ChainWeight``, ``{"w": ..., "b": ...}`` for a
``DenseWeight``), ``None`` for absent leaves — and loads them into the
port's ``state_dict``, where a compact or chain projection's values are
``<path>.w_data``.  Under a plan the layers are grouped as the reference's
``Stack`` groups them, the plan's per-layer specs included.  The reference stacks the layers of its scanned
periods into ``(T, ...)`` leaves; the bridge splits them per layer with
``jax_stack_split`` (the reference's MoE cadence included).  A MoE
layer's leaves map by name: ``ffn.router`` (E, D), the stacked experts
``ffn.experts.{gate,up,down}.w_data`` (E, M, nnz_row) (or the dense
``ffn.experts.{gate,up,down}`` (E, M, K)) and the shared expert
``ffn.shared.*``.  A quantized reference tree (``quantize_weights``) gives
each ``QuantizedWeight`` as ``{"q_data": ..., "scales": ..., "b": ...}``;
it loads into a port model quantized the same way (``quantize_weights``
first), as ``<path>.q_data`` (int8, kept int8) and ``<path>.scales``
(float32).  Every shape is checked, and a missing, unexpected or
misshapen weight raises, as does int8 for a full-precision tensor or the
other way round.  Values are cast to the dtype each port tensor stores
(the compute dtype for projections, embedding and head; float32 for the
router, the norm scales and the int8 storage's scales).

A ``MaskedWeight`` comes as ``{"w", "ba_o", "ba_i", "mask", "b"}`` (absent
fields ``None``): ``w`` and ``b`` are loaded, and the mask's leaves
(``ba_o``/``ba_i``, or ``mask``) are held equal to the port's own, which
the port derived from the same pattern, and never loaded.

``load_jax_vision_params(model, tree)`` does the same for the vision
models: the reference's ``VGG19.init`` tree ``{"convs", "bns", "fc"}`` and
``WideResNet.init`` tree ``{"stem", "blocks", "bn_f", "fc"}`` map by name
onto the port's modules of the same names.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.transformer import jax_stack_split

__all__ = ["load_jax_params", "load_jax_vision_params",
           "flatten_jax_tree"]

# the leaves of a MaskedWeight's mask: derived by the port, checked, not
# loaded
MASK_LEAVES = ("ba_o", "ba_i", "mask")


def _walk(node, prefix: str, out: dict) -> None:
    if node is None:
        return
    if isinstance(node, dict):
        for k, v in node.items():
            _walk(v, f"{prefix}.{k}" if prefix else str(k), out)
    elif isinstance(node, (list, tuple)):
        for i, v in enumerate(node):
            _walk(v, f"{prefix}.{i}" if prefix else str(i), out)
    else:
        out[prefix] = np.asarray(node)


def flatten_jax_tree(cfg, tree: dict) -> dict[str, np.ndarray]:
    """{port state_dict name: array}, with the reference's stacked scan
    leaves split into per-layer arrays."""
    n_head, period, n_full, tail_start = jax_stack_split(cfg)
    flat: dict[str, np.ndarray] = {}
    rest = {k: v for k, v in tree.items() if k != "stack"}
    _walk(rest, "", flat)
    stack = tree.get("stack", {})
    for i, layer in enumerate(stack.get("head", [])):
        _walk(layer, f"stack.layers.{i}", flat)
    for i, layer in enumerate(stack.get("tail", [])):
        _walk(layer, f"stack.layers.{tail_start + i}", flat)
    for j in range(period if n_full else 0):
        per = {}
        _walk(stack["scan"][f"j{j}"], "", per)
        for name, arr in per.items():
            if arr.shape[:1] != (n_full,):
                raise ValueError(
                    f"scan leaf j{j}.{name} has shape {arr.shape}; expected "
                    f"a leading dim of {n_full} periods")
            for t in range(n_full):
                flat[f"stack.layers.{n_head + t * period + j}.{name}"] = arr[t]
    return flat


def load_jax_params(model, tree: dict) -> None:
    """Load the reference's parameter tree into ``model`` (in place)."""
    _load_flat(model, flatten_jax_tree(model.cfg, tree))


def load_jax_vision_params(model, tree: dict) -> None:
    """Load the reference's ``VGG19``/``WideResNet`` parameter tree into the
    port's model of the same config (in place)."""
    flat: dict[str, np.ndarray] = {}
    _walk(tree, "", flat)
    _load_flat(model, flat)


def _load_flat(model, flat: dict) -> None:
    """Load {state_dict name: array} into ``model``: names and shapes must
    match; a mask leaf must equal the port's own and is not loaded."""
    target = model.state_dict()
    missing = sorted(set(target) - set(flat))
    unexpected = sorted(set(flat) - set(target))
    if missing or unexpected:
        raise ValueError(f"parameter names differ: missing {missing}, "
                         f"unexpected {unexpected}")
    state = {}
    for name, arr in flat.items():
        want = target[name]
        if tuple(arr.shape) != tuple(want.shape):
            raise ValueError(f"{name}: shape {tuple(arr.shape)} != "
                             f"{tuple(want.shape)}")
        if (arr.dtype == np.int8) != (want.dtype == torch.int8):
            raise TypeError(f"{name}: {arr.dtype} values for a {want.dtype} "
                            f"tensor (int8 leaf blocks load only into "
                            f"int8 storage)")
        if name.rpartition(".")[2] in MASK_LEAVES:
            if not np.array_equal(arr, want.cpu().numpy()):
                raise ValueError(f"{name}: the reference's mask differs "
                                 f"from the port's")
            state[name] = want
            continue
        if arr.dtype.kind not in "fiub":  # e.g. bfloat16 from JAX
            arr = arr.astype(np.float32)
        state[name] = torch.tensor(arr).to(device=want.device,
                                           dtype=want.dtype)
    model.load_state_dict(state, strict=True)
