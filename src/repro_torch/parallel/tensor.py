"""What a sharded module keeps and how its forward crosses ranks.

``shard_module`` (``parallel/sharding.py``) cuts a model's tensors to each
rank's share and sets one descriptor on each module it cut; the modules'
forwards read them.  Tensor parallelism is explicit, Megatron-style, on
plain local tensors (the kernels take raw pointers, so no DTensor):

  * ``LinearShard`` on a ``SparseLinear``.  Column-parallel ("col", the
    output rows over "model": wq, wk, wv, gate, up): a rank's product gives
    its rows' outputs.  Row-parallel ("row", the input over "model": wo,
    down): the activation arrives as this rank's columns; dense and masked
    storage keep those columns of W, and their product is a partial Y;
    compact and int8 storage keep a range of compact slots, whose product
    needs the whole X (``gather_cat`` first) and gives a partial Y over
    the slots.  The partials are summed in rank order (``gather_sum``);
    the bias, the activation and the residual follow the sum, once.
  * ``HeadShard`` on a ``GQAttention``: this rank's q heads, and the kv
    heads its cache holds (its own where the "model" axis divides the kv
    heads, else all of them, gathered from the k/v projections' rows).
    Where the axis does not divide the q heads (gemma3-4b's 8 and
    musicgen-medium's 24 over 16), every rank runs all of them: wq's rows
    are gathered (``q_gather``, where the axis divides the rows), and wo
    takes this rank's columns of the whole output.
  * ``LatentShard`` on an ``MLAttention``: this rank's heads (wq_b's rows,
    wk_b, wv_b, wo's columns); the latent is whole on every rank, wq_a's
    and wkv_a's outputs gathered (``whole_output``).
  * ``RecurrentShard`` on a ``MambaMixer`` or an ``RWKVBlock``: this
    rank's channels [lo, hi) of the recurrence (Mamba's d_inner; RWKV's
    d_model, whole heads), which its conv, scan, state and gate run on.
    The projections keep the spec's cuts, which are not these channels
    where they read or write the whole vector (Mamba's ``in`` rows of
    [x; z], its ``x`` rows of dt | B | C, RWKV's column-parallel ``o``):
    their outputs are gathered whole (``whole_output``) and this rank's
    channels read from them, their inputs gathered whole (``gather_cat``).
    The per-channel tensors the spec replicates (Mamba's conv, dt, A and
    D; RWKV's decay base and LoRA output, bonus and group norm) are held
    whole and read at this rank's channels through ``to_ranks``
    (``RecurrentShard.read``).
  * ``ExpertShard`` on a ``MoELayer``: this rank's experts [lo, hi).
  * ``VocabShard`` on an ``Embedding`` and on the LM head: this rank's
    vocabulary rows [lo, hi); lookups outside them give zeros, summed over
    the ranks, and the head's logits are gathered.
  * ``DataShard`` on each module that holds a data rank's share of a
    weight (FSDP over the data axes, the spec's ``("pod", "data")``
    entries): the dim each such attribute was cut along.  Every read goes
    through ``on_use``, which gathers the weight whole over the data axes
    just before the kernel or op takes it (``gather_on_use``), so the
    model-axis code above sees the share it saw before; under
    ``cfg.remat`` the gather is recomputed in the backward, and only one
    layer's whole weights are alive at a time.

Gradients (``comm.py``): a whole, replicated activation that enters a
rank's share of the work goes through ``to_ranks`` first (the input of a
column-parallel product, the slice of a whole product a rank keeps, the
gathered X of a compact row-parallel product), so its gradient is the
sum of the ranks' partials; everything after a ``gather_sum`` or a
``gather_cat`` is replicated compute, whose gradients are the same on
every rank.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .comm import MeshAxis, gather_cat, gather_on_use, gather_sum, to_ranks

__all__ = ["LinearShard", "HeadShard", "LatentShard", "RecurrentShard",
           "ExpertShard", "VocabShard", "DataShard", "on_use",
           "linear_forward", "whole_output"]


@dataclasses.dataclass(frozen=True, eq=False)
class LinearShard:
    """``role`` 'col' or 'row'; ``lo``/``hi`` the output rows ('col') or
    input columns ('row') of ``full`` this rank's activation holds;
    ``sliced`` whether the weight was cut to them (else the spec keeps it
    whole on every rank); ``whole_input`` for a row-parallel weight kept
    as compact slots, whose product reads the whole X."""

    role: str
    axis: MeshAxis
    lo: int
    hi: int
    full: int
    sliced: bool
    whole_input: bool = False


@dataclasses.dataclass(frozen=True, eq=False)
class HeadShard:
    axis: MeshAxis
    q: tuple[int, int]          # q heads [lo, hi)
    cache: tuple[int, int]      # kv heads the cache holds [lo, hi)
    kv_gather: bool             # k/v projections' rows gathered to whole
    q_gather: bool = False      # wq's rows gathered to whole


@dataclasses.dataclass(frozen=True, eq=False)
class LatentShard:
    axis: MeshAxis
    heads: tuple[int, int]      # heads [lo, hi)


@dataclasses.dataclass(frozen=True, eq=False)
class RecurrentShard:
    axis: MeshAxis
    lo: int                     # channels [lo, hi) of the recurrence
    hi: int

    def read(self, t: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """A whole, replicated per-channel tensor at this rank's channels
        along ``dim``: its gradient is summed over the model ranks, so
        every rank holds the whole tensor's."""
        return to_ranks(t, self.axis).narrow(dim, self.lo, self.hi - self.lo)


@dataclasses.dataclass(frozen=True, eq=False)
class ExpertShard:
    axis: MeshAxis
    lo: int
    hi: int


@dataclasses.dataclass(frozen=True, eq=False)
class VocabShard:
    axis: MeshAxis
    lo: int
    hi: int


@dataclasses.dataclass(frozen=True, eq=False)
class DataShard:
    axis: MeshAxis              # the data axes, flattened pod-major
    dims: dict                  # attribute -> the dim its share is cut on


def on_use(owner, attr: str) -> torch.Tensor:
    """``owner.<attr>`` whole over the data axes: gathered where the
    module's ``DataShard`` names it, else as it is held."""
    t = getattr(owner, attr)
    ds: Optional[DataShard] = getattr(owner, "fsdp", None)
    if ds is None or attr not in ds.dims:
        return t
    return gather_on_use(t, ds.axis, ds.dims[attr])


def linear_forward(layer, x: torch.Tensor, *, fuse: Optional[str] = None,
                   residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """A ``SparseLinear``'s forward under its ``LinearShard``, on the
    layer's backend (``backend_name``): a compact share under
    ``xla_compact`` gathers through its cut ``col0``."""
    from repro_torch.sparsity.api import EPILOGUE_ACTS, sparse_linear

    tp: LinearShard = layer.tp
    w = layer.weight()
    be = layer.backend_name
    if tp.role == "col":
        part = (tp.lo, tp.hi) != (0, tp.full)
        if tp.sliced:
            x = to_ranks(x, tp.axis)
        y = sparse_linear(w, x, backend=be, fuse=fuse)
        if not tp.sliced and part:
            y = to_ranks(y, tp.axis)[..., tp.lo:tp.hi]
        if residual is not None:
            if part:
                residual = to_ranks(residual, tp.axis)[..., tp.lo:tp.hi]
            y = y + residual.to(y.dtype)
        return y
    # the activation arrives as this rank's columns where the axis divides
    # them (a group of one included), else whole
    split_input = tp.full % tp.axis.size == 0
    if not tp.sliced:
        if split_input:
            x = gather_cat(x, tp.axis)
        return sparse_linear(w, x, backend=be, fuse=fuse, residual=residual)
    if tp.whole_input and split_input:
        x = to_ranks(gather_cat(x, tp.axis), tp.axis)
    y = gather_sum(sparse_linear(dataclasses.replace(w, b=None), x,
                                 backend=be), tp.axis)
    if w.b is not None:
        y = y + w.b.to(y.dtype)
    if fuse is not None:
        y = EPILOGUE_ACTS[fuse](y)
    if residual is not None:
        y = y + residual.to(y.dtype)
    return y


def whole_output(layer, y: torch.Tensor) -> torch.Tensor:
    """A column-parallel ``SparseLinear``'s output ``y`` whole on every
    rank: its rows gathered in rank order where the axis splits them (a
    group of one included); an unsharded layer's as it is."""
    tp: Optional[LinearShard] = layer.tp
    if tp is None or tp.full % tp.axis.size:
        return y
    return gather_cat(y, tp.axis)
