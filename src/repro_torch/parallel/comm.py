"""The collectives of the port's distribution, each counted by kind.

Tensor parallelism here is explicit (Megatron-style) on plain local
tensors, so every cross-rank step is one of the calls below, on the
process group of one mesh axis (``MeshAxis``).  ``COLLECTIVES`` counts
them by kind; a call moves its count whatever the group's size, and no
caller skips a call for a group of one, so a world-size-1 run issues
every collective a larger run issues.

Summation order.  A sum over ranks is taken in rank order after an
``all_gather`` (``gather_sum``), never by ``all_reduce``: a ring
all-reduce splits its buffer by length, so the order a row's partials
are added in would depend on how many rows share the call, and a decode
step at 8 rows would differ in the last bit from a sequential run at 1.
The partials are added in float32 and the sum is cast back once.

Gradients.  Between layers every model rank holds the activations whole
(replicated), Megatron-style, so each collective has the backward that
gives every rank the gradient of its own share that the unsharded model
gives:

  * ``gather_cat``: the whole output feeds replicated compute, whose
    gradient is the same on every rank; the backward takes this rank's
    slice of it;
  * ``gather_sum``: the backward gives the partial the whole gradient;
  * ``to_ranks``: the identity, put where a whole, replicated tensor
    enters a rank's share of the work; its backward sums the ranks'
    partial gradients, in rank order (``gather_sum``);
  * ``gather_on_use``: a weight whole from each data rank's share (FSDP,
    ZeRO-3: gathered where it is read); its backward is
    ``reduce_scatter_ordered``, this rank's chunk of the ranks' summed
    gradients, each element added in the order and rounding of
    ``gather_sum`` at a reduce-scatter's traffic.

Every call goes through its ``torch.autograd.Function``, with or without
autograd recording (under ``no_grad`` the function records nothing); the
forwards are the collectives above, and the backward's own collectives
count in ``COLLECTIVES`` as the forward's do.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist

__all__ = ["COLLECTIVES", "reset_collectives", "MeshAxis", "gather_cat",
           "gather_sum", "to_ranks", "gather_on_use",
           "reduce_scatter_ordered", "broadcast", "all_reduce_sum"]

#: calls by kind, moved on every call (a group of one included); a
#: weight's gather on use counts apart from the activations' all-gathers
COLLECTIVES = {"all_gather": 0, "broadcast": 0, "all_reduce": 0,
               "gather_on_use": 0, "reduce_scatter": 0}


def reset_collectives() -> None:
    for k in COLLECTIVES:
        COLLECTIVES[k] = 0


@dataclasses.dataclass(frozen=True, eq=False)
class MeshAxis:
    """One mesh axis as this rank sees it: the process group of its row
    along the axis, this rank's index in it and the axis's size."""

    group: Optional[dist.ProcessGroup]
    rank: int
    size: int

    @classmethod
    def of(cls, mesh, name: str) -> "MeshAxis":
        return cls(mesh.get_group(name), mesh.get_local_rank(name),
                   mesh.size(mesh.mesh_dim_names.index(name)))

    def range(self, n: int) -> tuple[int, int]:
        """This rank's contiguous share [lo, hi) of ``n`` items (the whole
        where the axis does not divide ``n``)."""
        if n % self.size:
            return 0, n
        w = n // self.size
        return self.rank * w, (self.rank + 1) * w


# one output tensor for all ranks (the list form allocates and copies a
# tensor a rank); ``all_gather_single`` is its name from torch 2.13 on
_GATHER_ONE = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor


def _all_gather(t: torch.Tensor, axis: MeshAxis,
                kind: str = "all_gather") -> torch.Tensor:
    """(axis.size, *t.shape): every rank's ``t``, in rank order."""
    t = t.contiguous()
    out = torch.empty((axis.size * t.shape[0], *t.shape[1:]),
                      dtype=t.dtype, device=t.device)
    _GATHER_ONE(out, t, group=axis.group)
    COLLECTIVES[kind] += 1
    return out.view(axis.size, *t.shape)


def _gather_cat(t: torch.Tensor, axis: MeshAxis, dim: int,
                kind: str = "all_gather") -> torch.Tensor:
    shape = list(t.shape)
    shape[dim] *= axis.size
    return _all_gather(t, axis, kind).movedim(0, dim).reshape(shape)


def _gather_sum(t: torch.Tensor, axis: MeshAxis) -> torch.Tensor:
    parts = _all_gather(t, axis)
    acc = parts[0].float()
    for i in range(1, axis.size):
        acc = acc + parts[i]
    return acc.to(t.dtype)


def reduce_scatter_ordered(t: torch.Tensor, axis: MeshAxis,
                           dim: int) -> torch.Tensor:
    """This rank's chunk along ``dim`` (the axis's size divides it, chunks
    in rank order) of the sum over the axis's ranks of ``t``: one
    ``all_to_all_single`` of the chunks, then the ranks' chunks added in
    rank order in float32 and cast back once -- each element the bits of
    ``gather_sum(t, axis)``'s, whatever ``t``'s length (never NCCL's
    reduce-scatter, whose order follows the buffer's length)."""
    dim = dim % t.ndim
    n = axis.size
    parts = t.movedim(dim, 0)
    w = parts.shape[0] // n
    parts = parts.reshape(n, w, *parts.shape[1:]).contiguous()
    got = torch.empty_like(parts)
    dist.all_to_all_single(got, parts, group=axis.group)
    COLLECTIVES["reduce_scatter"] += 1
    acc = got[0].float()
    for i in range(1, n):
        acc = acc + got[i]
    return acc.to(t.dtype).movedim(0, dim).contiguous()


class _GatherCat(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, axis, dim):
        ctx.axis, ctx.dim, ctx.width = axis, dim, t.shape[dim]
        return _gather_cat(t, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return (g.narrow(ctx.dim, ctx.axis.rank * ctx.width, ctx.width),
                None, None)


class _GatherSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, axis):
        ctx.dtype = t.dtype
        return _gather_sum(t, axis)

    @staticmethod
    def backward(ctx, g):
        return g.to(ctx.dtype), None


class _ToRanks(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, axis):
        ctx.axis = axis
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return _gather_sum(g.contiguous(), ctx.axis), None


class _GatherOnUse(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        return _gather_cat(t, axis, dim, "gather_on_use")

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter_ordered(g, ctx.axis, ctx.dim), None, None


def gather_cat(t: torch.Tensor, axis: MeshAxis, dim: int = -1
               ) -> torch.Tensor:
    """Every rank's ``t`` concatenated along ``dim`` in rank order; the
    backward keeps this rank's slice of the gradient."""
    return _GatherCat.apply(t, axis, dim % t.ndim)


def gather_sum(t: torch.Tensor, axis: MeshAxis) -> torch.Tensor:
    """The sum over the axis's ranks of ``t``, added in rank order in
    float32 (a reduction whose order does not depend on ``t``'s length),
    in ``t``'s dtype; the backward passes the whole gradient to ``t``."""
    return _GatherSum.apply(t, axis)


def to_ranks(t: torch.Tensor, axis: MeshAxis) -> torch.Tensor:
    """``t`` (whole and the same on every rank of the axis) as the input of
    this rank's share of the work: the identity, whose backward sums the
    ranks' partial gradients in rank order."""
    return _ToRanks.apply(t, axis)


def gather_on_use(shard: torch.Tensor, axis: MeshAxis, dim: int
                  ) -> torch.Tensor:
    """A weight whole from the data ranks' shares along ``dim`` (in rank
    order: exact); the backward gives this rank's share the sum over the
    ranks of the whole weight's gradient (``reduce_scatter_ordered``)."""
    return _GatherOnUse.apply(shard, axis, dim % shard.ndim)


def broadcast(t: torch.Tensor, src: int,
              group: Optional[dist.ProcessGroup] = None) -> torch.Tensor:
    """``t`` from global rank ``src`` to every rank of ``group`` (the
    world by default), in place."""
    dist.broadcast(t, src=src, group=group)
    COLLECTIVES["broadcast"] += 1
    return t


def all_reduce_sum(t: torch.Tensor, axis: MeshAxis) -> torch.Tensor:
    """In-place sum over the axis; for integer payloads, whose sum is exact
    in any order (``train.compress``)."""
    if t.is_floating_point():
        raise TypeError("float sums go through gather_sum (rank order)")
    dist.all_reduce(t, group=axis.group)
    COLLECTIVES["all_reduce"] += 1
    return t
