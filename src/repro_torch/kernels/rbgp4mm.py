"""RBGP4 sparse products and their plain versions.

The port of the six kernels of ``repro/kernels/rbgp4mm.py``.  Feature-major,
the paper's Algorithm 1 (``O = W_s @ I`` for the unfolded input I (K, N)):

``rbgp4mm``          O (M, N) = W_s @ I, and dI = W_s^T @ dO on the
                     transposed layout's tables;
``rbgp4_sddmm``      the compact weight gradient dW = pack(dO @ I^T) from
                     dO (M, N) and I (K, N).

Token-major, the layout the models use:

``rbgp4mm_rhs``      Y = act(X @ W_s^T + bias) + residual, X (N, K) ->
                     Y (N, M), with the pre-activation Z as an optional
                     second output (``save_preact``);
``rbgp4_sddmm_rhs``  the compact weight gradient dW = pack(g^T @ x) from
                     token-major g (N, M) and x (N, K);
``rbgp4mm_rhs_stacked``      Y[e] = act(X[e] @ W_s[e]^T + bias[e]) for all
                     experts e of a MoE layer in one launch, X (E, N, K),
                     with ``save_preact`` and no residual;
``rbgp4_sddmm_rhs_stacked``  dW[e] = pack(g[e]^T @ x[e]) for all experts.

``rbgp4mm_rhs`` and ``rbgp4mm_rhs_stacked`` take ``scales=`` (the int8
path of the reference's ``has_scales``): ``w_data`` then holds int8 leaf
blocks and ``scales`` one float32 scale per (G, C) leaf block, (M/G,
d_o*d_i) (stacked: (E, M/G, d_o*d_i)); each block is dequantized in
float32 (``q * scale``) before the f32 sums.  That path has no epilogue
(bias, activation and residual follow in torch, as the reference's
dispatcher applies them) and no ``save_preact``: PTQ storage serves and
never trains.

W_s is in compact RBGP4 storage ``w_data`` (M, d_o*d_i*C), stacked
(E, M, d_o*d_i*C) over one layout for the experts.  On a CUDA tensor each
wrapper launches its hand-written kernel in ``csrc/`` (see the source notes
for the designs and what bounds them); on a CPU tensor it runs its plain
version (``*_reference``).  There is no other path: a failed build or
launch raises.  Every kernel but the int8 paths has a second device
body for bfloat16 on the tensor cores; ``rhs_path`` (both token-major
forward entry points), ``sddmm_path`` (both token-major dW entry points),
``fm_path`` (``rbgp4mm``) and ``fm_sddmm_path`` (``rbgp4_sddmm``) say
which body a launch takes, from dtype and shape alone
(``sddmm_mma_plan`` and ``fm_sddmm_plan`` are the dW bodies' token-slice
plans, ``fm_mma_tile`` the feature-major forward's tile).

Launch counters, each moved only where its kernel launches (plain runs
never count): ``rbgp4mm.launches`` on forward layouts,
``rbgp4mm.launches_dx`` on transposed ones (dI), ``rbgp4_sddmm.launches``,
``rbgp4mm_rhs.launches`` on forward layouts,
``rbgp4mm_rhs.launches_dx`` on transposed ones (dX, tables built with
``transposed=True``), ``rbgp4_sddmm_rhs.launches``, and the same three
for the stacked kernels: ``rbgp4mm_rhs_stacked.launches``,
``rbgp4mm_rhs_stacked.launches_dx`` and ``rbgp4_sddmm_rhs_stacked.launches``,
and the int8 paths apart from them: ``rbgp4mm_rhs.launches_q`` and
``rbgp4mm_rhs_stacked.launches_q``.  The launches that took the
tensor-core body count again in ``rbgp4mm_rhs.launches_mma`` (forward
and dX), ``rbgp4mm_rhs_stacked.launches_mma`` (forward and dX),
``rbgp4_sddmm_rhs.launches_mma``, ``rbgp4_sddmm_rhs_stacked.launches_mma``,
``rbgp4mm.launches_mma`` (O and dI) and ``rbgp4_sddmm.launches_mma``.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from . import build
from .ref import (dequant_leaf_blocks, gather_mm, gather_mm_rhs,
                  gather_mm_rhs_stacked, gather_sddmm, gather_sddmm_rhs,
                  gather_sddmm_rhs_stacked)

__all__ = ["KernelDims", "KernelTables", "RowGroupClasses", "TransposeTables",
           "EPILOGUE_ACTS",
           "rbgp4mm", "rbgp4mm_reference", "rbgp4_sddmm",
           "rbgp4_sddmm_reference", "rbgp4mm_rhs", "rbgp4mm_rhs_reference", "rbgp4_sddmm_rhs",
           "rbgp4_sddmm_rhs_reference", "rbgp4mm_rhs_stacked",
           "rbgp4mm_rhs_stacked_reference", "rbgp4_sddmm_rhs_stacked",
           "rbgp4_sddmm_rhs_stacked_reference", "MMA_MIN_TOKENS",
           "rhs_path", "sddmm_path", "SddmmPlan", "sddmm_mma_plan",
           "stacked_mma_block_tokens", "fm_path", "fm_sddmm_path",
           "FM_MMA_TILES", "FM_SDDMM_TILES",
           "fm_mma_tile", "fm_sddmm_tile", "fm_sddmm_plan"]

# Activations fusable into the epilogue; names match ``models.mlp.ACTS``.
EPILOGUE_ACTS = {
    "relu": torch.relu,
    "gelu": lambda z: F.gelu(z, approximate="tanh"),
    "silu": F.silu,
}
_ACT_CODES = {None: 0, "relu": 1, "gelu": 2, "silu": 3}
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


@dataclasses.dataclass(frozen=True)
class KernelDims:
    """Static kernel dimensions derived from an RBGP4Layout."""

    m: int               # rows of W_s / columns of Y
    k: int               # cols of W_s / columns of X
    tile_m: int          # TM = U_i * G
    tile_k: int          # TK = V_i * C
    group_rows: int      # G
    chunk_cols: int      # C
    d_o: int             # non-zero tiles per tile-row
    d_i: int             # non-zero inner blocks per group-row
    u_i: int             # |G_i.U|
    v_i: int             # |G_i.V|

    @property
    def n_col_tiles(self) -> int:
        return self.k // self.tile_k

    @property
    def data_cols(self) -> int:
        return self.d_o * self.d_i * self.chunk_cols

    @classmethod
    def from_layout(cls, layout) -> "KernelDims":
        sp = layout.spec
        return cls(
            m=sp.m, k=sp.k, tile_m=sp.tile_m, tile_k=sp.tile_k,
            group_rows=sp.group_rows, chunk_cols=sp.chunk_cols,
            d_o=sp.d_o, d_i=sp.d_i, u_i=sp.g_i[0], v_i=sp.g_i[1],
        )


@dataclasses.dataclass(frozen=True, eq=False)
class RowGroupClasses:
    """The row-group classes of a ``col0`` table: the row groups whose
    ``col0`` rows are equal, each class one dense product (its rows read
    the same input columns).  ``col0`` (n_classes, n_chunks) int32 is each
    class's one ``col0`` row; ``groups`` (M/G,) int32 lists the row groups
    class by class, in increasing order within a class; class ``c`` owns
    ``groups[start[c] : start[c+1]]`` (``start`` (n_classes + 1,) int32).
    ``sizes`` holds each class's count of row groups on the host, and
    ``max_groups`` the largest."""

    col0: torch.Tensor
    groups: torch.Tensor
    start: torch.Tensor
    sizes: tuple[int, ...]

    @property
    def max_groups(self) -> int:
        return max(self.sizes)

    @property
    def n_classes(self) -> int:
        return self.col0.shape[0]

    @classmethod
    def build(cls, col0: np.ndarray, device) -> "RowGroupClasses":
        rows, inv = np.unique(col0, axis=0, return_inverse=True)
        inv = inv.reshape(-1)
        counts = np.bincount(inv, minlength=len(rows))
        start = np.concatenate([[0], np.cumsum(counts)])

        def on_device(a):
            return torch.as_tensor(np.ascontiguousarray(a),
                                   dtype=torch.int32, device=device)

        return cls(on_device(rows), on_device(np.argsort(inv, kind="stable")),
                   on_device(start), tuple(int(c) for c in counts))


@dataclasses.dataclass(frozen=True, eq=False)
class KernelTables:
    """A layout's kernel dimensions and index tables on one device.

    Built once per layer (``SparseLinear`` holds one) and passed to every
    call, so a call does no host-side layout work.  ``col0`` (M/G, d_o*d_i)
    int32 is what the kernel reads: row group ``rg = o*u_i + u`` and slot
    ``s = kk*d_i + ki`` read input columns ``col0[rg, s] + c`` for
    ``c < C``, with ``col0[rg, s] = adj_o[o, kk]*TK + adj_i[u, ki]*C``.
    ``adj_o`` (n_o_l, d_o) and ``adj_i`` (u_i, d_i) int64 are the plain
    version's gather indices.  ``transposed`` marks the tables of a
    transposed layout (dX), whose launches count apart.  ``classes`` are
    ``col0``'s row-group classes, which ``rbgp4mm``'s tensor-core body
    walks (on a transposed layout whole tile-columns of row groups read
    one ``col0`` row).
    """

    dims: KernelDims
    col0: torch.Tensor
    adj_o: torch.Tensor
    adj_i: torch.Tensor
    classes: RowGroupClasses
    transposed: bool = False

    @classmethod
    def build(cls, layout, device, transposed: bool = False
              ) -> "KernelTables":
        dims = KernelDims.from_layout(layout)
        adj_o = np.asarray(layout.adj_o, np.int64)
        adj_i = np.asarray(layout.adj_i, np.int64)
        col0 = (adj_o[:, None, :, None] * dims.tile_k
                + adj_i[None, :, None, :] * dims.chunk_cols)
        col0 = col0.reshape(dims.m // dims.group_rows, dims.d_o * dims.d_i)

        def on_device(a, dtype):
            return torch.as_tensor(a, dtype=dtype, device=device).contiguous()

        return cls(dims, on_device(col0, torch.int32),
                   on_device(adj_o, torch.int64),
                   on_device(adj_i, torch.int64),
                   RowGroupClasses.build(col0, device), transposed)


@dataclasses.dataclass(frozen=True, eq=False)
class TransposeTables:
    """What ``dX = g @ W_s`` needs: the kernel tables of the layout of W^T
    and ``perm`` (int32, M*nnz_row), the slot permutation with
    ``values(w_data).flat == w_data.flat[perm]``, which packs W^T in that
    layout (the reference's ``RBGP4Op.transpose_data``).

    Built once per layer on its device, by the owning ``SparseLinear``
    when a gradient is first asked of it.  The permutation is read off a
    dense (M, K) map of each non-zero's compact slot, on the device.
    """

    tables: KernelTables
    perm: torch.Tensor

    @classmethod
    def build(cls, layout, device) -> "TransposeTables":
        lt = layout.transpose_layout()
        m, k = layout.m, layout.k
        ci = torch.as_tensor(layout._col_index(), dtype=torch.int64,
                             device=device)
        ci_t = torch.as_tensor(lt._col_index(), dtype=torch.int64,
                               device=device)
        # slot[r, c] = flat index into w_data of W[r, c]; -1 off the mask
        slot = torch.full((m, k), -1, dtype=torch.int32, device=device)
        slot.scatter_(1, ci, torch.arange(ci.numel(), dtype=torch.int32,
                                          device=device).reshape(ci.shape))
        # row j of W^T holds W[ci_t[j, s], j] in its slot s
        perm = slot[ci_t, torch.arange(k, device=device)[:, None]].reshape(-1)
        if bool((perm < 0).any()):
            raise ValueError("the transposed layout does not cover the "
                             "forward layout's non-zeros")
        return cls(KernelTables.build(lt, device, transposed=True),
                   perm.contiguous())

    def values(self, w_data: torch.Tensor) -> torch.Tensor:
        """The compact values of W^T in the transposed layout; stacked
        values (E, M, nnz_row) are permuted per expert (the reference's
        ``transpose_data_stacked``)."""
        dims = self.tables.dims
        lead = w_data.shape[:-2]
        return w_data.reshape(*lead, -1).index_select(-1, self.perm).reshape(
            *lead, dims.m, dims.data_cols)


def _check_args(dims, x, w_data, act):
    if tuple(w_data.shape) != (dims.m, dims.data_cols):
        raise ValueError(
            f"w_data {tuple(w_data.shape)} != {(dims.m, dims.data_cols)}")
    if x.ndim != 2 or x.shape[1] != dims.k:
        raise ValueError(f"x {tuple(x.shape)} is not (N, K={dims.k})")
    if act is not None and act not in EPILOGUE_ACTS:
        raise ValueError(f"act {act!r} not in {sorted(EPILOGUE_ACTS)}")


def _check_scales(dims, w_data, scales, lead: tuple = (), **epilogue):
    """The int8 path: one float32 scale per (G, C) leaf block, int8
    values, and no epilogue (``epilogue`` names the arguments given)."""
    want = (*lead, dims.m // dims.group_rows, dims.d_o * dims.d_i)
    if tuple(scales.shape) != want:
        raise ValueError(f"scales {tuple(scales.shape)} != {want}")
    if w_data.dtype != torch.int8:
        raise TypeError(f"with scales, w_data holds int8 leaf blocks, got "
                        f"{w_data.dtype}")
    given = sorted(k for k, v in epilogue.items()
                   if v is not None and v is not False)
    if given:
        raise ValueError(f"the int8 scales= path has no epilogue ({given} "
                         f"given): apply bias, activation and residual "
                         f"after it")


def _values_f32(dims, w_data, scales):
    """The plain versions' float32 weight values: int8 leaf blocks
    dequantized against their scales, else the values themselves."""
    if scales is None:
        return w_data.float()
    return dequant_leaf_blocks(w_data, scales, dims.group_rows,
                               dims.chunk_cols)


def rbgp4mm_rhs_reference(tables: KernelTables, x: torch.Tensor,
                          w_data: torch.Tensor, *,
                          scales: Optional[torch.Tensor] = None,
                          bias: Optional[torch.Tensor] = None,
                          act: Optional[str] = None,
                          residual: Optional[torch.Tensor] = None,
                          save_preact: bool = False):
    """Plain version: gather + einsum in f32, then the epilogue in f32.
    Returns Y, or (Y, Z) with ``save_preact``, in the dtype of X.  With
    ``scales``, int8 ``w_data`` is dequantized in f32 first."""
    dims = tables.dims
    _check_args(dims, x, w_data, act)
    if scales is not None:
        _check_scales(dims, w_data, scales, bias=bias, act=act,
                      residual=residual, save_preact=save_preact)
    z = gather_mm_rhs(tables.adj_o, tables.adj_i, dims.n_col_tiles,
                      dims.group_rows, dims.chunk_cols,
                      _values_f32(dims, w_data, scales), x.float())
    if bias is not None:
        z = z + bias.float()
    y = EPILOGUE_ACTS[act](z) if act is not None else z
    if residual is not None:
        y = y + residual.float()
    if save_preact:
        return y.to(x.dtype), z.to(x.dtype)
    return y.to(x.dtype)


# -- which body a launch takes ------------------------------------------------
#
# ``rbgp4mm_rhs`` (and ``rbgp4mm_rhs_stacked``) and ``rbgp4_sddmm_rhs``
# have two device bodies each: the FMA body (CUDA cores, f32 or bf16, any
# shape) and the bf16 tensor-core body (``mma.sync`` from a ``cp.async``
# ring; ``*_mma_kernel`` in the profile).  The choice is a fixed function
# of dtype and shape, made here and passed to the C launcher, which
# refuses a shape the mma body cannot take; nothing falls back from one
# body to the other.

#: fewest tokens a launch gives the mma bodies; below it (decode at 8
#: rows, host-bound) the FMA body runs.  ``chip_smoke.phase_body_sweep``
#: timed both bodies on an H100 at 8-512 tokens: the mma bodies were the
#: faster at every size, so this is the least size above decode's 8 swept
MMA_MIN_TOKENS = 16
#: G the forward's mma body is built for (one template each)
RHS_MMA_GROUP_ROWS = (16, 32, 64, 128)
#: tokens a block of the forward's mma body on the unstacked entry point
RHS_MMA_BLOCK_TOKENS = 128
#: tokens a stage of the dW mma body (16 for each of its 8 warps), the
#: unit of its token slices; and the fewest tokens a slice gets
SDDMM_MMA_STAGE_TOKENS = 128
SDDMM_MMA_MIN_SLICE = 256
#: blocks the dW mma grid wants, in waves of the card's SM count
SDDMM_MMA_WAVES = 2
_PATH_CODES = {"fma": 0, "mma": 1}


def rhs_path(dims: KernelDims, n_tokens: int, dtype: torch.dtype) -> str:
    """``"mma"`` or ``"fma"``: the body a launch of ``rbgp4mm_rhs`` takes
    for ``n_tokens`` rows of X of ``dtype`` on the layout of ``dims``, and
    a launch of ``rbgp4mm_rhs_stacked`` for ``n_tokens`` rows an expert.
    The mma body takes bfloat16 at ``n_tokens >= MMA_MIN_TOKENS``, G in
    ``RHS_MMA_GROUP_ROWS``, and C and K multiples of 8 (16-byte loads);
    float32 (no TF32) keeps the FMA body, and so do the int8 entry points
    (both), which have no other."""
    if (dtype != torch.bfloat16 or n_tokens < MMA_MIN_TOKENS
            or dims.group_rows not in RHS_MMA_GROUP_ROWS
            or dims.chunk_cols % 8 or dims.k % 8):
        return "fma"
    return "mma"


def stacked_mma_block_tokens(n_tokens: int, transposed: bool) -> int:
    """Token tile of ``rbgp4mm_rhs_stacked``'s tensor-core body for
    ``n_tokens`` rows an expert, on forward or ``transposed`` (dX) tables:
    64 for dX, and for the forward where the last 128-token tile would be
    at most half full (a training step's 171 rows then compute 192 rows
    instead of 256), else 128.  ``chip_smoke.phase_stacked_tiles`` timed
    both tiles at qwen2-moe-a2.7b's expert layouts on an H100 from 16 to
    512 rows an expert: this picks the faster one at every size swept."""
    rest = n_tokens % RHS_MMA_BLOCK_TOKENS
    if transposed or 0 < rest <= 64:
        return 64
    return RHS_MMA_BLOCK_TOKENS


def sddmm_path(dims: KernelDims, n_tokens: int, dtype: torch.dtype) -> str:
    """``"mma"`` or ``"fma"``: the body a launch of ``rbgp4_sddmm_rhs``
    takes for ``n_tokens`` tokens, and a launch of
    ``rbgp4_sddmm_rhs_stacked`` for ``n_tokens`` rows an expert.  The mma
    body takes bfloat16 at ``n_tokens >= MMA_MIN_TOKENS``, G and C
    multiples of 16 and K a multiple of 8; float32 (no TF32) keeps the FMA
    body."""
    if (dtype != torch.bfloat16 or n_tokens < MMA_MIN_TOKENS
            or dims.group_rows % 16 or dims.chunk_cols % 16 or dims.k % 8):
        return "fma"
    return "mma"


#: (block_cols, stage_tokens) of the dW mma body that
#: ``chip_smoke.phase_stacked_dw_tiles`` times for the stacked entry point
STACKED_SDDMM_TILES = ((16, 128), (32, 128), (64, 128), (128, 128),
                       (16, 64), (32, 64), (64, 64), (128, 64))


def stacked_sddmm_tile(dims: KernelDims, n_tokens: int) -> tuple[int, int]:
    """(block_cols, stage_tokens) of ``rbgp4_sddmm_rhs_stacked``'s
    tensor-core body for ``n_tokens`` rows an expert: a block owns the
    widest of 128, 64, 32, 16 compact columns that the row's columns
    fill at least half of (several slots of one 16-row sub-tile where C is
    smaller, so one staged g tile serves them all), with 64-token stages
    on 4 warps."""
    bc = 128
    while bc > 16 and 2 * dims.data_cols <= bc:
        bc //= 2
    return bc, 64


@dataclasses.dataclass(frozen=True)
class SddmmPlan:
    """The launch plan of a dW mma body: a block owns ``block_cols``
    columns (``rbgp4_sddmm_rhs``: of one row's compact columns, by 16
    rows) over one of ``n_slices`` token slices of ``slice_len`` tokens
    (the last one ragged), in stages of ``stage_tokens``; ``blocks``
    blocks in all."""

    block_cols: int
    n_slices: int
    slice_len: int
    blocks: int
    stage_tokens: int

    def workspace_shape(self, dims, n_experts: int = 1) -> Optional[tuple]:
        """The float32 partial sums' shape, (n_experts * n_slices, M,
        nnz_row) of ``dims`` (``KernelDims`` or ``ChainTables``), or None
        for a single slice (the block writes dW itself)."""
        if self.n_slices == 1:
            return None
        return (n_experts * self.n_slices, dims.m, dims.data_cols)


#: the plan of an FMA launch, which takes none
_NO_PLAN = SddmmPlan(0, 1, 0, 0, 0)


def sddmm_mma_plan(dims: KernelDims, n_tokens: int, sm_count: int,
                   n_experts: int = 1,
                   tile: Optional[tuple[int, int]] = None) -> SddmmPlan:
    """The dW mma body's plan on a card of ``sm_count`` SMs for
    ``n_experts`` experts (1: the unstacked entry point) of ``n_tokens``
    tokens each: ``tile`` (block_cols, stage_tokens), by default the
    widest ``block_cols`` in (128, 64, 32, 16) dividing C with
    ``SDDMM_MMA_STAGE_TOKENS``-token stages, and as many token slices as
    bring the grid to ``SDDMM_MMA_WAVES`` waves of blocks, each of at
    least ``SDDMM_MMA_MIN_SLICE`` tokens and a whole number of stages."""
    if tile is None:
        tile = (next(b for b in (128, 64, 32, 16) if dims.chunk_cols % b == 0),
                SDDMM_MMA_STAGE_TOKENS)
    bc, stage = tile
    base = n_experts * (dims.m // 16) * -(-dims.data_cols // bc)
    return token_slices(bc, base, n_tokens, sm_count, stage)


def stacked_sddmm_mma_plan(dims: KernelDims, n_experts: int, n_tokens: int,
                           sm_count: int) -> SddmmPlan:
    """The plan of ``rbgp4_sddmm_rhs_stacked``'s tensor-core body:
    ``sddmm_mma_plan`` with the tile ``stacked_sddmm_tile`` names.  At a
    qwen2-moe-a2.7b training step (60 experts, 171 rows an expert) the
    grid has tens of thousands of blocks, so one slice and no
    workspace."""
    return sddmm_mma_plan(dims, n_tokens, sm_count, n_experts,
                          stacked_sddmm_tile(dims, n_tokens))


def token_slices(block_cols: int, base: int, n_tokens: int, sm_count: int,
                 stage: int) -> SddmmPlan:
    """The token-slice plan of a dW mma body whose grid has ``base``
    blocks a slice: as many slices as bring it to ``SDDMM_MMA_WAVES``
    waves on ``sm_count`` SMs, each of at least ``SDDMM_MMA_MIN_SLICE``
    tokens and a whole number of ``stage``-token stages."""
    want = -(-SDDMM_MMA_WAVES * sm_count // base)
    most = -(-n_tokens // SDDMM_MMA_MIN_SLICE)
    slices = max(1, min(want, most))
    per_slice = -(-n_tokens // slices)
    slice_len = -(-per_slice // stage) * stage  # whole stages
    slices = -(-n_tokens // slice_len)
    return SddmmPlan(block_cols, slices, slice_len, base * slices, stage)


#: G the feature-major tensor-core body (``rbgp4mm``, O and dI) takes:
#: VGG19-CIFAR's, forward and transposed, the ones its tiles were swept at
FM_MMA_GROUP_ROWS = (8, 16, 32, 64)
#: (rows, warps_m, warps_k) tiles ``rbgp4mm``'s tensor-core body is built
#: for: a block owns ``rows`` rows of one row-group class
#: (``KernelTables.classes``) by 128 tokens on warps_m x warps_k warps,
#: warps_k of them splitting the contraction; exactly the tiles
#: ``fm_mma_tile`` can name
FM_MMA_TILES = ((16, 4, 1), (16, 8, 1), (16, 2, 4), (32, 4, 1), (32, 8, 1),
                (32, 2, 4), (64, 4, 1))
#: block columns ``rbgp4_sddmm``'s tensor-core body is built for (32
#: columns a warp), and the tokens of its stages
FM_SDDMM_TILES = (64, 128, 256)
FM_SDDMM_STAGE_TOKENS = 64


def fm_path(dims: KernelDims, n: int, dtype: torch.dtype) -> str:
    """``"mma"`` or ``"fma"``: the body a launch of ``rbgp4mm`` (O on a
    forward layout's tables, dI on a transposed one's) takes for I of ``n``
    columns of ``dtype``.  The mma body takes bfloat16 at ``n >=
    MMA_MIN_TOKENS`` with ``n`` a multiple of 8 (every row of I and O then
    starts 16-byte aligned), G in ``FM_MMA_GROUP_ROWS`` and C a multiple
    of 8; float32 (no TF32) keeps the FMA body, and so do the other
    shapes (WRN-40-4's C = 2 and transposed G = 2, odd G)."""
    if (dtype != torch.bfloat16 or n < MMA_MIN_TOKENS or n % 8
            or dims.group_rows not in FM_MMA_GROUP_ROWS
            or dims.chunk_cols % 8):
        return "fma"
    return "mma"


def fm_sddmm_path(dims: KernelDims, n: int, dtype: torch.dtype) -> str:
    """``"mma"`` or ``"fma"``: the body a launch of ``rbgp4_sddmm`` takes
    for ``n`` columns of dO and I of ``dtype``: the mma body at bfloat16,
    ``n >= MMA_MIN_TOKENS`` a multiple of 8, G a multiple of 16 and C of
    8; float32 and the other shapes keep the FMA body."""
    if (dtype != torch.bfloat16 or n < MMA_MIN_TOKENS or n % 8
            or dims.group_rows % 16 or dims.chunk_cols % 8):
        return "fma"
    return "mma"


#: blocks (2 on each SM of an H100 SXM) below which ``rbgp4mm``'s
#: tensor-core body splits a long row's contraction over 4 warps
FM_MMA_SMALL_GRID = 264


def fm_mma_tile(tables: KernelTables, n: int) -> tuple[int, int, int]:
    """(rows, warps_m, warps_k) of ``rbgp4mm``'s tensor-core body for I of
    ``n`` columns on ``tables``.  Class rows a block: 16 where every class
    is one row group (nothing to share), else 32, and 64 at G >= 32 for
    rows of up to 128 compact columns, so one staged I slice serves 2 to
    8 row groups (the transposed tables' classes of 9 or 18).  Warps, for
    128 tokens a block: 4 along the tokens for rows of up to 128 compact
    columns (every dI at VGG19-CIFAR's 0.75); for longer rows 8 along the
    tokens, or 2 x 4 (four along the contraction) where the grid has fewer
    than ``FM_MMA_SMALL_GRID`` blocks (512 x 4608 at N = 1024).  The rule
    names every tile of ``FM_MMA_TILES`` and no other.
    ``chip_smoke.phase_fm_body_sweep`` timed every tile of
    ``FM_MMA_TILES`` (and two more, nowhere the fastest) on both tables
    at VGG19-CIFAR's eight layer shapes on an H100: this names the fastest
    at each but O at 128 x 1152, where 4 warps along the tokens were
    1.3-1.8% faster."""
    dims = tables.dims
    cl = tables.classes
    G = dims.group_rows
    rows = 16 if cl.max_groups == 1 else min(64, max(32, 2 * G))
    if dims.data_cols <= 128:
        return rows, 4, 1
    # 64 rows are built on 4 x 1 warps only: on 8 x 1 they were nowhere
    # the fastest (the sweep), and longer rows take 8 x 1 or 2 x 4
    rows = min(rows, 32)
    blocks = sum(-(-s * G // rows) for s in cl.sizes) * -(-n // 128)
    if blocks < FM_MMA_SMALL_GRID:
        return rows, 2, 4
    return rows, 8, 1


def _fm_k_steps(dims: KernelDims, warps_k: int) -> list[list[int]]:
    """The k16 steps (16 compact columns each, the row's last one
    zero-filled past ``data_cols``) each of the ``warps_k`` contraction
    warps of ``rbgp4mm``'s tensor-core body walks, in its order: warp wk
    takes steps wk, wk + warps_k, ... (of every 64-column stage, 4 % warps_k
    == 0); the warps' sums are added in warp order."""
    n16 = -(-dims.data_cols // 16)
    return [list(range(wk, n16, warps_k)) for wk in range(warps_k)]


def fm_sddmm_tile(dims: KernelDims, n: int) -> int:
    """Block columns of ``rbgp4_sddmm``'s tensor-core body for ``n``
    tokens on the layout of ``dims``, by the length of the row: 256 where
    one block holds the whole row (C = 8: 144 columns, one staged g tile
    for all 18 slots), 128 up to 576 columns, 64 beyond (512 x 4608:
    1152).  ``chip_smoke.phase_fm_body_sweep`` timed each block of
    ``FM_SDDMM_TILES`` at VGG19-CIFAR's eight layer shapes on an H100: this
    names the fastest at each."""
    if dims.data_cols <= 256:
        return 256
    if dims.data_cols <= 576:
        return 128
    return 64


def fm_sddmm_plan(dims: KernelDims, n: int, sm_count: int,
                  block_cols: Optional[int] = None) -> SddmmPlan:
    """The plan of ``rbgp4_sddmm``'s tensor-core body on a card of
    ``sm_count`` SMs: ``block_cols`` (``fm_sddmm_tile``'s unless given)
    compact columns of 16 rows a block, ``FM_SDDMM_STAGE_TOKENS``-token
    stages, and as many token slices as bring the grid to
    ``SDDMM_MMA_WAVES`` waves (``token_slices``)."""
    bc = fm_sddmm_tile(dims, n) if block_cols is None else block_cols
    base = (dims.m // 16) * -(-dims.data_cols // bc)
    return token_slices(bc, base, n, sm_count, FM_SDDMM_STAGE_TOKENS)


def _sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _check_aligned16(name: str, operands: dict) -> None:
    """The mma bodies load X, W, g and x 16 bytes at a time."""
    for name_t, t in operands.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name}'s tensor-core body needs {name_t} "
                             f"16-byte aligned (data_ptr {t.data_ptr():#x})")


def _launcher(source: str, entry: str, signature: str):
    """The C launcher ``<entry>_launch`` of the library built from kernel
    source ``source`` (at first use), with its C signature declared:
    without ``argtypes`` ctypes would cut pointers to 32 bits.
    ``signature`` spells the launcher's arguments: 'p' a pointer (the
    stream too), 'i' an int.  Returns (launcher, error-string function)."""
    lib = build.load(source)
    launch = getattr(lib, f"{entry}_launch")
    err = getattr(lib, f"{source}_error_string")
    if launch.argtypes is None:
        kinds = {"p": ctypes.c_void_p, "i": ctypes.c_int}
        launch.argtypes = [kinds[c] for c in signature]
        launch.restype = ctypes.c_int
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
    return launch, err


def _launch(source: str, entry: str, signature: str, *args) -> None:
    """Call the C launcher ``<entry>_launch`` of ``source``'s library on
    the current stream of the device the arguments' tensors lie on (the
    last argument); raise on its error."""
    launch, error_string = _launcher(source, entry, signature)
    device = args[-1]
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = launch(*args[:-1], stream)
    if err != 0:
        msg = error_string(err).decode()
        raise RuntimeError(f"{entry} launch failed: CUDA error {err} ({msg})")


def _check_cuda(name: str, tables: KernelTables, dt, operands: dict,
                dtypes: Optional[dict] = None) -> None:
    """Device, dtype and contiguity checks shared by the kernels: every
    operand of dtype ``dt`` unless ``dtypes`` names another for it (the
    int8 values and float32 scales of the int8 paths)."""
    first = next(iter(operands.values()))
    if first.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, got {first.device}")
    if dt not in _DTYPE_CODES:
        raise TypeError(f"{name} kernel takes float32 or bfloat16, got {dt}")
    if tables.col0.device != first.device:
        raise ValueError(f"kernel tables are on {tables.col0.device}, "
                         f"operands on {first.device}")
    for name_t, t in operands.items():
        if t.device != first.device:
            raise ValueError(f"{name_t} is on {t.device}, not {first.device}")
        want = (dtypes or {}).get(name_t, dt)
        if t.dtype != want:
            raise TypeError(f"{name_t} is {t.dtype}, not {want}")
        if not t.is_contiguous():
            raise ValueError(f"{name_t} must be contiguous")


def rbgp4mm_rhs(tables: KernelTables, x: torch.Tensor,
                w_data: torch.Tensor, *,
                scales: Optional[torch.Tensor] = None,
                bias: Optional[torch.Tensor] = None,
                act: Optional[str] = None,
                residual: Optional[torch.Tensor] = None,
                save_preact: bool = False):
    """Y = act(X @ W_s^T + bias) + residual; X (N, K) token-major -> Y (N, M).

    Returns Y, or (Y, Z) with ``save_preact``: Z = X @ W_s^T + bias, the
    pre-activation, stored from the same f32 sums.  ``tables`` are the
    layout's kernel tables on the device of ``x``.  CPU tensors run the
    plain version; CUDA tensors launch the kernel, which takes float32 or
    bfloat16 X with W, bias and residual of the same dtype, all contiguous,
    and writes Y (and Z) in that dtype.

    ``scales`` (M/G, d_o*d_i) float32 selects the int8 path: ``w_data``
    holds int8 leaf blocks, each dequantized against its scale before the
    f32 sums; Y only, no epilogue (its own kernel and ``launches_q``).
    """
    dims = tables.dims
    _check_args(dims, x, w_data, act)
    if x.device.type == "cpu":
        return rbgp4mm_rhs_reference(tables, x, w_data, scales=scales,
                                     bias=bias, act=act, residual=residual,
                                     save_preact=save_preact)
    dt = x.dtype
    n, m = x.shape[0], dims.m
    if scales is not None:
        _check_scales(dims, w_data, scales, bias=bias, act=act,
                      residual=residual, save_preact=save_preact)
        _check_cuda("rbgp4mm_rhs", tables, dt,
                    {"x": x, "w_data": w_data, "scales": scales},
                    {"w_data": torch.int8, "scales": torch.float32})
        out = torch.empty((n, m), dtype=dt, device=x.device)
        if n > 0:
            _launch("rbgp4mm_rhs", "rbgp4mm_rhs_q", "ipppppiiiiiip",
                    _DTYPE_CODES[dt], x.data_ptr(), w_data.data_ptr(),
                    scales.data_ptr(), tables.col0.data_ptr(),
                    out.data_ptr(), n, dims.k, m, dims.d_o * dims.d_i,
                    dims.group_rows, dims.chunk_cols, x.device)
            rbgp4mm_rhs.launches_q += 1
        return out
    operands = {"x": x, "w_data": w_data}
    if bias is not None:
        operands["bias"] = bias
        if tuple(bias.shape) != (m,):
            raise ValueError(f"bias {tuple(bias.shape)} != ({m},)")
    if residual is not None:
        operands["residual"] = residual
        if tuple(residual.shape) != (n, m):
            raise ValueError(f"residual {tuple(residual.shape)} != {(n, m)}")
    _check_cuda("rbgp4mm_rhs", tables, dt, operands)
    path = rhs_path(dims, n, dt)
    out = torch.empty((n, m), dtype=dt, device=x.device)
    z = torch.empty((n, m), dtype=dt, device=x.device) if save_preact else None
    if n > 0:
        _rhs_body(path, tables, x, w_data, out, z, bias=bias,
                  residual=residual, act=act)
        if tables.transposed:
            rbgp4mm_rhs.launches_dx += 1
        else:
            rbgp4mm_rhs.launches += 1
        if path == "mma":
            rbgp4mm_rhs.launches_mma += 1
    return (out, z) if save_preact else out


def _rhs_body(path: str, tables: KernelTables, x: torch.Tensor,
              w_data: torch.Tensor, out: torch.Tensor,
              z: Optional[torch.Tensor] = None, *,
              bias: Optional[torch.Tensor] = None,
              residual: Optional[torch.Tensor] = None,
              act: Optional[str] = None) -> None:
    """Launch body ``path`` ("fma" or "mma") of ``rbgp4mm_rhs`` on checked
    CUDA operands of one dtype, writing ``out`` (and ``z``): the one C
    launch of the unstacked full-precision kernel.  It moves no counter;
    ``rbgp4mm_rhs`` counts its own launches, and a launch of the other
    body on the same operands (a comparison) is no launch of the model."""
    dims = tables.dims
    if path == "mma":
        _check_aligned16("rbgp4mm_rhs", {"x": x, "w_data": w_data})
    _launch("rbgp4mm_rhs", "rbgp4mm_rhs", "ipppppppiiiiiiiip",
            _DTYPE_CODES[x.dtype], x.data_ptr(), w_data.data_ptr(),
            tables.col0.data_ptr(),
            bias.data_ptr() if bias is not None else None,
            residual.data_ptr() if residual is not None else None,
            out.data_ptr(), z.data_ptr() if z is not None else None,
            x.shape[0], dims.k, dims.m, dims.d_o * dims.d_i,
            dims.group_rows, dims.chunk_cols, _ACT_CODES[act],
            _PATH_CODES[path], x.device)


rbgp4mm_rhs.launches = rbgp4mm_rhs.launches_dx = rbgp4mm_rhs.launches_q = 0
rbgp4mm_rhs.launches_mma = 0


def _check_sddmm_args(dims, g, x):
    n = x.shape[0]
    if x.ndim != 2 or g.ndim != 2 or tuple(g.shape) != (n, dims.m) \
            or x.shape[1] != dims.k:
        raise ValueError(f"bad shapes g={tuple(g.shape)} x={tuple(x.shape)} "
                         f"for M={dims.m}, K={dims.k}")


def rbgp4_sddmm_rhs_reference(tables: KernelTables, g: torch.Tensor,
                              x: torch.Tensor) -> torch.Tensor:
    """Plain version: gather + einsum in f32, written in g's dtype."""
    dims = tables.dims
    _check_sddmm_args(dims, g, x)
    dw = gather_sddmm_rhs(tables.adj_o, tables.adj_i, dims.n_col_tiles,
                          dims.group_rows, dims.chunk_cols, g.float(),
                          x.float())
    return dw.to(g.dtype)


def rbgp4_sddmm_rhs(tables: KernelTables, g: torch.Tensor,
                    x: torch.Tensor) -> torch.Tensor:
    """Compact dW (M, d_o*d_i*C) = pack(g^T @ x) from token-major cotangent
    g (N, M) and input x (N, K); written in g's dtype.

    ``tables`` are the forward layout's kernel tables.  CPU tensors run the
    plain version; CUDA tensors launch the kernel, which takes float32 or
    bfloat16 g and x of one dtype, both contiguous.
    """
    dims = tables.dims
    _check_sddmm_args(dims, g, x)
    if g.device.type == "cpu":
        return rbgp4_sddmm_rhs_reference(tables, g, x)
    dt = g.dtype
    _check_cuda("rbgp4_sddmm_rhs", tables, dt, {"g": g, "x": x})
    n = x.shape[0]
    if n == 0:
        return torch.zeros((dims.m, dims.data_cols), dtype=dt,
                           device=g.device)
    dw = torch.empty((dims.m, dims.data_cols), dtype=dt, device=g.device)
    path = sddmm_path(dims, n, dt)
    _sddmm_body(path, tables, g, x, dw)
    rbgp4_sddmm_rhs.launches += 1
    if path == "mma":
        rbgp4_sddmm_rhs.launches_mma += 1
    return dw


def _sddmm_body(path: str, tables: KernelTables, g: torch.Tensor,
                x: torch.Tensor, dw: torch.Tensor,
                plan: Optional[SddmmPlan] = None) -> None:
    """Launch body ``path`` ("fma" or "mma") of ``rbgp4_sddmm_rhs`` on
    checked CUDA operands of one dtype (N > 0), writing ``dw``; the mma
    body's token-slice workspace is allocated here.  ``plan`` is the mma
    body's (``sddmm_mma_plan``'s unless given: the stacked entry point's
    plan gives an expert's bits).  It moves no counter, as
    ``_rhs_body``."""
    dims = tables.dims
    n = x.shape[0]
    part = None
    if path == "mma":
        _check_aligned16("rbgp4_sddmm_rhs", {"g": g, "x": x})
        if plan is None:
            plan = sddmm_mma_plan(dims, n, _sm_count(g.device))
        shape = plan.workspace_shape(dims)
        if shape is not None:
            part = torch.empty(shape, dtype=torch.float32, device=g.device)
    else:
        plan = _NO_PLAN
    _launch("rbgp4_sddmm_rhs", "rbgp4_sddmm_rhs", "ipppppiiiiiiiiiiip",
            _DTYPE_CODES[g.dtype], g.data_ptr(), x.data_ptr(),
            tables.col0.data_ptr(), dw.data_ptr(),
            part.data_ptr() if part is not None else None, n, dims.k,
            dims.m, dims.d_o * dims.d_i, dims.group_rows, dims.chunk_cols,
            _PATH_CODES[path], plan.block_cols, plan.stage_tokens,
            plan.n_slices, plan.slice_len, g.device)


rbgp4_sddmm_rhs.launches = rbgp4_sddmm_rhs.launches_mma = 0


# -- feature-major: I (K, N), O (M, N), the paper's Algorithm 1 ------------

def _check_fm_args(dims, x, w_data):
    if tuple(w_data.shape) != (dims.m, dims.data_cols):
        raise ValueError(
            f"w_data {tuple(w_data.shape)} != {(dims.m, dims.data_cols)}")
    if x.ndim != 2 or x.shape[0] != dims.k:
        raise ValueError(f"x {tuple(x.shape)} is not (K={dims.k}, N)")


def rbgp4mm_reference(tables: KernelTables, x: torch.Tensor,
                      w_data: torch.Tensor) -> torch.Tensor:
    """Plain version: gather + einsum in f32, written in x's dtype."""
    dims = tables.dims
    _check_fm_args(dims, x, w_data)
    out = gather_mm(tables.adj_o, tables.adj_i, dims.n_col_tiles,
                    dims.group_rows, dims.chunk_cols, w_data.float(),
                    x.float())
    return out.to(x.dtype)


def rbgp4mm(tables: KernelTables, x: torch.Tensor,
            w_data: torch.Tensor) -> torch.Tensor:
    """O (M, N) = W_s @ I for feature-major I = x (K, N).

    ``tables`` are the layout's kernel tables on the device of ``x``; on a
    transposed layout's tables, over ``TransposeTables.values(w_data)``,
    this is dI = W_s^T @ dO.  CPU tensors run the plain version; CUDA
    tensors launch the kernel, which takes float32 or bfloat16 x and
    w_data of one dtype, both contiguous, and writes O in that dtype.  The
    body is ``fm_path``'s (bfloat16 on the tensor cores, counted again in
    ``launches_mma``, with the tile ``fm_mma_tile`` names).
    """
    dims = tables.dims
    _check_fm_args(dims, x, w_data)
    if x.device.type == "cpu":
        return rbgp4mm_reference(tables, x, w_data)
    dt = x.dtype
    _check_cuda("rbgp4mm", tables, dt, {"x": x, "w_data": w_data})
    n = x.shape[1]
    out = torch.empty((dims.m, n), dtype=dt, device=x.device)
    if n > 0:
        path = fm_path(dims, n, dt)
        _fm_body(path, tables, x, w_data, out)
        if tables.transposed:
            rbgp4mm.launches_dx += 1
        else:
            rbgp4mm.launches += 1
        if path == "mma":
            rbgp4mm.launches_mma += 1
    return out


def _fm_body(path: str, tables: KernelTables, x: torch.Tensor,
             w_data: torch.Tensor, out: torch.Tensor,
             tile: Optional[tuple[int, int, int]] = None) -> None:
    """Launch body ``path`` ("fma" or "mma") of ``rbgp4mm`` on checked CUDA
    operands of one dtype (N > 0), writing ``out``; ``tile`` is the mma
    body's (``fm_mma_tile``'s unless given, to time another).  It moves no
    counter, as ``_rhs_body``."""
    dims = tables.dims
    cl = tables.classes
    n = x.shape[1]
    if path == "mma":
        _check_aligned16("rbgp4mm", {"x": x, "w_data": w_data})
        if tile is None:
            tile = fm_mma_tile(tables, n)
    else:
        tile = (0, 0, 0)
    _launch("rbgp4mm", "rbgp4mm", "ippppppp" + "i" * 11 + "p",
            _DTYPE_CODES[x.dtype], x.data_ptr(), w_data.data_ptr(),
            tables.col0.data_ptr(), cl.col0.data_ptr(),
            cl.groups.data_ptr(), cl.start.data_ptr(), out.data_ptr(), n,
            dims.m, dims.d_o * dims.d_i, dims.group_rows, dims.chunk_cols,
            cl.n_classes, cl.max_groups, _PATH_CODES[path], *tile, x.device)


rbgp4mm.launches = rbgp4mm.launches_dx = rbgp4mm.launches_mma = 0


def _check_fm_sddmm_args(dims, g, x):
    n = x.shape[-1]
    if x.ndim != 2 or g.ndim != 2 or tuple(g.shape) != (dims.m, n) \
            or x.shape[0] != dims.k:
        raise ValueError(f"bad shapes dO={tuple(g.shape)} x={tuple(x.shape)} "
                         f"for M={dims.m}, K={dims.k}")


def rbgp4_sddmm_reference(tables: KernelTables, g: torch.Tensor,
                          x: torch.Tensor) -> torch.Tensor:
    """Plain version: gather + einsum in f32, written in g's dtype."""
    dims = tables.dims
    _check_fm_sddmm_args(dims, g, x)
    dw = gather_sddmm(tables.adj_o, tables.adj_i, dims.n_col_tiles,
                      dims.group_rows, dims.chunk_cols, g.float(), x.float())
    return dw.to(g.dtype)


def _sddmm_slices(n: int, dims: KernelDims, device) -> int:
    """How many slices of N the FMA body cuts the contraction into at
    these shapes on ``device`` (its own plan, read from the library)."""
    fn = build.load("rbgp4_sddmm").rbgp4_sddmm_slices
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int] * 5
        fn.restype = ctypes.c_int
    with torch.cuda.device(device):
        return fn(n, dims.m, dims.d_o * dims.d_i, dims.group_rows,
                  dims.chunk_cols)


def rbgp4_sddmm(tables: KernelTables, g: torch.Tensor,
                x: torch.Tensor) -> torch.Tensor:
    """Compact dW (M, d_o*d_i*C) = pack(dO @ I^T) from feature-major
    cotangent g = dO (M, N) and input x = I (K, N); written in g's dtype.

    ``tables`` are the forward layout's kernel tables.  CPU tensors run the
    plain version; CUDA tensors launch the kernel, which takes float32 or
    bfloat16 g and x of one dtype, both contiguous.  The body is
    ``fm_sddmm_path``'s (bfloat16 on the tensor cores with the plan
    ``fm_sddmm_plan`` names, counted again in ``launches_mma``).  Where a
    body cuts N into slices, the f32 workspace of their partial sums is
    allocated here; the slices are added in a fixed order, so a rerun
    gives the same bits.
    """
    dims = tables.dims
    _check_fm_sddmm_args(dims, g, x)
    if g.device.type == "cpu":
        return rbgp4_sddmm_reference(tables, g, x)
    dt = g.dtype
    _check_cuda("rbgp4_sddmm", tables, dt, {"g": g, "x": x})
    n = x.shape[1]
    if n == 0:
        return torch.zeros((dims.m, dims.data_cols), dtype=dt,
                           device=g.device)
    dw = torch.empty((dims.m, dims.data_cols), dtype=dt, device=g.device)
    path = fm_sddmm_path(dims, n, dt)
    _fm_sddmm_body(path, tables, g, x, dw)
    rbgp4_sddmm.launches += 1
    if path == "mma":
        rbgp4_sddmm.launches_mma += 1
    return dw


def _fm_sddmm_body(path: str, tables: KernelTables, g: torch.Tensor,
                   x: torch.Tensor, dw: torch.Tensor,
                   plan: Optional[SddmmPlan] = None) -> None:
    """Launch body ``path`` ("fma" or "mma") of ``rbgp4_sddmm`` on checked
    CUDA operands of one dtype (N > 0), writing ``dw``; the slices'
    workspace is allocated here.  ``plan`` is the mma body's
    (``fm_sddmm_plan``'s unless given, to time another).  It moves no
    counter, as ``_rhs_body``."""
    dims = tables.dims
    n = x.shape[1]
    if path == "mma":
        _check_aligned16("rbgp4_sddmm", {"g": g, "x": x})
        if plan is None:
            plan = fm_sddmm_plan(dims, n, _sm_count(g.device))
        shape = plan.workspace_shape(dims)
    else:
        plan = _NO_PLAN
        slices = _sddmm_slices(n, dims, g.device)
        shape = (slices, dims.m, dims.data_cols) if slices > 1 else None
    part = (torch.empty(shape, dtype=torch.float32, device=g.device)
            if shape is not None else None)
    _launch("rbgp4_sddmm", "rbgp4_sddmm", "ippppp" + "i" * 10 + "p",
            _DTYPE_CODES[g.dtype], g.data_ptr(), x.data_ptr(),
            tables.col0.data_ptr(), dw.data_ptr(),
            part.data_ptr() if part is not None else None, n, dims.m,
            dims.d_o * dims.d_i, dims.group_rows, dims.chunk_cols,
            _PATH_CODES[path], plan.block_cols, plan.stage_tokens,
            plan.n_slices, plan.slice_len, g.device)


rbgp4_sddmm.launches = rbgp4_sddmm.launches_mma = 0


# -- stacked experts: one layout, values and activations with a leading E --

def _check_stacked_args(dims, x, w_data, act):
    if x.ndim != 3 or x.shape[2] != dims.k:
        raise ValueError(f"x {tuple(x.shape)} is not (E, N, K={dims.k})")
    want = (x.shape[0], dims.m, dims.data_cols)
    if tuple(w_data.shape) != want:
        raise ValueError(f"w_data {tuple(w_data.shape)} != {want}")
    if act is not None and act not in EPILOGUE_ACTS:
        raise ValueError(f"act {act!r} not in {sorted(EPILOGUE_ACTS)}")


def rbgp4mm_rhs_stacked_reference(tables: KernelTables, x: torch.Tensor,
                                  w_data: torch.Tensor, *,
                                  scales: Optional[torch.Tensor] = None,
                                  bias: Optional[torch.Tensor] = None,
                                  act: Optional[str] = None,
                                  save_preact: bool = False):
    """Plain version: batched gather + einsum in f32, then the epilogue in
    f32.  Returns Y, or (Y, Z) with ``save_preact``, in the dtype of X.
    With ``scales``, int8 ``w_data`` is dequantized in f32 first."""
    dims = tables.dims
    _check_stacked_args(dims, x, w_data, act)
    if scales is not None:
        _check_scales(dims, w_data, scales, (x.shape[0],), bias=bias,
                      act=act, save_preact=save_preact)
    z = gather_mm_rhs_stacked(tables.adj_o, tables.adj_i, dims.n_col_tiles,
                              dims.group_rows, dims.chunk_cols,
                              _values_f32(dims, w_data, scales), x.float())
    if bias is not None:
        z = z + bias.float()[:, None, :]
    y = EPILOGUE_ACTS[act](z) if act is not None else z
    if save_preact:
        return y.to(x.dtype), z.to(x.dtype)
    return y.to(x.dtype)


def rbgp4mm_rhs_stacked(tables: KernelTables, x: torch.Tensor,
                        w_data: torch.Tensor, *,
                        scales: Optional[torch.Tensor] = None,
                        bias: Optional[torch.Tensor] = None,
                        act: Optional[str] = None,
                        save_preact: bool = False):
    """Y[e] = act(X[e] @ W_s[e]^T + bias[e]) for every expert e, in one
    launch; X (E, N, K) token-major, w_data (E, M, nnz_row) over the one
    layout of ``tables``, bias (E, M) -> Y (E, N, M).  No residual, as
    the reference's stacked kernel.

    Returns Y, or (Y, Z) with ``save_preact``.  CPU tensors run the plain
    version; CUDA tensors launch the kernel, which takes float32 or
    bfloat16 X with W and bias of the same dtype, all contiguous, and
    writes Y (and Z) in that dtype.

    The body is ``rhs_path``'s for ``N`` rows an expert: bfloat16 from
    ``MMA_MIN_TOKENS`` rows on the layouts it names runs on the tensor
    cores (counted again in ``launches_mma``), each expert's outputs the
    bits of the unstacked launch of that body on the expert's slice.

    ``scales`` (E, M/G, d_o*d_i) float32 selects the int8 path, as
    ``rbgp4mm_rhs``'s (each expert's scales at its own offset): Y only,
    no epilogue, counted in ``launches_q``.
    """
    dims = tables.dims
    _check_stacked_args(dims, x, w_data, act)
    if x.device.type == "cpu":
        return rbgp4mm_rhs_stacked_reference(tables, x, w_data,
                                             scales=scales, bias=bias,
                                             act=act,
                                             save_preact=save_preact)
    dt = x.dtype
    e, n, m = x.shape[0], x.shape[1], dims.m
    if scales is not None:
        _check_scales(dims, w_data, scales, (e,), bias=bias, act=act,
                      save_preact=save_preact)
        _check_cuda("rbgp4mm_rhs_stacked", tables, dt,
                    {"x": x, "w_data": w_data, "scales": scales},
                    {"w_data": torch.int8, "scales": torch.float32})
        out = torch.empty((e, n, m), dtype=dt, device=x.device)
        if n > 0 and e > 0:
            _launch("rbgp4mm_rhs", "rbgp4mm_rhs_stacked_q", "ipppppiiiiiiip",
                    _DTYPE_CODES[dt], x.data_ptr(), w_data.data_ptr(),
                    scales.data_ptr(), tables.col0.data_ptr(),
                    out.data_ptr(), e, n, dims.k, m, dims.d_o * dims.d_i,
                    dims.group_rows, dims.chunk_cols, x.device)
            rbgp4mm_rhs_stacked.launches_q += 1
        return out
    operands = {"x": x, "w_data": w_data}
    if bias is not None:
        operands["bias"] = bias
        if tuple(bias.shape) != (e, m):
            raise ValueError(f"bias {tuple(bias.shape)} != {(e, m)}")
    _check_cuda("rbgp4mm_rhs_stacked", tables, dt, operands)
    path = rhs_path(dims, n, dt)
    out = torch.empty((e, n, m), dtype=dt, device=x.device)
    z = torch.empty_like(out) if save_preact else None
    if n > 0 and e > 0:
        _rhs_stacked_body(path, tables, x, w_data, out, z, bias=bias,
                          act=act)
        if tables.transposed:
            rbgp4mm_rhs_stacked.launches_dx += 1
        else:
            rbgp4mm_rhs_stacked.launches += 1
        if path == "mma":
            rbgp4mm_rhs_stacked.launches_mma += 1
    return (out, z) if save_preact else out


def _rhs_stacked_body(path: str, tables: KernelTables, x: torch.Tensor,
                      w_data: torch.Tensor, out: torch.Tensor,
                      z: Optional[torch.Tensor] = None, *,
                      bias: Optional[torch.Tensor] = None,
                      act: Optional[str] = None,
                      block_tokens: Optional[int] = None) -> None:
    """Launch body ``path`` of ``rbgp4mm_rhs_stacked`` on checked CUDA
    operands (E, N > 0), writing ``out`` (and ``z``); ``block_tokens`` is
    the mma body's token tile (``stacked_mma_block_tokens``' unless given,
    to time the other).  It moves no counter, as ``_rhs_body``."""
    dims = tables.dims
    if path == "mma":
        _check_aligned16("rbgp4mm_rhs_stacked", {"x": x, "w_data": w_data})
    e, n = x.shape[0], x.shape[1]
    if block_tokens is None:
        block_tokens = stacked_mma_block_tokens(n, tables.transposed)
    _launch("rbgp4mm_rhs", "rbgp4mm_rhs_stacked", "ippppppiiiiiiiiiip",
            _DTYPE_CODES[x.dtype], x.data_ptr(), w_data.data_ptr(),
            tables.col0.data_ptr(),
            bias.data_ptr() if bias is not None else None,
            out.data_ptr(), z.data_ptr() if z is not None else None,
            e, n, dims.k, dims.m, dims.d_o * dims.d_i, dims.group_rows,
            dims.chunk_cols, _ACT_CODES[act], _PATH_CODES[path],
            block_tokens, x.device)


rbgp4mm_rhs_stacked.launches = rbgp4mm_rhs_stacked.launches_dx = 0
rbgp4mm_rhs_stacked.launches_q = rbgp4mm_rhs_stacked.launches_mma = 0


def _check_stacked_sddmm_args(dims, g, x):
    if x.ndim != 3 or g.ndim != 3 or x.shape[2] != dims.k \
            or tuple(g.shape) != (x.shape[0], x.shape[1], dims.m):
        raise ValueError(f"bad shapes g={tuple(g.shape)} x={tuple(x.shape)} "
                         f"for (E, N, M={dims.m}), (E, N, K={dims.k})")


def rbgp4_sddmm_rhs_stacked_reference(tables: KernelTables, g: torch.Tensor,
                                      x: torch.Tensor) -> torch.Tensor:
    """Plain version: batched gather + einsum in f32, written in g's
    dtype."""
    dims = tables.dims
    _check_stacked_sddmm_args(dims, g, x)
    dw = gather_sddmm_rhs_stacked(tables.adj_o, tables.adj_i,
                                  dims.n_col_tiles, dims.group_rows,
                                  dims.chunk_cols, g.float(), x.float())
    return dw.to(g.dtype)


def rbgp4_sddmm_rhs_stacked(tables: KernelTables, g: torch.Tensor,
                            x: torch.Tensor) -> torch.Tensor:
    """Stacked compact dW (E, M, d_o*d_i*C), dW[e] = pack(g[e]^T @ x[e]),
    from token-major cotangents g (E, N, M) and inputs x (E, N, K), in one
    launch for all experts; written in g's dtype.

    ``tables`` are the forward layout's kernel tables.  CPU tensors run the
    plain version; CUDA tensors launch the kernel, which takes float32 or
    bfloat16 g and x of one dtype, both contiguous.  The body is
    ``sddmm_path``'s for ``N`` rows an expert: bfloat16 from
    ``MMA_MIN_TOKENS`` rows on runs on the tensor cores with the plan
    ``stacked_sddmm_mma_plan`` names (counted again in ``launches_mma``),
    each expert's dW the bits of the unstacked launch of that body and
    plan on the expert's slice.
    """
    dims = tables.dims
    _check_stacked_sddmm_args(dims, g, x)
    if g.device.type == "cpu":
        return rbgp4_sddmm_rhs_stacked_reference(tables, g, x)
    dt = g.dtype
    _check_cuda("rbgp4_sddmm_rhs_stacked", tables, dt, {"g": g, "x": x})
    e, n = x.shape[0], x.shape[1]
    if n == 0 or e == 0:
        return torch.zeros((e, dims.m, dims.data_cols), dtype=dt,
                           device=g.device)
    dw = torch.empty((e, dims.m, dims.data_cols), dtype=dt, device=g.device)
    path = sddmm_path(dims, n, dt)
    _sddmm_stacked_body(path, tables, g, x, dw)
    rbgp4_sddmm_rhs_stacked.launches += 1
    if path == "mma":
        rbgp4_sddmm_rhs_stacked.launches_mma += 1
    return dw


def _sddmm_stacked_body(path: str, tables: KernelTables, g: torch.Tensor,
                        x: torch.Tensor, dw: torch.Tensor,
                        plan: Optional[SddmmPlan] = None) -> None:
    """Launch body ``path`` of ``rbgp4_sddmm_rhs_stacked`` on checked CUDA
    operands (E, N > 0), writing ``dw``; ``plan`` is the mma body's
    (``stacked_sddmm_mma_plan``'s unless given, to time another tile).
    It moves no counter, as ``_rhs_body``."""
    dims = tables.dims
    e, n = x.shape[0], x.shape[1]
    part = None
    if path == "mma":
        _check_aligned16("rbgp4_sddmm_rhs_stacked", {"g": g, "x": x})
        if plan is None:
            plan = stacked_sddmm_mma_plan(dims, e, n, _sm_count(g.device))
        shape = plan.workspace_shape(dims, e)
        if shape is not None:
            part = torch.empty(shape, dtype=torch.float32, device=g.device)
    else:
        plan = _NO_PLAN
    _launch("rbgp4_sddmm_rhs", "rbgp4_sddmm_rhs_stacked",
            "ipppppiiiiiiiiiiiip", _DTYPE_CODES[g.dtype], g.data_ptr(),
            x.data_ptr(), tables.col0.data_ptr(), dw.data_ptr(),
            part.data_ptr() if part is not None else None, e, n, dims.k,
            dims.m, dims.d_o * dims.d_i, dims.group_rows, dims.chunk_cols,
            _PATH_CODES[path], plan.block_cols, plan.stage_tokens,
            plan.n_slices, plan.slice_len, g.device)


rbgp4_sddmm_rhs_stacked.launches = rbgp4_sddmm_rhs_stacked.launches_mma = 0
