"""Deep-chain token-major sparse products and their plain versions.

The port of ``repro/kernels/chainmm.py``: the products of a weight in
blocked-CSR chain storage (``ChainLayout``, a chain of more than two
Ramanujan factors):

``chainmm_rhs``      Y (N, M) = X (N, K) @ W_s^T, no epilogue; run on the
                     transposed layout's tables over the permuted values,
                     it gives dX = g @ W_s;
``chain_sddmm_rhs``  the compact weight gradient dW = pack(g^T @ x) from
                     token-major g (N, M) and x (N, K).

How a chain becomes one table.  ``ChainLayout._col_index()`` is a
Kronecker mixed-radix recurrence, and the chain's trailing complete
factors come last in it, so every G consecutive rows share their column
set and every C consecutive compact slots are C consecutive input columns
(G, C: the products of the trailing complete factors' sides, the leaf
block).  The layout is therefore exactly a table ``col0 (M/G, nnz_row/C)``
of chunk starts: row ``rg*G + g`` multiplies its compact columns
``s*C .. s*C + C-1`` with input columns ``col0[rg, s] .. + C-1``.
``ChainTables.build`` checks this on the host for every entry and refuses
a layout where it fails.  The table takes the place of the TPU kernel's
scalar-prefetched head adjacency and its static unroll of the mid factors.

Row-group classes.  Whole sets of row groups share one ``col0`` row
(the complete head factor and the complete leaf give them the same column
set): tinyllama-1.1b's hierarchical-block layouts have 32, 8, 8 and 8
distinct rows among 256, 32, 352 and 64 row groups.  ``ChainTables``
keeps them as ``RowGroupClasses``: the row groups of a class together are
one dense product, Y[:, their rows] = X[:, the class's gathered columns]
@ W[their rows]^T and dW[their rows] = g[:, their rows]^T @ x[:, the
class's gathered columns], which the tensor-core bodies of
``chainmm_rhs`` and ``chain_sddmm_rhs`` run.

On a CUDA tensor each wrapper launches its hand-written kernel in
``csrc/`` (see the source notes for the designs and what bounds them); on
a CPU tensor it runs its plain version (``*_reference``).  There is no
other path: a failed build or launch raises.  Both kernels have two
device bodies, the FMA body and a bf16 tensor-core body over the classes;
``chain_rhs_path`` and ``chain_sddmm_path`` say which one a launch takes,
from dtype and shape alone (``chain_rhs_tile_rows`` the class rows of the
forward's block).  Launch counters, moved only where a kernel launches:
``chainmm_rhs.launches`` on forward tables, ``chainmm_rhs.launches_dx`` on
transposed ones, ``chainmm_rhs.launches_q`` on the int8 path, and again
in ``chainmm_rhs.launches_mma`` where the forward or dX took the
tensor-core body; ``chain_sddmm_rhs.launches``, and again in
``chain_sddmm_rhs.launches_mma`` where it took the tensor-core body.

``chainmm_rhs`` takes ``scales=`` (the int8 path of the reference's
``has_scales``): ``w_data`` then holds int8 leaf blocks and ``scales``
(M/G, n_chunks) one float32 scale per (G, C) leaf block, the table's own
(G, C), so scale column ``s`` is chunk ``s``; each block is dequantized
in float32 (``q * scale``) before the f32 sums.
"""
from __future__ import annotations

import dataclasses
import string
from typing import Optional

import numpy as np
import torch

from . import autotune
from .rbgp4mm import (_DTYPE_CODES, _NO_PLAN, _PATH_CODES, MMA_MIN_TOKENS,
                      SDDMM_MMA_WAVES, RankSlice, RowGroupClasses, SddmmPlan,
                      cut_col0,
                      _check_aligned16, _check_cuda, _launch, _pad_values,
                      _pow2_tokens,
                      _randn, _sm_count, _values, token_slices)
from .ref import dequant_leaf_blocks

__all__ = ["ChainDims", "ChainTables", "ChainTransposeTables",
           "chain_tables", "chain_transpose_tables",
           "chain_layout_cache_key", "chain_unpack_dense",
           "chain_pack_compact", "chain_ref_linear", "chain_gather_mm_rhs",
           "chain_init", "chainmm_rhs", "chainmm_rhs_reference",
           "chain_sddmm_rhs", "chain_sddmm_rhs_reference",
           "chain_sddmm_path", "chain_sddmm_mma_plan",
           "CHAIN_SDDMM_MMA_TILE"]


def chain_layout_cache_key(layout) -> tuple:
    """Content key of a layout: its spec and every factor's adjacency.
    ``transpose_layout()`` shares the forward graph sample, which a layout
    built from the transposed spec does not, so the spec alone is no key
    for anything derived from the adjacency."""
    return (layout.spec,
            tuple(np.asarray(a).tobytes() for a in layout.adjs))


def _leaf(layout) -> tuple[int, int]:
    """(G, C): the sides of the trailing run of complete factors (a
    Ramanujan factor of sparsity 0 is complete), never the head factor,
    as the reference's ``ChainDims``."""
    graphs = layout.graphs
    li = len(graphs)
    while li > 1 and graphs[li - 1].is_complete:
        li -= 1
    g = int(np.prod([gr.n_left for gr in graphs[li:]], dtype=np.int64))
    c = int(np.prod([gr.n_right for gr in graphs[li:]], dtype=np.int64))
    return g, c


@dataclasses.dataclass(frozen=True)
class ChainDims:
    """The reference's ``ChainDims`` fields that the autotuner's key and the
    perf model read (not its unrolled row groups): M, K, the head factor's
    tile (``tile_m`` x ``tile_k``) and degree ``d_head``, the stored
    columns a head slot (``inner``) and the leaf block (``leaf_rows`` x
    ``leaf_cols``), with the ``KernelDims`` aliases ``group_rows``,
    ``chunk_cols``, ``d_o`` and ``d_i``."""

    m: int
    k: int
    tile_m: int
    tile_k: int
    d_head: int
    inner: int
    leaf_rows: int
    leaf_cols: int

    @property
    def group_rows(self) -> int:
        return self.leaf_rows

    @property
    def chunk_cols(self) -> int:
        return self.leaf_cols

    @property
    def d_o(self) -> int:
        return self.d_head

    @property
    def d_i(self) -> int:
        return self.inner // self.leaf_cols

    @property
    def data_cols(self) -> int:
        return self.d_head * self.inner

    @classmethod
    def from_layout(cls, layout) -> "ChainDims":
        head = layout.graphs[0]
        d_head = int(np.asarray(layout.adjs[0]).shape[1])
        g, c = _leaf(layout)
        return cls(layout.m, layout.k, layout.m // head.n_left,
                   layout.k // head.n_right, d_head,
                   layout.nnz_per_row // d_head, g, c)


@dataclasses.dataclass(frozen=True, eq=False)
class ChainTables:
    """A chain layout's kernel table on one device: ``col0 (M/G, n_chunks)``
    int32, the input column of every (row group, chunk)'s first column,
    with the dimensions M, K, G (rows of a leaf block) and C (its
    columns), and the row-group classes (``RowGroupClasses``) of ``col0``.
    ``transposed`` marks the tables of a transposed layout (dX), whose
    launches count apart; ``dims`` are the layout's ``ChainDims`` (the
    autotuner's key).  Built once per layout and device
    (``chain_tables``) and passed to every call."""

    m: int
    k: int
    group_rows: int
    chunk_cols: int
    col0: torch.Tensor
    classes: RowGroupClasses
    transposed: bool = False
    dims: Optional[ChainDims] = None

    @property
    def n_chunks(self) -> int:
        return self.col0.shape[1]

    @property
    def data_cols(self) -> int:
        return self.n_chunks * self.chunk_cols

    @classmethod
    def build(cls, layout, device, transposed: bool = False
              ) -> "ChainTables":
        G, C = _leaf(layout)
        ci = np.asarray(layout._col_index(), np.int64)
        m, nnz = ci.shape
        if m % G or nnz % C:
            raise ValueError(f"leaf ({G}, {C}) does not tile the "
                             f"{m} x {nnz} compact layout")
        col0 = ci[::G, ::C]
        want = (col0[:, None, :, None]
                + np.arange(C, dtype=np.int64)[None, None, None, :])
        if not np.array_equal(ci.reshape(m // G, G, nnz // C, C),
                              np.broadcast_to(want, (m // G, G, nnz // C,
                                                     C))):
            raise ValueError(
                f"chain layout {layout!r}: the (row, slot) columns are not "
                f"G = {G} rows sharing C = {C} consecutive columns a chunk; "
                f"the chain kernels cannot run it")
        return cls(m, layout.k, G, C,
                   torch.as_tensor(col0, dtype=torch.int32,
                                   device=device).contiguous(),
                   RowGroupClasses.build(col0, device), transposed,
                   ChainDims.from_layout(layout))

    def rank_slice(self, kind: str, rank: int, n: int
                   ) -> Optional[RankSlice]:
        """Rank ``rank`` of ``n``'s share of this chain layout under tensor
        parallelism, or None where ``n`` does not divide the dim, as
        ``KernelTables.rank_slice``: ``kind="rows"`` keeps rows [rank*M/n,
        (rank+1)*M/n) in row groups of G' = gcd(G, M/n) rows,
        ``kind="slots"`` stored columns [rank*S*C/n, ...) in chunks of C' =
        gcd(C, S*C/n) columns (a part of a chunk starts at an offset into
        it), whose product is a partial Y from the whole X.  The share's
        row-group classes are those of its own ``col0``; each sub-group or
        sub-chunk keeps its leaf block's int8 scale (``scale_index``).  The
        unchanged ``chainmm_rhs`` runs it: it reads only ``col0``, the
        classes, G, C and the sizes."""
        cut = cut_col0(self.col0, self.group_rows, self.chunk_cols, kind,
                       rank, n)
        if cut is None:
            return None
        lo, hi, side, parent, c0 = cut
        width = hi - lo
        m, G, C = self.m, self.group_rows, self.chunk_cols
        dims = self.dims
        if kind == "rows":
            m, G = width, side
            if dims is not None:
                dims = dataclasses.replace(dims, m=width,
                                           tile_m=min(dims.tile_m, width),
                                           leaf_rows=side)
        else:
            C = side
            if dims is not None:
                chunks, d_i = width // side, dims.d_i
                d_head, inner = ((chunks // d_i, dims.inner)
                                 if side == dims.leaf_cols
                                 and chunks % d_i == 0 else (1, width))
                dims = dataclasses.replace(dims, d_head=d_head, inner=inner,
                                           leaf_cols=side)
        device = self.col0.device
        tables = ChainTables(
            m, self.k, G, C,
            torch.as_tensor(c0, dtype=torch.int32, device=device),
            RowGroupClasses.build(c0, device), self.transposed, dims)
        return RankSlice(kind, lo, hi, parent, tables)

    def col_index(self) -> torch.Tensor:
        """(M, nnz_row) int64 input column of each compact slot, on the
        table's device (the layout's ``_col_index()``)."""
        G, C = self.group_rows, self.chunk_cols
        c = torch.arange(C, dtype=torch.int64, device=self.col0.device)
        ci = self.col0.to(torch.int64)[:, None, :, None] + c
        return ci.expand(-1, G, -1, -1).reshape(self.m, self.data_cols)


@dataclasses.dataclass(frozen=True, eq=False)
class ChainTransposeTables:
    """What ``dX = g @ W_s`` needs: the tables of ``transpose_layout()``
    (never a layout of the transposed spec, which samples other graphs)
    and ``perm`` (int64, M*nnz_row), ``transpose_perm()`` on the device:
    ``values(w_data).flat == w_data.flat[perm]`` packs W^T in that
    layout."""

    tables: ChainTables
    perm: torch.Tensor
    pad: bool = False

    @classmethod
    def build(cls, layout, device) -> "ChainTransposeTables":
        lt = layout.transpose_layout()
        perm = torch.as_tensor(layout.transpose_perm(), dtype=torch.int64,
                               device=device)
        return cls(ChainTables.build(lt, device, transposed=True),
                   perm.contiguous())

    def values(self, w_data: torch.Tensor) -> torch.Tensor:
        """The compact values of W^T in the transposed layout."""
        t = self.tables
        return _pad_values(w_data.reshape(-1), self.pad).index_select(
            0, self.perm).reshape(t.m, t.data_cols)


_TABLES: dict[tuple, object] = {}


def _memo(build, layout, device):
    key = (build, chain_layout_cache_key(layout),
           str(torch.device(device)) if device is not None else "cpu")
    t = _TABLES.get(key)
    if t is None:
        t = _TABLES[key] = build(layout, device)
    return t


def chain_tables(layout, device) -> ChainTables:
    """``ChainTables.build``, memoized on the layout's content and the
    device: every layer of one layout shares one table."""
    return _memo(ChainTables.build, layout, device)


def chain_transpose_tables(layout, device) -> ChainTransposeTables:
    """``ChainTransposeTables.build``, memoized as ``chain_tables``."""
    return _memo(ChainTransposeTables.build, layout, device)


# -- plain versions ------------------------------------------------------------

def _ci(layout, device) -> torch.Tensor:
    return torch.as_tensor(layout._col_index(), dtype=torch.int64,
                           device=device)


def chain_unpack_dense(layout, w_data: torch.Tensor) -> torch.Tensor:
    """Scatter compact Wdata (M, nnz_row) to dense (M, K), zeros off-mask."""
    dense = torch.zeros((layout.m, layout.k), dtype=w_data.dtype,
                        device=w_data.device)
    return dense.scatter_(1, _ci(layout, w_data.device),
                          w_data.reshape(layout.m, -1))


def chain_pack_compact(layout, w_dense: torch.Tensor) -> torch.Tensor:
    """Gather the masked values of dense (M, K) into compact (M, nnz_row)."""
    return torch.gather(w_dense, 1, _ci(layout, w_dense.device))


def chain_ref_linear(layout, w_data: torch.Tensor,
                     x: torch.Tensor) -> torch.Tensor:
    """Y = X @ W_s^T through the scattered dense weight: the reference's
    own execution path off the TPU (equal to its masked backend)."""
    lead = x.shape[:-1]
    y = x.reshape(-1, layout.k) @ chain_unpack_dense(layout, w_data).T
    return y.reshape(*lead, layout.m)


def chain_gather_mm_rhs(layout, w_data: torch.Tensor,
                        x: torch.Tensor) -> torch.Tensor:
    """Y = X @ W_s^T from compact storage through per-factor gathers and
    one einsum, never forming the dense weight (the reference's oracle):
    X is reshaped to the chain's column mixed radix, gathered once per
    factor with its adjacency, and contracted against the values reshaped
    to (rows..., slots...).  Its gathered input grows with the product of
    the factors' degrees: a test-size path."""
    graphs, adjs = layout.graphs, layout.adjs
    nf = len(graphs)
    if 1 + 2 * nf + nf > len(string.ascii_lowercase):
        raise ValueError(f"chain too deep for the einsum path ({nf} factors)")
    lead = x.shape[:-1]
    xt = x.reshape((-1,) + tuple(g.n_right for g in graphs))
    for j, adj in enumerate(adjs):
        # factor j's column axis (at 1 + 2j) becomes its (n_left, d) pair
        idx = torch.as_tensor(np.asarray(adj), dtype=torch.int64,
                              device=x.device)
        xt = xt.movedim(1 + 2 * j, -1)[..., idx].movedim(-2, 1 + 2 * j)
        xt = xt.movedim(-1, 2 + 2 * j)
    letters = iter(string.ascii_lowercase)
    tok = next(letters)
    rs = [next(letters) for _ in range(nf)]
    ds = [next(letters) for _ in range(nf)]
    x_sub = tok + "".join(r + d for r, d in zip(rs, ds))
    w_sub = "".join(rs) + "".join(ds)
    out_sub = tok + "".join(rs)
    w = w_data.reshape(tuple(g.n_left for g in graphs)
                       + tuple(np.asarray(a).shape[1] for a in adjs))
    y = torch.einsum(f"{x_sub},{w_sub}->{out_sub}", xt, w)
    return y.reshape(*lead, layout.m)


def chain_init(layout, *, generator: Optional[torch.Generator] = None,
               device=None, dtype=torch.float32,
               scale: Optional[float] = None) -> torch.Tensor:
    """He init over the present connections: every row's fan-in is
    ``nnz_per_row`` (row-uniformity of the product mask)."""
    scale = scale if scale is not None else (2.0 / layout.nnz_per_row) ** 0.5
    w = torch.randn(layout.data_shape, generator=generator, device=device,
                    dtype=torch.float32) * scale
    return w.to(dtype)


def _gather_chunks(tables: ChainTables, x: torch.Tensor) -> torch.Tensor:
    """(N, M/G, n_chunks, C): the input columns each compact slot
    multiplies (every chunk start is a multiple of C)."""
    C = tables.chunk_cols
    chunk = (tables.col0 // C).to(torch.int64)
    return x.reshape(x.shape[0], tables.k // C, C)[:, chunk, :]


def _check_args(tables: ChainTables, x, w_data):
    if tuple(w_data.shape) != (tables.m, tables.data_cols):
        raise ValueError(f"w_data {tuple(w_data.shape)} != "
                         f"{(tables.m, tables.data_cols)}")
    if x.ndim != 2 or x.shape[1] != tables.k:
        raise ValueError(f"x {tuple(x.shape)} is not (N, K={tables.k})")


def _check_scales(tables: ChainTables, w_data, scales):
    want = (tables.m // tables.group_rows, tables.n_chunks)
    if tuple(scales.shape) != want:
        raise ValueError(f"scales {tuple(scales.shape)} != {want}")
    if w_data.dtype != torch.int8:
        raise TypeError(f"with scales, w_data holds int8 leaf blocks, got "
                        f"{w_data.dtype}")


def chainmm_rhs_reference(tables: ChainTables, x: torch.Tensor,
                          w_data: torch.Tensor, *,
                          scales: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Plain version: gather of the chunks + einsum, f32 sums, written in
    the dtype of X.  With ``scales``, int8 ``w_data`` is dequantized in
    f32 first."""
    _check_args(tables, x, w_data)
    if scales is None:
        w32 = w_data.float()
    else:
        _check_scales(tables, w_data, scales)
        w32 = dequant_leaf_blocks(w_data, scales, tables.group_rows,
                                  tables.chunk_cols)
    xg = _gather_chunks(tables, x.float())
    n, r, s, c = xg.shape
    w = w32.reshape(r, tables.group_rows, s, c)
    y = torch.einsum("nrsc,rgsc->nrg", xg, w)
    return y.reshape(n, tables.m).to(x.dtype)


# -- which body a forward or dX launch takes ---------------------------------

#: tokens a block of the forward's tensor-core body
CHAIN_RHS_MMA_BLOCK_TOKENS = 128


def chain_rhs_path(tables: ChainTables, n_tokens: int,
                   dtype: torch.dtype) -> str:
    """``"mma"`` or ``"fma"``: the body a launch of ``chainmm_rhs`` (the
    forward, or dX on transposed tables) takes for ``n_tokens`` rows of X
    of ``dtype`` on ``tables``.  The tensor-core body takes bfloat16 at
    ``n_tokens >= MMA_MIN_TOKENS`` with G, C and K multiples of 8 (every
    gather a 16-byte copy, every eight class rows one row group's);
    float32 (no TF32), decode (8 rows) and the small leaves (G = C = 1, 2)
    keep the FMA body, and so does the int8 path, which has no other."""
    if (dtype != torch.bfloat16 or n_tokens < MMA_MIN_TOKENS
            or tables.group_rows % 8 or tables.chunk_cols % 8
            or tables.k % 8):
        return "fma"
    return "mma"


def chain_rhs_tile_rows(tables: ChainTables) -> int:
    """Class rows a block of the forward's tensor-core body: 32 where the
    largest class has no more (tinyllama-1.1b's wk/wv forward table, 8
    classes of 32 rows, which a 64-row tile would leave half empty), else
    64 (the other tables' classes of 64, 256 and 704 rows)."""
    if tables.classes.max_groups * tables.group_rows <= 32:
        return 32
    return 64


def chainmm_rhs(tables: ChainTables, x: torch.Tensor,
                w_data: torch.Tensor, *,
                scales: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Y = X @ W_s^T; X (N, K) token-major -> Y (N, M), from chain storage
    ``w_data`` (M, nnz_row).

    CPU tensors run the plain version; CUDA tensors launch the kernel,
    which takes float32 or bfloat16 X and W of one dtype, both contiguous,
    sums in float32 and writes Y in that dtype, on the body
    ``chain_rhs_path`` names (the tensor-core one counted again in
    ``launches_mma``).  ``scales`` (M/G, n_chunks) float32 selects the
    int8 path (int8 ``w_data``, its own kernel, counted in
    ``launches_q``).  The tensor-core body's class rows are the tile
    ``autotune.launch_tile`` resolves (kind ``chain_rhs``; by default
    ``chain_rhs_tile_rows``').
    """
    _check_args(tables, x, w_data)
    n = x.shape[0]
    vdt = torch.int8 if scales is not None else None
    if x.device.type == "cpu":
        if n:
            autotune.launch_tile(tables, "chain_rhs", n, x.dtype, vdt)
        return chainmm_rhs_reference(tables, x, w_data, scales=scales)
    dt = x.dtype
    if scales is not None:
        _check_scales(tables, w_data, scales)
        _check_cuda("chainmm_rhs", tables, dt,
                    {"x": x, "w_data": w_data, "scales": scales},
                    {"w_data": torch.int8, "scales": torch.float32})
        out = torch.empty((n, tables.m), dtype=dt, device=x.device)
        if n > 0:
            autotune.launch_tile(tables, "chain_rhs", n, dt, vdt)
            _chain_rhs_q_body(tables, x, w_data, scales, out)
            chainmm_rhs.launches_q += 1
        return out
    _check_cuda("chainmm_rhs", tables, dt, {"x": x, "w_data": w_data})
    out = torch.empty((n, tables.m), dtype=dt, device=x.device)
    if n > 0:
        path = chain_rhs_path(tables, n, dt)
        tile = autotune.launch_tile(tables, "chain_rhs", n, dt).tile
        _chain_rhs_body(path, tables, x, w_data, out, (tile or (None,))[0])
        if tables.transposed:
            chainmm_rhs.launches_dx += 1
        else:
            chainmm_rhs.launches += 1
        if path == "mma":
            chainmm_rhs.launches_mma += 1
    return out


def _chain_rhs_body(path: str, tables: ChainTables, x: torch.Tensor,
                    w_data: torch.Tensor, out: torch.Tensor,
                    tile_rows: Optional[int] = None) -> None:
    """Launch body ``path`` ("fma" or "mma") of ``chainmm_rhs`` on checked
    CUDA operands of one dtype (N > 0), writing ``out``; ``tile_rows`` are
    the mma body's class rows (``chain_rhs_tile_rows``' unless given).  It
    moves no counter: a launch of the other body on the same operands is a
    comparison."""
    cl = tables.classes
    if tile_rows is None:
        tile_rows = chain_rhs_tile_rows(tables)
    if path == "mma":
        _check_aligned16("chainmm_rhs", {"x": x, "w_data": w_data})
    _launch("chainmm_rhs", "chainmm_rhs", "ipppppppiiiiiiiiiip",
            _DTYPE_CODES[x.dtype], x.data_ptr(), w_data.data_ptr(),
            tables.col0.data_ptr(), cl.col0.data_ptr(), cl.groups.data_ptr(),
            cl.start.data_ptr(), out.data_ptr(), x.shape[0], tables.k,
            tables.m, tables.n_chunks, tables.group_rows, tables.chunk_cols,
            cl.n_classes, cl.max_groups, _PATH_CODES[path], tile_rows,
            x.device)


def _chain_rhs_q_body(tables: ChainTables, x: torch.Tensor,
                      w_data: torch.Tensor, scales: torch.Tensor,
                      out: torch.Tensor) -> None:
    """Launch the int8 path of ``chainmm_rhs`` on checked CUDA operands
    (N > 0), writing ``out``.  It moves no counter."""
    _launch("chainmm_rhs", "chainmm_rhs_q", "ipppppiiiiiip",
            _DTYPE_CODES[x.dtype], x.data_ptr(), w_data.data_ptr(),
            scales.data_ptr(), tables.col0.data_ptr(), out.data_ptr(),
            x.shape[0], tables.k, tables.m, tables.n_chunks,
            tables.group_rows, tables.chunk_cols, x.device)


chainmm_rhs.launches = chainmm_rhs.launches_dx = chainmm_rhs.launches_q = 0
chainmm_rhs.launches_mma = 0


def _check_sddmm_args(tables: ChainTables, g, x):
    n = x.shape[0]
    if x.ndim != 2 or g.ndim != 2 or tuple(g.shape) != (n, tables.m) \
            or x.shape[1] != tables.k:
        raise ValueError(f"bad shapes g={tuple(g.shape)} x={tuple(x.shape)} "
                         f"for M={tables.m}, K={tables.k}")


def chain_sddmm_rhs_reference(tables: ChainTables, g: torch.Tensor,
                              x: torch.Tensor) -> torch.Tensor:
    """Plain version: gather of the chunks + einsum, f32 sums, written in
    g's dtype."""
    _check_sddmm_args(tables, g, x)
    xg = _gather_chunks(tables, x.float())
    n, r, s, c = xg.shape
    gg = g.float().reshape(n, r, tables.group_rows)
    dw = torch.einsum("nrsc,nrg->rgsc", xg, gg)
    return dw.reshape(tables.m, tables.data_cols).to(g.dtype)


# -- which body a dW launch takes ---------------------------------------------

#: rows and columns of a block tile of the dW tensor-core body
CHAIN_SDDMM_MMA_TILE = 64
#: tokens a stage of that body, the unit of its token slices
CHAIN_SDDMM_MMA_STAGE_TOKENS = 32


def chain_sddmm_path(tables: ChainTables, n_tokens: int,
                     dtype: torch.dtype) -> str:
    """``"mma"`` or ``"fma"``: the body a launch of ``chain_sddmm_rhs``
    takes for ``n_tokens`` tokens of ``dtype`` on ``tables``.  The
    tensor-core body takes bfloat16 at ``n_tokens >= MMA_MIN_TOKENS`` with
    G, C and K multiples of 8 (so M too), every gather then a 16-byte
    copy; float32 (no TF32) and the small leaves (G = C = 1, 2) keep the
    FMA body."""
    if (dtype != torch.bfloat16 or n_tokens < MMA_MIN_TOKENS
            or tables.group_rows % 8 or tables.chunk_cols % 8
            or tables.k % 8):
        return "fma"
    return "mma"


#: waves of blocks the token slices of the dW tensor-core body may bring
#: its grid to (the autotuner's candidates; the rule's is
#: ``SDDMM_MMA_WAVES``)
CHAIN_SDDMM_WAVES = (1, 2, 4)


def chain_sddmm_mma_plan(tables: ChainTables, n_tokens: int,
                         sm_count: int,
                         waves: int = SDDMM_MMA_WAVES) -> SddmmPlan:
    """The tensor-core body's plan on a card of ``sm_count`` SMs: a
    ``CHAIN_SDDMM_MMA_TILE``-square tile of a class's rows by its stored
    columns a block, every class given the row tiles of the largest, cut
    into token slices as ``token_slices`` says for ``waves`` waves
    (wk/wv and wq/wo of tinyllama-1.1b at 4096 tokens: 32 and 128 blocks a
    slice)."""
    t = CHAIN_SDDMM_MMA_TILE
    cl = tables.classes
    base = (cl.n_classes * -(-cl.max_groups * tables.group_rows // t)
            * -(-tables.data_cols // t))
    return token_slices(t, base, n_tokens, sm_count,
                        CHAIN_SDDMM_MMA_STAGE_TOKENS, waves)


def chain_sddmm_rhs(tables: ChainTables, g: torch.Tensor,
                    x: torch.Tensor) -> torch.Tensor:
    """Compact dW (M, nnz_row) = pack(g^T @ x) from token-major cotangent
    g (N, M) and input x (N, K), in g's dtype.

    ``tables`` are the forward layout's.  CPU tensors run the plain
    version; CUDA tensors launch the kernel, which takes float32 or
    bfloat16 g and x of one dtype, both contiguous, on the body
    ``chain_sddmm_path`` names (the tensor-core one counted again in
    ``launches_mma``, with the token slices of the tile
    ``autotune.launch_tile`` resolves, kind ``chain_sddmm``: by default
    ``SDDMM_MMA_WAVES`` waves).
    """
    _check_sddmm_args(tables, g, x)
    n = x.shape[0]
    if g.device.type == "cpu":
        if n:
            autotune.launch_tile(tables, "chain_sddmm", n, g.dtype)
        return chain_sddmm_rhs_reference(tables, g, x)
    dt = g.dtype
    _check_cuda("chain_sddmm_rhs", tables, dt, {"g": g, "x": x})
    if n == 0:
        return torch.zeros((tables.m, tables.data_cols), dtype=dt,
                           device=g.device)
    dw = torch.empty((tables.m, tables.data_cols), dtype=dt, device=g.device)
    path = chain_sddmm_path(tables, n, dt)
    tune = autotune.launch_tile(tables, "chain_sddmm", n, dt)
    plan = (chain_sddmm_mma_plan(tables, n, _sm_count(g.device),
                                 tune.tile[1]) if path == "mma" else None)
    _chain_sddmm_body(path, tables, g, x, dw, plan)
    chain_sddmm_rhs.launches += 1
    if path == "mma":
        chain_sddmm_rhs.launches_mma += 1
    return dw


def _chain_sddmm_body(path: str, tables: ChainTables, g: torch.Tensor,
                      x: torch.Tensor, dw: torch.Tensor,
                      plan: Optional[SddmmPlan] = None) -> None:
    """Launch body ``path`` ("fma" or "mma") of ``chain_sddmm_rhs`` on
    checked CUDA operands of one dtype (N > 0), writing ``dw``; the mma
    body's token-slice workspace is allocated here, for ``plan``
    (``chain_sddmm_mma_plan``'s unless given).  It moves no counter: a
    launch of the other body on the same operands is a comparison."""
    n = x.shape[0]
    cl = tables.classes
    part = None
    if path == "mma":
        _check_aligned16("chain_sddmm_rhs", {"g": g, "x": x})
        if plan is None:
            plan = chain_sddmm_mma_plan(tables, n, _sm_count(g.device))
        shape = plan.workspace_shape(tables)
        if shape is not None:
            part = torch.empty(shape, dtype=torch.float32, device=g.device)
    else:
        plan = _NO_PLAN
    _launch("chain_sddmm_rhs", "chain_sddmm_rhs", "ippppppppiiiiiiiiiiip",
            _DTYPE_CODES[g.dtype], g.data_ptr(), x.data_ptr(),
            tables.col0.data_ptr(), cl.col0.data_ptr(), cl.groups.data_ptr(),
            cl.start.data_ptr(), dw.data_ptr(),
            part.data_ptr() if part is not None else None, n, tables.k,
            tables.m, tables.n_chunks, tables.group_rows, tables.chunk_cols,
            cl.n_classes, cl.max_groups, _PATH_CODES[path], plan.n_slices,
            plan.slice_len, g.device)


chain_sddmm_rhs.launches = chain_sddmm_rhs.launches_mma = 0


# -- the autotuner's kinds (``kernels/autotune.py``) ----------------------------

def _chain_operands(tables, n, e, dtype, value_dtype, gen) -> dict:
    dev = tables.col0.device
    ops = _values(tables.dims, (), dtype, value_dtype, gen, dev)
    ops["x"] = _randn(gen, (n, tables.k), dtype, dev)
    ops["out"] = torch.empty((n, tables.m), dtype=dtype, device=dev)
    return ops


def _chain_dw_operands(tables, n, e, dtype, value_dtype, gen) -> dict:
    dev = tables.col0.device
    return {"g": _randn(gen, (n, tables.m), dtype, dev),
            "x": _randn(gen, (n, tables.k), dtype, dev),
            "dw": torch.empty((tables.m, tables.data_cols), dtype=dtype,
                              device=dev)}


def _launch_chain_rhs(tables, body, tile, ops) -> None:
    if body == "q":
        _chain_rhs_q_body(tables, ops["x"], ops["w"], ops["scales"],
                          ops["out"])
    else:
        _chain_rhs_body(body, tables, ops["x"], ops["w"], ops["out"],
                        (tile or (None,))[0])


def _launch_chain_sddmm(tables, body, tile, ops) -> None:
    n = ops["x"].shape[0]
    plan = (chain_sddmm_mma_plan(tables, n, _sm_count(ops["x"].device),
                                 tile[1]) if body == "mma" else None)
    _chain_sddmm_body(body, tables, ops["g"], ops["x"], ops["dw"], plan)


def _chain_dw_block_n(tables, tile, n, e) -> int:
    if not tile:
        return n
    return chain_sddmm_mma_plan(tables, n, _sm_count(tables.col0.device),
                                tile[1]).slice_len


autotune.register_kind(autotune.KindSpec(
    name="chain_rhs", path=chain_rhs_path,
    rule=lambda tables, n: (chain_rhs_tile_rows(tables),),
    tiles=lambda tables: ((32,), (64,)),
    block_n=lambda tables, tile, n, e: (CHAIN_RHS_MMA_BLOCK_TOKENS if tile
                                        else _pow2_tokens(n)),
    operands=_chain_operands, launch=_launch_chain_rhs))
autotune.register_kind(autotune.KindSpec(
    name="chain_sddmm", path=chain_sddmm_path,
    rule=lambda tables, n: (CHAIN_SDDMM_MMA_TILE, SDDMM_MMA_WAVES),
    tiles=lambda tables: tuple((CHAIN_SDDMM_MMA_TILE, w)
                               for w in CHAIN_SDDMM_WAVES),
    block_n=_chain_dw_block_n,
    operands=_chain_dw_operands, launch=_launch_chain_sddmm))
