"""RBGP4 sparsity pattern: spec, compact layout, auto-designer (paper §5).

A copy of the RBGP4 part of ``repro/core/rbgp.py`` (pure numpy), kept in
this package so the port loads nothing of the JAX package.  The graph
sampling, the adjacency lists and the compact slot order are unchanged, so
a layout built here has exactly the masks and ``Wdata`` order of the
reference.  The same holds for the deep-chain part: ``FactorSpec``,
``RBGPSpec``, ``design_rbgp`` and ``ChainLayout``, the paper's general
product of Ramanujan and complete factors, of which RBGP4 is one instance.

RBGP4 composes four biregular bipartite graphs ``G = G_o (x) G_r (x) G_i (x) G_b``
with ``G_o`` and ``G_i`` sparse Ramanujan graphs and ``G_r``, ``G_b`` complete,
in the *i-major* ordering ``G = G_o (x) G_i (x) G_rb``: every repetition
group is a contiguous dense ``(G, C)`` block.

Resulting structure = two-level block sparsity:
  * outer: tiles of size ``(TM, TK) = (U_i*G, V_i*C)`` with pattern ``BA_o``
    (``d_o`` non-zero tiles per tile-row),
  * inner: dense ``(G, C)`` blocks with the *shared* pattern ``BA_i``.

Compact value storage: ``Wdata`` of shape ``(M, d_o * d_i * C)`` — slot
``(ko, ki)`` of row ``r`` holds the values of the ``ki``-th non-zero inner
block within the ``ko``-th non-zero outer tile of ``r``'s tile-row.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional

import numpy as np

from .graphs import complete_bipartite, generate_ramanujan
from .product import ProductStructure

__all__ = [
    "RBGP4Spec", "RBGP4Layout", "design_rbgp4", "pow2_sparsity_steps",
    "FactorSpec", "RBGPSpec", "design_rbgp", "canonicalize_factors",
    "ChainLayout", "rbgp_from_rbgp4", "AUTO", "AUTO_SP",
]


def _v2(x: int) -> int:
    """2-adic valuation."""
    if x <= 0:
        return 0
    v = 0
    while x % 2 == 0:
        x //= 2
        v += 1
    return v


def pow2_sparsity_steps(sparsity: float) -> int:
    """k such that sparsity == 1 - 2^-k, or raise."""
    if sparsity == 0.0:
        return 0
    dens = 1.0 - sparsity
    k = math.log2(1.0 / dens)
    if abs(k - round(k)) > 1e-9:
        raise ValueError(f"sparsity must be 1 - 2^-k, got {sparsity}")
    return round(k)


@dataclasses.dataclass(frozen=True)
class RBGP4Spec:
    """Static configuration of an RBGP4 pattern for an (M, K) weight matrix.

    Sizes are (left, right) = (rows, cols) of each factor's biadjacency.
    ``g_r``/``g_b`` are complete; ``sp_o``/``sp_i`` are of the form 1-2^-k.
    """

    g_o: tuple[int, int]
    g_r: tuple[int, int]
    g_i: tuple[int, int]
    g_b: tuple[int, int]
    sp_o: float = 0.0
    sp_i: float = 0.0
    seed: int = 0

    @property
    def m(self) -> int:
        return self.g_o[0] * self.g_r[0] * self.g_i[0] * self.g_b[0]

    @property
    def k(self) -> int:
        return self.g_o[1] * self.g_r[1] * self.g_i[1] * self.g_b[1]

    @property
    def group_rows(self) -> int:  # G: rows per repetition group
        return self.g_r[0] * self.g_b[0]

    @property
    def chunk_cols(self) -> int:  # C: cols per inner dense block
        return self.g_r[1] * self.g_b[1]

    @property
    def tile_m(self) -> int:  # TM
        return self.g_i[0] * self.group_rows

    @property
    def tile_k(self) -> int:  # TK
        return self.g_i[1] * self.chunk_cols

    @property
    def d_o(self) -> int:  # non-zero tiles per tile-row
        return round((1.0 - self.sp_o) * self.g_o[1])

    @property
    def d_i(self) -> int:  # non-zero inner blocks per group-row
        return round((1.0 - self.sp_i) * self.g_i[1])

    @property
    def sparsity(self) -> float:
        return 1.0 - (1.0 - self.sp_o) * (1.0 - self.sp_i)

    @property
    def nnz_per_row(self) -> int:
        return self.d_o * self.d_i * self.chunk_cols

    @property
    def nnz(self) -> int:
        return self.m * self.nnz_per_row

    def validate(self) -> None:
        ko = pow2_sparsity_steps(self.sp_o)
        ki = pow2_sparsity_steps(self.sp_i)
        for (name, (nl, nr), kk) in (
            ("g_o", self.g_o, ko),
            ("g_i", self.g_i, ki),
        ):
            if min(_v2(nl), _v2(nr)) < kk:
                raise ValueError(
                    f"{name}={nl}x{nr} cannot carry sparsity 1-2^-{kk} "
                    f"(insufficient 2-adic valuation)"
                )
        if self.d_o < 1:
            raise ValueError("G_o degree would be < 1")
        if self.d_i < 1:
            raise ValueError("G_i degree would be < 1")

    def transpose(self) -> "RBGP4Spec":
        sw = lambda t: (t[1], t[0])
        return RBGP4Spec(
            g_o=sw(self.g_o), g_r=sw(self.g_r), g_i=sw(self.g_i),
            g_b=sw(self.g_b), sp_o=self.sp_o, sp_i=self.sp_i, seed=self.seed,
        )


class RBGP4Layout:
    """Concrete RBGP4 pattern: sampled Ramanujan factors + compact layout.

    Deterministic given (spec, seed): factor graphs are sampled with seeds
    derived from ``spec.seed``, so every process rebuilds the same masks
    from the spec alone.
    """

    def __init__(self, spec: RBGP4Spec):
        spec.validate()
        self.spec = spec
        self.graph_o = generate_ramanujan(
            spec.g_o[0], spec.g_o[1], spec.sp_o, seed=spec.seed * 2 + 1
        )
        self.graph_i = generate_ramanujan(
            spec.g_i[0], spec.g_i[1], spec.sp_i, seed=spec.seed * 2 + 2
        )
        self.graph_r = complete_bipartite(*spec.g_r)
        self.graph_b = complete_bipartite(*spec.g_b)
        self.adj_o = self.graph_o.left_adjacency()  # (n_o_l, d_o)
        self.adj_i = self.graph_i.left_adjacency()  # (U_i, d_i)

    # equality/hash by spec: two reconstructions are interchangeable
    def __eq__(self, other) -> bool:
        return isinstance(other, RBGP4Layout) and self.spec == other.spec

    def __hash__(self) -> int:
        return hash(self.spec)

    @property
    def m(self) -> int:
        return self.spec.m

    @property
    def k(self) -> int:
        return self.spec.k

    @property
    def data_shape(self) -> tuple[int, int]:
        """Compact value storage shape (M, d_o * d_i * C)."""
        return (self.spec.m, self.spec.nnz_per_row)

    def product_structure(self) -> ProductStructure:
        g_rb = complete_bipartite(self.spec.group_rows, self.spec.chunk_cols)
        return ProductStructure((self.graph_o, self.graph_i, g_rb))

    def mask(self) -> np.ndarray:
        """Dense {0,1} uint8 mask (i-major ordering), shape (M, K)."""
        return self.product_structure().mask()

    def _col_index(self) -> np.ndarray:
        """(M, d_o*d_i*C) int32: dense column of each compact slot."""
        sp = self.spec
        C = sp.chunk_cols
        rows = np.arange(sp.m)
        uo = rows // sp.tile_m
        ui = (rows % sp.tile_m) // sp.group_rows
        tile_base = self.adj_o[uo] * sp.tile_k  # (M, d_o)
        blk_base = self.adj_i[ui] * C  # (M, d_i)
        col = (
            tile_base[:, :, None, None]
            + blk_base[:, None, :, None]
            + np.arange(C)[None, None, None, :]
        )  # (M, d_o, d_i, C)
        return col.reshape(sp.m, -1).astype(np.int32)

    def pack(self, w_dense: np.ndarray) -> np.ndarray:
        """Gather the masked values of a dense (M, K) matrix into Wdata."""
        if w_dense.shape != (self.m, self.k):
            raise ValueError(f"expected {(self.m, self.k)}, got {w_dense.shape}")
        return np.take_along_axis(w_dense, self._col_index(), axis=1)

    def unpack(self, w_data: np.ndarray) -> np.ndarray:
        """Scatter compact Wdata back to a dense (M, K) matrix (zeros off-mask)."""
        if w_data.shape != self.data_shape:
            raise ValueError(f"expected {self.data_shape}, got {w_data.shape}")
        out = np.zeros((self.m, self.k), dtype=w_data.dtype)
        np.put_along_axis(out, self._col_index(), w_data, axis=1)
        return out

    def transpose_layout(self) -> "RBGP4Layout":
        """Layout of W^T (factors transposed). Shares graph samples."""
        lt = RBGP4Layout.__new__(RBGP4Layout)
        lt.spec = self.spec.transpose()
        lt.graph_o = self.graph_o.transpose()
        lt.graph_i = self.graph_i.transpose()
        lt.graph_r = self.graph_r.transpose()
        lt.graph_b = self.graph_b.transpose()
        lt.adj_o = lt.graph_o.left_adjacency()
        lt.adj_i = lt.graph_i.left_adjacency()
        return lt

    def transpose_perm(self) -> np.ndarray:
        """perm such that WdataT.flat = Wdata.flat[perm]."""
        return _slot_transpose_perm(
            self._col_index(), self.transpose_layout()._col_index(),
            self.m, self.k,
        )

    def memory_bytes(self, value_bytes: int = 4, index_bytes: int = 4) -> dict:
        sp = self.spec
        values = sp.nnz * value_bytes
        succinct_index = (
            self.graph_o.n_edges
            + self.graph_i.n_edges
            + self.graph_r.n_edges
            + self.graph_b.n_edges
        ) * index_bytes
        full_index = sp.nnz * index_bytes
        return {
            "values": values,
            "index_succinct": succinct_index,
            "index_full": full_index,
            "total": values + succinct_index,
            "index_compression": full_index / max(succinct_index, 1),
        }

    def __repr__(self) -> str:  # pragma: no cover
        sp = self.spec
        return (
            f"RBGP4Layout({sp.m}x{sp.k} sp={sp.sparsity:.4f} "
            f"o={sp.g_o}@{sp.sp_o} i={sp.g_i}@{sp.sp_i} "
            f"G={sp.group_rows} C={sp.chunk_cols} TM={sp.tile_m} TK={sp.tile_k})"
        )


def _slot_transpose_perm(ci: np.ndarray, ci_t: np.ndarray,
                         m: int, k: int) -> np.ndarray:
    """perm such that WdataT.flat = Wdata.flat[perm] for compact layouts.

    ``ci`` is the forward layout's (M, nnz_row) dense-column index; ``ci_t``
    the transposed layout's (K, nnz_col) index (its values are *rows* of W).
    Both enumerate the same nnz set, so matching flat dense ids
    ``r * K + c`` yields the slot permutation.
    """
    fwd_ids = (np.arange(m, dtype=np.int64)[:, None] * k
               + ci.astype(np.int64)).ravel()
    t_ids = (ci_t.astype(np.int64) * k
             + np.arange(k, dtype=np.int64)[:, None]).ravel()
    order = np.argsort(fwd_ids, kind="stable")
    pos = np.searchsorted(fwd_ids[order], t_ids)
    perm = order[pos]
    assert (fwd_ids[perm] == t_ids).all()
    return perm.astype(np.int64)


# ---------------------------------------------------------------------------
# Auto-designer: pick factor sizes for an arbitrary (M, K, sparsity) layer.
# ---------------------------------------------------------------------------

def _pow2_divisors(x: int, cap: int) -> list[int]:
    out = []
    g = 1
    while x % g == 0 and g <= cap:
        out.append(g)
        g *= 2
    return out


def _cap_steps(a: int, b: int, min_deg: int) -> int:
    """Max sparsity steps a (a, b)-sided factor can carry: 2-adic feasibility
    of the 2-lift construction + both degrees staying >= min_deg."""
    cap = min(_v2(a), _v2(b))
    while cap > 0 and ((b >> cap) < min_deg or (a >> cap) < min_deg):
        cap -= 1
    return cap


@functools.lru_cache(maxsize=4096)
def design_rbgp4(
    m: int,
    k: int,
    sparsity: float,
    *,
    group_rows: int = 16,
    chunk_cols: int = 128,
    target_ui: int = 8,
    target_vi: int = 4,
    prefer_outer_sparsity: bool = True,
    seed: int = 0,
) -> RBGP4Spec:
    """RBGP4 factorization of an (m, k) weight matrix.

    The scoring is the reference's, unchanged (it was tuned for the TPU's
    sublanes and lanes): a factorization tuned for Hopper would change the
    masks and break parity with the reference.  It scores every
    power-of-two allocation ``m = n_o_l * U_i * G`` / ``k = n_o_r * V_i * C``
    (odd parts land in G_o) and picks the feasible one maximizing

      score = u_rows(G) * u_contract(d_i*C) * I-reuse(TM) ,

    with graph quality (every sparse factor a proper expander) ranked first.
    """
    k_total = pow2_sparsity_steps(sparsity)
    tm_target = 8 * group_rows * target_ui

    best = None
    best_score = (-1, -1.0)
    for G in _pow2_divisors(m, 64):
        for U_i in _pow2_divisors(m // G, 64):
            n_o_l = m // (G * U_i)
            for C in _pow2_divisors(k, 256):
                for V_i in _pow2_divisors(k // C, 64):
                    n_o_r = k // (C * V_i)
                    for min_deg in (2, 1):
                        cap_o = _cap_steps(n_o_l, n_o_r, min_deg)
                        cap_i = _cap_steps(U_i, V_i, min_deg)
                        if cap_o + cap_i >= k_total:
                            break
                    else:
                        continue
                    if prefer_outer_sparsity:
                        ko = min(k_total, cap_o)
                        ki = k_total - ko
                    else:
                        ki = min(k_total, cap_i)
                        ko = k_total - ki
                    d_o = n_o_r >> ko
                    d_i = V_i >> ki
                    quality = (
                        int((ko == 0 or (d_o >= 2 and n_o_l >= 4
                                         and n_o_r >= 4)))
                        + int((ki == 0 or (d_i >= 2 and U_i >= 4
                                           and V_i >= 4)))
                    )
                    u_rows = G / (((G + 15) // 16) * 16)
                    u_k = min(d_i * C, 128) / 128.0
                    tm = U_i * G
                    reuse = min(tm, tm_target) / tm_target
                    pref = 1.0 - 0.01 * (abs(_v2(G) - _v2(group_rows))
                                         + abs(_v2(C) - _v2(chunk_cols)))
                    score = (quality,
                             u_rows * u_k * (0.5 + 0.5 * reuse) * pref)
                    if score > best_score:
                        best_score = score
                        best = (n_o_l, n_o_r, U_i, V_i, G, C, ko, ki)
    if best is None:
        raise ValueError(
            f"cannot realize sparsity {sparsity} for {m}x{k}"
        )
    n_o_l, n_o_r, U_i, V_i, G, C, ko, ki = best
    # G_r carries the row-repetition; G_b the dense element block (their
    # product is what matters to the layout)
    b_u = min(G, 8)
    b_v = min(C, 8)
    spec = RBGP4Spec(
        g_o=(n_o_l, n_o_r),
        g_r=(G // b_u, C // b_v),
        g_i=(U_i, V_i),
        g_b=(b_u, b_v),
        sp_o=1.0 - 2.0 ** (-ko),
        sp_i=1.0 - 2.0 ** (-ki),
        seed=seed,
    )
    spec.validate()
    assert spec.m == m and spec.k == k, (spec.m, spec.k, m, k)
    return spec


class ChainLayout:
    """Concrete deep product chain: sampled factors + blocked-CSR layout.

    The compact executor's view of an :class:`RBGPSpec` with more than two
    sparse factors (shallower chains canonicalize onto :class:`RBGP4Layout`
    instead).  Storage is a generalized blocked CSR:

      * **row pointers are implicit** — every product row has exactly
        ``nnz_per_row = prod d_j`` stored blocks (d-regularity of every
        factor), so the usual CSR indptr array is a closed form;
      * **column indices are per factor** — only the base-graph adjacency
        lists (``sum d_j * n_left_j`` int32s) are stored, never the product
        adjacency (the paper's succinctness claim, extended to arbitrary
        depth); the product column of slot ``(k_1, .., k_F)`` of row
        ``(r_1, .., r_F)`` is ``sum_j adj_j[r_j][k_j] * stride_j``;
      * **dense leaf blocks** — a trailing run of complete factors makes
        every stored block a contiguous dense ``(G, C)`` tile (what the
        kernels read as one block).

    Values: ``Wdata`` of shape ``(M, nnz_per_row)``; slot order is
    lexicographic in ``(k_1, .., k_F)`` which (factor adjacencies being
    sorted) is ascending column order per row — exactly CSR.

    Deterministic in the spec (graphs come from ``spec.sample()``), so
    every process reconstructs the layout from the spec alone.  Equality
    and hash by spec; a cache of anything derived from the adjacency must
    key on its content instead (``transpose_layout`` shares the forward
    graph sample, which a layout built from the transposed spec does not).
    """

    def __init__(self, spec: RBGPSpec):
        self.spec = spec
        structure = spec.sample()
        self.structure = structure
        self.graphs = structure.factors
        # per-factor column indices: (n_left_j, d_j) int32 each
        self.adjs = tuple(g.left_adjacency() for g in self.graphs)
        self._ci: Optional[np.ndarray] = None

    def __eq__(self, other) -> bool:
        return isinstance(other, ChainLayout) and self.spec == other.spec

    def __hash__(self) -> int:
        return hash(self.spec)

    # -- sizes ------------------------------------------------------------
    @property
    def m(self) -> int:
        return self.spec.m

    @property
    def k(self) -> int:
        return self.spec.k

    @property
    def nnz_per_row(self) -> int:
        return self.spec.nnz_per_row

    @property
    def data_shape(self) -> tuple[int, int]:
        """Compact value storage shape (M, prod d_j)."""
        return (self.spec.m, self.spec.nnz_per_row)

    # -- masks ------------------------------------------------------------
    def mask(self) -> np.ndarray:
        """Dense {0,1} uint8 mask, shape (M, K) — identical to the mask the
        masked fallback samples for this spec (same graphs, chain order)."""
        return self.structure.mask()

    # -- compact <-> dense ------------------------------------------------
    def _col_index(self) -> np.ndarray:
        """(M, nnz_per_row) int32: dense column of each compact slot.

        Built by the Kronecker mixed-radix recurrence: appending factor j
        refines every (row, slot) cell into (n_left_j, d_j) children with
        column ``parent * n_right_j + adj_j[r_j][k_j]`` — the same
        enumeration order ``np.kron`` gives the mask.
        """
        if self._ci is None:
            ci = np.zeros((1, 1), np.int64)
            for g, adj in zip(self.graphs, self.adjs):
                r, s = ci.shape
                nl, d = adj.shape
                ci = (ci[:, None, :, None] * g.n_right
                      + adj.astype(np.int64)[None, :, None, :]
                      ).reshape(r * nl, s * d)
            assert ci.shape == self.data_shape
            self._ci = ci.astype(np.int32)
        return self._ci

    def pack(self, w_dense: np.ndarray) -> np.ndarray:
        """Gather the masked values of a dense (M, K) matrix into Wdata."""
        if w_dense.shape != (self.m, self.k):
            raise ValueError(f"expected {(self.m, self.k)}, got {w_dense.shape}")
        return np.take_along_axis(w_dense, self._col_index(), axis=1)

    def unpack(self, w_data: np.ndarray) -> np.ndarray:
        """Scatter compact Wdata back to dense (M, K) (zeros off-mask)."""
        if w_data.shape != self.data_shape:
            raise ValueError(f"expected {self.data_shape}, got {w_data.shape}")
        out = np.zeros((self.m, self.k), dtype=w_data.dtype)
        np.put_along_axis(out, self._col_index(), w_data, axis=1)
        return out

    # -- transpose --------------------------------------------------------
    def transpose_layout(self) -> "ChainLayout":
        """Layout of W^T (every factor transposed). Shares graph samples."""
        lt = ChainLayout.__new__(ChainLayout)
        lt.spec = RBGPSpec(
            factors=tuple(
                FactorSpec(f.kind, f.n_right, f.n_left, sparsity=f.sparsity)
                for f in self.spec.factors),
            seed=self.spec.seed,
        )
        lt.structure = self.structure.transpose()
        lt.graphs = lt.structure.factors
        lt.adjs = tuple(g.left_adjacency() for g in lt.graphs)
        lt._ci = None
        return lt

    def transpose_perm(self) -> np.ndarray:
        """perm such that WdataT.flat = Wdata.flat[perm] (see
        :func:`_slot_transpose_perm`)."""
        return _slot_transpose_perm(
            self._col_index(), self.transpose_layout()._col_index(),
            self.m, self.k,
        )

    # -- memory accounting (paper §4, arbitrary depth) ---------------------
    def memory_bytes(self, value_bytes: int = 4, index_bytes: int = 4) -> dict:
        sp = self.spec
        values = sp.nnz * value_bytes
        succinct_index = sp.stored_index_edges * index_bytes
        full_index = sp.nnz * index_bytes  # flat-CSR column indices
        return {
            "values": values,
            "index_succinct": succinct_index,
            "index_full": full_index,
            "total": values + succinct_index,
            "index_compression": full_index / max(succinct_index, 1),
        }

    def __repr__(self) -> str:  # pragma: no cover
        sp = self.spec
        chain = "x".join(
            f"{f.kind[0]}{f.n_left}:{f.n_right}@{f.sparsity:g}"
            for f in sp.factors)
        return (f"ChainLayout({sp.m}x{sp.k} sp={sp.sparsity:.4f} "
                f"nnz/row={sp.nnz_per_row} [{chain}])")


# ---------------------------------------------------------------------------
# Product algebra: arbitrary Ramanujan/complete factor chains (paper §3-4).
#
# RBGP4 is one point in the paper's product-of-k-graphs design space.  The
# algebra below describes any chain G_1 (x) ... (x) G_K of 'ramanujan' and
# 'complete' factors; RBGP2 (one sparse outer graph x one dense block),
# RBGP4, and hierarchical-block patterns (Vooturi et al. 2018: complete
# outer blocking around a sparse factor) are all instances.  Chains with at
# most two sparse factors canonicalize onto RBGP4Spec (factor reordering is
# a perfect-shuffle isomorphism), which is what unlocks the compact storage;
# deeper chains get the blocked-CSR ChainLayout.
# ---------------------------------------------------------------------------

#: sentinel sizes/sparsities meaning "let the designer allocate this"
AUTO = 0
AUTO_SP = -1.0


@dataclasses.dataclass(frozen=True)
class FactorSpec:
    """One fully-allocated factor of a product chain.

    ``kind`` is 'ramanujan' or 'complete'; a 'ramanujan' factor with
    sparsity 0 degenerates to complete (generate_ramanujan returns
    K_{n_l, n_r} directly).
    """

    kind: str
    n_left: int
    n_right: int
    sparsity: float = 0.0

    @property
    def d_left(self) -> int:
        return round((1.0 - self.sparsity) * self.n_right)

    @property
    def d_right(self) -> int:
        return round((1.0 - self.sparsity) * self.n_left)

    @property
    def n_edges(self) -> int:
        return self.n_left * self.d_left

    @property
    def is_sparse(self) -> bool:
        return self.kind == "ramanujan" and self.sparsity > 0.0


def canonicalize_factors(factors) -> tuple[tuple[str, int, int, float], ...]:
    """Normalize user-facing factor templates to a hashable tuple form.

    Accepted per-factor spellings:
      * ``"ramanujan"`` / ``"complete"``            (auto size, auto sparsity)
      * ``(kind, (n_left, n_right))``               (fixed size)
      * ``(kind, (n_left, n_right), sparsity)``     (fixed size + sparsity)
      * ``{"kind": ..., "shape": ..., "sparsity": ...}``

    Canonical entries are ``(kind, n_left, n_right, sparsity)`` with
    ``AUTO`` (0) sizes / ``AUTO_SP`` (-1.0) sparsity for designer-allocated
    slots — hashable (lru/config-friendly) and JSON round-trippable.
    """
    out = []
    for f in factors:
        if isinstance(f, str):
            kind, shape, sp = f, None, None
        elif isinstance(f, dict):
            kind = f["kind"]
            shape = f.get("shape")
            sp = f.get("sparsity")
        else:
            seq = tuple(f)
            if len(seq) == 4 and isinstance(seq[1], int):  # already canonical
                kind, shape, sp = seq[0], (seq[1], seq[2]), seq[3]
                if shape == (AUTO, AUTO):
                    shape = None
                if sp == AUTO_SP:
                    sp = None
            else:
                kind = seq[0]
                shape = seq[1] if len(seq) > 1 else None
                sp = seq[2] if len(seq) > 2 else None
        if kind not in ("ramanujan", "complete"):
            raise ValueError(f"factor kind must be 'ramanujan' or 'complete',"
                             f" got {kind!r}")
        if kind == "complete" and sp not in (None, 0.0):
            raise ValueError("complete factors cannot carry sparsity")
        nl, nr = (AUTO, AUTO) if shape is None else (int(shape[0]), int(shape[1]))
        out.append((kind, nl, nr,
                    AUTO_SP if sp is None else float(sp)))
    if not out:
        raise ValueError("need at least one factor")
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class RBGPSpec:
    """A fully-allocated product chain for an (M, K) weight matrix."""

    factors: tuple[FactorSpec, ...]
    seed: int = 0

    @property
    def m(self) -> int:
        return math.prod(f.n_left for f in self.factors)

    @property
    def k(self) -> int:
        return math.prod(f.n_right for f in self.factors)

    @property
    def sparsity(self) -> float:
        dens = 1.0
        for f in self.factors:
            dens *= 1.0 - f.sparsity
        return 1.0 - dens

    @property
    def nnz_per_row(self) -> int:
        return math.prod(f.d_left for f in self.factors)

    @property
    def nnz(self) -> int:
        return self.m * self.nnz_per_row

    @property
    def stored_index_edges(self) -> int:
        """Succinct connectivity storage: Sigma |E_i| (paper §4)."""
        return sum(f.n_edges for f in self.factors)

    def sample(self) -> ProductStructure:
        """Deterministically sample the factor graphs (chain order).

        Seeds are derived per factor index from ``self.seed``, so every
        process reconstructs the identical mask from the spec alone (the
        same no-communication contract as RBGP4Layout).
        """
        graphs = []
        for i, f in enumerate(self.factors):
            if f.kind == "complete" or f.sparsity == 0.0:
                graphs.append(complete_bipartite(f.n_left, f.n_right))
            else:
                graphs.append(generate_ramanujan(
                    f.n_left, f.n_right, f.sparsity,
                    seed=self.seed * 4096 + 2 * i + 1,
                ))
        return ProductStructure(tuple(graphs))

    def to_rbgp4(self) -> Optional[RBGP4Spec]:
        """Canonicalize onto RBGP4Spec when the chain has <= 2 sparse factors.

        Factor reordering is a perfect-shuffle row/column permutation — a
        graph isomorphism — so connectivity guarantees are preserved; the
        complete factors collapse into G_r (their product is what matters
        for the layout).  Returns None when the chain is not expressible
        (then masks come from :meth:`sample`).
        """
        sparse = [f for f in self.factors if f.is_sparse]
        if len(sparse) > 2:
            return None
        r_l = r_r = 1
        for f in self.factors:
            if not f.is_sparse:
                r_l *= f.n_left
                r_r *= f.n_right
        g_o = (sparse[0].n_left, sparse[0].n_right) if sparse else (1, 1)
        sp_o = sparse[0].sparsity if sparse else 0.0
        g_i = (sparse[1].n_left, sparse[1].n_right) if len(sparse) > 1 else (1, 1)
        sp_i = sparse[1].sparsity if len(sparse) > 1 else 0.0
        spec = RBGP4Spec(
            g_o=g_o, g_r=(r_l, r_r), g_i=g_i, g_b=(1, 1),
            sp_o=sp_o, sp_i=sp_i, seed=self.seed,
        )
        try:
            spec.validate()
        except ValueError:
            return None
        return spec


def rbgp_from_rbgp4(spec: RBGP4Spec) -> RBGPSpec:
    """The paper-order (o, r, i, b) chain view of an RBGP4Spec."""
    return RBGPSpec(
        factors=(
            FactorSpec("ramanujan", *spec.g_o, sparsity=spec.sp_o),
            FactorSpec("complete", *spec.g_r),
            FactorSpec("ramanujan", *spec.g_i, sparsity=spec.sp_i),
            FactorSpec("complete", *spec.g_b),
        ),
        seed=spec.seed,
    )


def _split_pow2(total: int, shares: int, first_extra: bool) -> list[int]:
    """Split a 2-adic valuation budget into ``shares`` integer parts."""
    base = total // shares
    rem = total - base * shares
    out = [base] * shares
    for j in range(rem):
        out[j if first_extra else shares - 1 - j] += 1
    return out


def design_rbgp(
    m: int,
    k: int,
    sparsity: float,
    *,
    factors=None,
    seed: int = 0,
) -> RBGPSpec:
    """Allocate an arbitrary Ramanujan/complete factor chain for (m, k).

    ``factors=None`` delegates to the TPU-tuned :func:`design_rbgp4` search
    and returns its paper-order chain — the existing RBGP4 behavior is the
    default instance of the algebra.  Otherwise ``factors`` names the chain
    (see :func:`canonicalize_factors`): fixed sizes are divided out of
    (m, k) first, remaining power-of-two mass is spread over the auto-sized
    factors (odd parts and leftover valuation to the first sparse factor —
    the outer graph carries the irregularity, as in design_rbgp4), and the
    total sparsity budget ``1 - 2^-k_total`` lands on the sparse factors
    earliest-first under each factor's 2-adic feasibility cap.
    """
    if factors is None:
        return rbgp_from_rbgp4(design_rbgp4(m, k, sparsity, seed=seed))
    return _design_rbgp_chain(m, k, sparsity, canonicalize_factors(factors),
                              seed)


@functools.lru_cache(maxsize=4096)
def _design_rbgp_chain(
    m: int, k: int, sparsity: float, tmpl: tuple, seed: int
) -> RBGPSpec:
    k_total = pow2_sparsity_steps(sparsity)

    # 1. fixed shapes divide out of (m, k)
    rem_m, rem_k = m, k
    for kind, nl, nr, _sp in tmpl:
        if nl != AUTO:
            if rem_m % nl or rem_k % nr:
                raise ValueError(
                    f"fixed factor {kind}({nl}x{nr}) does not divide the "
                    f"remaining {rem_m}x{rem_k} of {m}x{k}")
            rem_m //= nl
            rem_k //= nr

    # 2. auto sizes: spread the power-of-two mass; odd parts + leftover
    #    valuation go to the first sparse auto factor (else the first auto)
    auto_idx = [i for i, t in enumerate(tmpl) if t[1] == AUTO]
    sizes: dict[int, tuple[int, int]] = {}
    if auto_idx:
        sparse_auto = [i for i in auto_idx if tmpl[i][0] == "ramanujan"]
        anchor = sparse_auto[0] if sparse_auto else auto_idx[0]
        om, vm = rem_m >> _v2(rem_m), _v2(rem_m)
        ok_, vk = rem_k >> _v2(rem_k), _v2(rem_k)
        vms = _split_pow2(vm, len(auto_idx), first_extra=True)
        vks = _split_pow2(vk, len(auto_idx), first_extra=True)
        # rotate so the anchor gets the first (largest) share + odd part
        order = sorted(auto_idx, key=lambda i: (i != anchor, i))
        for slot, i in enumerate(order):
            nl = 2 ** vms[slot]
            nr = 2 ** vks[slot]
            if i == anchor:
                nl *= om
                nr *= ok_
            sizes[i] = (nl, nr)
    elif rem_m != 1 or rem_k != 1:
        raise ValueError(
            f"fixed factor sizes leave {rem_m}x{rem_k} of {m}x{k} unassigned")

    shapes = [(t[1], t[2]) if t[1] != AUTO else sizes[i]
              for i, t in enumerate(tmpl)]

    # 3. sparsity: explicit steps first, remaining budget earliest-first
    steps = [0] * len(tmpl)
    budget = k_total
    for i, (kind, _nl, _nr, sp) in enumerate(tmpl):
        if kind == "ramanujan" and sp not in (AUTO_SP, 0.0):
            steps[i] = pow2_sparsity_steps(sp)
            budget -= steps[i]
    if budget < 0:
        raise ValueError(
            f"explicit factor sparsities exceed the total budget "
            f"1-2^-{k_total}")
    for min_deg in (2, 1):
        for i, (kind, _nl, _nr, sp) in enumerate(tmpl):
            if budget == 0:
                break
            if kind != "ramanujan" or sp != AUTO_SP:
                continue
            nl, nr = shapes[i]
            cap = _cap_steps(nl, nr, min_deg)
            take = min(budget, cap - steps[i])
            if take > 0:
                steps[i] += take
                budget -= take
    if budget > 0:
        raise ValueError(
            f"chain {tmpl} cannot carry sparsity {sparsity} at {m}x{k} "
            f"(insufficient 2-adic capacity on the sparse factors)")

    spec = RBGPSpec(
        factors=tuple(
            FactorSpec(kind, *shapes[i],
                       sparsity=1.0 - 2.0 ** (-steps[i]) if steps[i] else 0.0)
            for i, (kind, _nl, _nr, _sp) in enumerate(tmpl)
        ),
        seed=seed,
    )
    assert spec.m == m and spec.k == k, (spec.m, spec.k, m, k)
    return spec
