"""RBGP4 sparsity pattern: spec, compact layout, auto-designer (paper §5).

A copy of the RBGP4 part of ``repro/core/rbgp.py`` (pure numpy), kept in
this package so the port loads nothing of the JAX package.  The graph
sampling, the adjacency lists and the compact slot order are unchanged, so
a layout built here has exactly the masks and ``Wdata`` order of the
reference.  The deep-chain parts (``ChainLayout``, ``RBGPSpec``,
``design_rbgp``) come with the deep-chain slice.

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

import numpy as np

from .graphs import complete_bipartite, generate_ramanujan
from .product import ProductStructure

__all__ = ["RBGP4Spec", "RBGP4Layout", "design_rbgp4", "pow2_sparsity_steps"]


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
