"""Bipartite graph products and RCUBS structure arithmetic (paper §3-4).

The bipartite graph product G_p = G_1 (x)_b G_2 has biadjacency matrix equal to
the Kronecker (tensor) product of the factor biadjacency matrices.  A K-factor
product of biregular graphs yields an RCUBS (Recursive Cloned Uniform Block
Sparse) matrix with K-1 blocking levels B_j = (prod_{i>j} |G_i.U|,
prod_{i>j} |G_i.V|).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from .graphs import BipartiteGraph

__all__ = [
    "graph_product",
    "product_mask",
    "ProductStructure",
    "rcubs_levels",
    "connectivity_storage_edges",
]


def graph_product(g1: BipartiteGraph, g2: BipartiteGraph) -> BipartiteGraph:
    """Bipartite graph product: biadjacency = kron(BA_1, BA_2)."""
    return BipartiteGraph(np.kron(g1.biadjacency, g2.biadjacency))


def product_mask(factors: Sequence[BipartiteGraph]) -> np.ndarray:
    """Materialized {0,1} mask of G_1 (x)_b ... (x)_b G_K (uint8)."""
    if not factors:
        raise ValueError("need at least one factor")
    ba = factors[0].biadjacency
    for g in factors[1:]:
        ba = np.kron(ba, g.biadjacency)
    return ba


def rcubs_levels(factors: Sequence[BipartiteGraph]) -> list[tuple[int, int]]:
    """Blocking levels B_1..B_{K-1} of the RCUBS pattern (paper §4).

    B_j = (prod_{i=j+1..K} |G_i.U|, prod_{i=j+1..K} |G_i.V|).
    """
    k = len(factors)
    levels = []
    for j in range(1, k):
        bh = int(np.prod([g.n_left for g in factors[j:]]))
        bw = int(np.prod([g.n_right for g in factors[j:]]))
        levels.append((bh, bw))
    return levels


def connectivity_storage_edges(factors: Sequence[BipartiteGraph]) -> tuple[int, int]:
    """(product_edges, stored_edges): Pi |E_i| vs Sigma |E_i| (paper §4).

    The ratio is the succinctness gain of storing base-graph adjacency lists
    instead of the full product adjacency (23x in the paper's Fig. 3).
    """
    prod_e = 1
    sum_e = 0
    for g in factors:
        prod_e *= g.n_edges
        sum_e += g.n_edges
    return prod_e, sum_e


@dataclasses.dataclass(frozen=True)
class ProductStructure:
    """Static description of a K-factor product mask.

    Holds the factor graphs and derived structure used by layout code and by
    the benchmarks' analytic memory model.
    """

    factors: tuple[BipartiteGraph, ...]

    @property
    def n_left(self) -> int:
        return int(np.prod([g.n_left for g in self.factors]))

    @property
    def n_right(self) -> int:
        return int(np.prod([g.n_right for g in self.factors]))

    @property
    def n_edges(self) -> int:
        e = 1
        for g in self.factors:
            e *= g.n_edges
        return e

    @property
    def sparsity(self) -> float:
        return 1.0 - self.n_edges / (self.n_left * self.n_right)

    @property
    def nnz_per_row(self) -> int:
        d = 1
        for g in self.factors:
            d *= g.d_left
        return d

    @property
    def nnz_per_col(self) -> int:
        d = 1
        for g in self.factors:
            d *= g.d_right
        return d

    def mask(self) -> np.ndarray:
        return product_mask(self.factors)

    def levels(self) -> list[tuple[int, int]]:
        return rcubs_levels(self.factors)

    def transpose(self) -> "ProductStructure":
        """Transpose of a Kronecker product = product of transposes."""
        return ProductStructure(tuple(g.transpose() for g in self.factors))

    def storage_summary(self) -> dict:
        prod_e, sum_e = connectivity_storage_edges(self.factors)
        return {
            "shape": (self.n_left, self.n_right),
            "edges": prod_e,
            "stored_index_edges": sum_e,
            "index_compression": prod_e / max(sum_e, 1),
            "sparsity": self.sparsity,
        }
