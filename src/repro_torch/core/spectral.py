"""Spectral analysis of product graphs (paper §4, Theorem 1).

A copy of ``repro/core/spectral.py`` (numpy), kept in this package so the
port loads nothing of the JAX package.  Eigenvalues of a bipartite graph's
adjacency matrix are +/- the singular values of its biadjacency matrix;
the spectral gap d - lambda_2 measures connectivity (Alon).  For a
Kronecker product the singular values are all pairwise products of factor
singular values, so the product of Ramanujan graphs has lambda_2 = d_1 *
lambda_2(G_2) (up to symmetry), which Theorem 1 shows approaches the ideal
gap as the graphs grow.
"""
from __future__ import annotations

import math
from typing import Sequence

import numpy as np

from .graphs import BipartiteGraph

__all__ = [
    "singular_values",
    "spectral_gap",
    "ideal_spectral_gap",
    "product_second_eigenvalue",
    "theorem1_ratio",
]


def singular_values(g: BipartiteGraph) -> np.ndarray:
    return np.linalg.svd(g.biadjacency.astype(np.float64), compute_uv=False)


def spectral_gap(g: BipartiteGraph) -> float:
    """lambda_1 - lambda_2 of the (bipartite) adjacency spectrum."""
    s = singular_values(g)
    if len(s) < 2:
        return float(s[0])
    return float(s[0] - s[1])


def ideal_spectral_gap(d: float) -> float:
    """Best possible gap for d-regular graphs: d - 2*sqrt(d-1) (Ramanujan)."""
    return d - 2.0 * math.sqrt(max(d - 1.0, 0.0))


def product_second_eigenvalue(factors: Sequence[BipartiteGraph]) -> float:
    """lambda_2 of the product = max over factors of
    (prod of top singular values of others) * sigma_2(that factor)."""
    tops = [float(singular_values(g)[0]) for g in factors]
    seconds = []
    for g in factors:
        s = singular_values(g)
        seconds.append(float(s[1]) if len(s) > 1 else 0.0)
    best = 0.0
    for i in range(len(factors)):
        prod = 1.0
        for j, t in enumerate(tops):
            if j != i:
                prod *= t
        best = max(best, prod * seconds[i])
    return best


def theorem1_ratio(g1: BipartiteGraph, g2: BipartiteGraph) -> float:
    """IdealSpectralGap_{d^2} / SpectralGap(G1 x G2) — Theorem 1's LHS.

    For square d-regular Ramanujan factors this tends to 1 from above as d
    grows.  Computed from factor spectra (no need to materialize the product).
    """
    d1, d2 = g1.d_left, g2.d_left
    d = d1 * d2  # product degree
    lam2 = product_second_eigenvalue([g1, g2])
    gap = d - lam2
    if gap <= 0:
        return math.inf
    return ideal_spectral_gap(d) / gap
