"""Biregular bipartite graphs, 2-lifts, and Ramanujan certification.

This module implements the paper's Appendix 8.1: Ramanujan bipartite graphs are
generated by repeatedly applying random 2-lift operations (Bilu-Linial) to a
complete bipartite graph, resampling until the Ramanujan eigenvalue bound holds.

A bipartite graph G = (U, V, E) is represented by its biadjacency matrix
(|U| x |V|, uint8) plus, for biregular graphs, a left adjacency list of shape
(|U|, d_l) (each left vertex's sorted right-neighbour indices).  All sizes in
this codebase are powers of two by construction (2-lifts double both sides).
"""
from __future__ import annotations

import dataclasses
import math
from functools import lru_cache
from typing import Optional

import numpy as np

__all__ = [
    "BipartiteGraph",
    "complete_bipartite",
    "two_lift",
    "is_ramanujan",
    "second_singular_value",
    "generate_biregular",
    "generate_ramanujan",
]


@dataclasses.dataclass(frozen=True)
class BipartiteGraph:
    """An (d_l, d_r)-biregular bipartite graph.

    Attributes:
      biadjacency: (|U|, |V|) uint8 matrix, 1 where an edge is present.
    """

    biadjacency: np.ndarray

    def __post_init__(self):
        ba = np.asarray(self.biadjacency, dtype=np.uint8)
        object.__setattr__(self, "biadjacency", ba)
        if ba.ndim != 2:
            raise ValueError(f"biadjacency must be 2D, got shape {ba.shape}")

    # -- basic properties ------------------------------------------------
    @property
    def n_left(self) -> int:
        return self.biadjacency.shape[0]

    @property
    def n_right(self) -> int:
        return self.biadjacency.shape[1]

    @property
    def n_edges(self) -> int:
        return int(self.biadjacency.sum())

    @property
    def left_degrees(self) -> np.ndarray:
        return self.biadjacency.sum(axis=1)

    @property
    def right_degrees(self) -> np.ndarray:
        return self.biadjacency.sum(axis=0)

    @property
    def is_biregular(self) -> bool:
        ld, rd = self.left_degrees, self.right_degrees
        return bool((ld == ld[0]).all() and (rd == rd[0]).all())

    @property
    def d_left(self) -> int:
        """Common left degree (requires biregularity)."""
        ld = self.left_degrees
        if not (ld == ld[0]).all():
            raise ValueError("graph is not left-regular")
        return int(ld[0])

    @property
    def d_right(self) -> int:
        rd = self.right_degrees
        if not (rd == rd[0]).all():
            raise ValueError("graph is not right-regular")
        return int(rd[0])

    @property
    def sparsity(self) -> float:
        """Fraction of absent edges: 1 - |E| / (|U|*|V|)."""
        return 1.0 - self.n_edges / (self.n_left * self.n_right)

    @property
    def is_complete(self) -> bool:
        return self.n_edges == self.n_left * self.n_right

    # -- adjacency lists --------------------------------------------------
    def left_adjacency(self) -> np.ndarray:
        """(|U|, d_l) int32: sorted right-neighbours of each left vertex."""
        d = self.d_left
        out = np.zeros((self.n_left, d), dtype=np.int32)
        for u in range(self.n_left):
            out[u] = np.flatnonzero(self.biadjacency[u])
        return out

    def right_adjacency(self) -> np.ndarray:
        """(|V|, d_r) int32: sorted left-neighbours of each right vertex."""
        return self.transpose().left_adjacency()

    def transpose(self) -> "BipartiteGraph":
        return BipartiteGraph(self.biadjacency.T.copy())

    # -- hashing / ids ----------------------------------------------------
    def fingerprint(self) -> str:
        import hashlib

        return hashlib.sha1(self.biadjacency.tobytes()).hexdigest()[:12]

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return (
            f"BipartiteGraph({self.n_left}x{self.n_right}, |E|={self.n_edges},"
            f" sp={self.sparsity:.3f})"
        )


def complete_bipartite(n_left: int, n_right: int) -> BipartiteGraph:
    """K_{n_left, n_right}: every left vertex connected to every right vertex."""
    if n_left < 1 or n_right < 1:
        raise ValueError("sides must be >= 1")
    return BipartiteGraph(np.ones((n_left, n_right), dtype=np.uint8))


def two_lift(g: BipartiteGraph, rng: np.random.Generator) -> BipartiteGraph:
    """Random 2-lift (paper App. 8.1, Fig. 4).

    Creates the disjoint union of G and a clone G^c, then for every edge
    (u, v) independently either keeps the parallel pair {(u,v),(u^c,v^c)} or
    crosses over to {(u,v^c),(u^c,v)}.  Preserves biregularity and doubles
    both sides and the edge count.
    """
    ba = g.biadjacency
    nl, nr = ba.shape
    # sign matrix: +1 = identity pair, -1 = crossover pair (only where edges)
    flips = rng.integers(0, 2, size=ba.shape).astype(bool) & (ba > 0)
    keep = (ba > 0) & ~flips
    lifted = np.zeros((2 * nl, 2 * nr), dtype=np.uint8)
    lifted[:nl, :nr] = keep
    lifted[nl:, nr:] = keep
    lifted[:nl, nr:] = flips
    lifted[nl:, :nr] = flips
    return BipartiteGraph(lifted)


def second_singular_value(g: BipartiteGraph) -> float:
    """Second-largest singular value of the biadjacency matrix.

    For a bipartite graph the adjacency spectrum is {+/- sigma_i} where
    sigma_i are the singular values of the biadjacency matrix, so the
    "second largest eigenvalue" lambda_2 of the paper equals sigma_2.
    """
    svals = np.linalg.svd(g.biadjacency.astype(np.float64), compute_uv=False)
    if len(svals) < 2:
        return 0.0
    return float(svals[1])


def ramanujan_bound(g: BipartiteGraph) -> float:
    """sqrt(d_l - 1) + sqrt(d_r - 1) for a biregular graph."""
    return math.sqrt(max(g.d_left - 1, 0)) + math.sqrt(max(g.d_right - 1, 0))


def is_ramanujan(g: BipartiteGraph, tol: float = 1e-9) -> bool:
    """Check lambda_2 <= sqrt(d_l-1) + sqrt(d_r-1).

    Complete bipartite graphs have lambda_2 = 0 and are trivially Ramanujan.
    """
    if not g.is_biregular:
        return False
    return second_singular_value(g) <= ramanujan_bound(g) + tol


def _check_pow2(x: int, name: str) -> None:
    if x < 1 or (x & (x - 1)) != 0:
        raise ValueError(f"{name} must be a positive power of two, got {x}")


def generate_biregular(
    n_left: int,
    n_right: int,
    sparsity: float,
    rng: np.random.Generator,
) -> BipartiteGraph:
    """Generate a sparse biregular bipartite graph via repeated 2-lifts.

    Per the paper: a biregular graph with sparsity ``sp`` is obtained by
    applying ``log2(1/(1-sp))`` 2-lifts to a complete bipartite graph with
    ``(1-sp) * n_left`` x ``(1-sp) * n_right`` vertices.

    ``sparsity`` must be of the form 1 - 2^-k, and the starting sides
    ``(1-sp)*n`` must be positive integers.
    """
    if not (0.0 <= sparsity < 1.0):
        raise ValueError(f"sparsity must be in [0, 1), got {sparsity}")
    dens = 1.0 - sparsity
    n_lifts_f = math.log2(1.0 / dens)
    n_lifts = round(n_lifts_f)
    if abs(n_lifts_f - n_lifts) > 1e-9:
        raise ValueError(
            f"sparsity must equal 1 - 2^-k for integer k, got {sparsity}"
        )
    base_l = n_left * dens
    base_r = n_right * dens
    if abs(base_l - round(base_l)) > 1e-9 or abs(base_r - round(base_r)) > 1e-9:
        raise ValueError(
            f"(1-sp)*sides must be integers: got {base_l} x {base_r}"
        )
    base_l, base_r = round(base_l), round(base_r)
    if base_l < 1 or base_r < 1:
        raise ValueError(
            f"sparsity {sparsity} too high for a {n_left}x{n_right} graph"
        )
    g = complete_bipartite(base_l, base_r)
    for _ in range(n_lifts):
        g = two_lift(g, rng)
    assert g.n_left == n_left and g.n_right == n_right
    return g


def generate_ramanujan(
    n_left: int,
    n_right: int,
    sparsity: float,
    seed: int = 0,
    max_tries: int = 256,
) -> BipartiteGraph:
    """Sample 2-lifted biregular graphs until one is Ramanujan.

    The paper reports graphs with sides in the thousands generate in minutes;
    at our factor sizes (<= a few hundred) this is milliseconds.  Complete
    graphs (sparsity=0) are returned directly.
    """
    if sparsity == 0.0:
        return complete_bipartite(n_left, n_right)
    rng = np.random.default_rng(seed)
    # Degenerate case: degree-1 graphs are unions of matchings.  lambda_2 = 1
    # but the Ramanujan bound is 0, so the condition is unsatisfiable; every
    # sample is isomorphic, so accept the first one.  The auto-designer avoids
    # producing these when the sparsity budget allows degrees >= 2.
    dens = 1.0 - sparsity
    if round(n_right * dens) <= 1 or round(n_left * dens) <= 1:
        return generate_biregular(n_left, n_right, sparsity, rng)
    last = None
    for _ in range(max_tries):
        g = generate_biregular(n_left, n_right, sparsity, rng)
        if is_ramanujan(g):
            return g
        last = g
    # Extremely unlikely for the sizes we use; fall back to the best sample
    # rather than failing hard, but flag it loudly.
    import warnings

    warnings.warn(
        f"generate_ramanujan: no Ramanujan graph in {max_tries} tries for "
        f"{n_left}x{n_right} sp={sparsity}; returning last biregular sample "
        f"(lambda2={second_singular_value(last):.3f} > "
        f"bound={ramanujan_bound(last):.3f})"
    )
    return last


@lru_cache(maxsize=4096)
def cached_ramanujan(
    n_left: int, n_right: int, sparsity: float, seed: int
) -> BipartiteGraph:
    """Memoized generate_ramanujan (mask construction is called per layer)."""
    return generate_ramanujan(n_left, n_right, sparsity, seed=seed)
