"""Core RBGP library (numpy): graphs, products, spectra, RBGP4 and chain
layouts.

Copied from ``repro.core`` so the port imports nothing of the JAX package;
sampling is unchanged, so the masks are the reference's.
"""
from .graphs import (
    BipartiteGraph,
    complete_bipartite,
    generate_biregular,
    generate_ramanujan,
    is_ramanujan,
    second_singular_value,
    two_lift,
)
from .product import ProductStructure, graph_product, product_mask
from .rbgp import (
    ChainLayout,
    FactorSpec,
    RBGP4Layout,
    RBGP4Spec,
    RBGPSpec,
    canonicalize_factors,
    design_rbgp,
    design_rbgp4,
    pow2_sparsity_steps,
)
from .spectral import (
    ideal_spectral_gap,
    product_second_eigenvalue,
    singular_values,
    spectral_gap,
    theorem1_ratio,
)

__all__ = [
    "BipartiteGraph",
    "complete_bipartite",
    "two_lift",
    "is_ramanujan",
    "second_singular_value",
    "generate_biregular",
    "generate_ramanujan",
    "graph_product",
    "product_mask",
    "ProductStructure",
    "RBGP4Spec",
    "RBGP4Layout",
    "design_rbgp4",
    "pow2_sparsity_steps",
    "FactorSpec",
    "RBGPSpec",
    "design_rbgp",
    "canonicalize_factors",
    "ChainLayout",
    "singular_values",
    "spectral_gap",
    "ideal_spectral_gap",
    "product_second_eigenvalue",
    "theorem1_ratio",
]
