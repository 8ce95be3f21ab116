"""Hand-written CUDA kernels for Hopper, with their plain versions.

``rbgp4mm_rhs``, ``rbgp4_sddmm_rhs``, ``rbgp4mm_rhs_stacked`` and
``rbgp4_sddmm_rhs_stacked`` replace the Pallas kernels of the same names in
``repro/kernels/rbgp4mm.py``, ``chainmm_rhs`` and ``chain_sddmm_rhs`` those
of ``repro/kernels/chainmm.py``; ``ops.RBGP4Linear``,
``ops.RBGP4LinearStacked`` and ``ops.ChainLinear`` are the differentiable
projections built on them.  The other Pallas kernels of the reference come with later slices
(see ROADMAP.md).
"""
from . import build, ref
from .chainmm import (
    ChainTables,
    ChainTransposeTables,
    chain_sddmm_rhs,
    chain_sddmm_rhs_reference,
    chain_tables,
    chain_transpose_tables,
    chainmm_rhs,
    chainmm_rhs_reference,
)
from .ops import ChainLinear, RBGP4Linear, RBGP4LinearStacked
from .rbgp4mm import (
    EPILOGUE_ACTS,
    KernelDims,
    KernelTables,
    TransposeTables,
    rbgp4_sddmm_rhs,
    rbgp4_sddmm_rhs_reference,
    rbgp4_sddmm_rhs_stacked,
    rbgp4_sddmm_rhs_stacked_reference,
    rbgp4mm_rhs,
    rbgp4mm_rhs_reference,
    rbgp4mm_rhs_stacked,
    rbgp4mm_rhs_stacked_reference,
)

__all__ = [
    "EPILOGUE_ACTS",
    "KernelDims",
    "KernelTables",
    "TransposeTables",
    "RBGP4Linear",
    "RBGP4LinearStacked",
    "rbgp4mm_rhs",
    "rbgp4mm_rhs_reference",
    "rbgp4_sddmm_rhs",
    "rbgp4_sddmm_rhs_reference",
    "rbgp4mm_rhs_stacked",
    "rbgp4mm_rhs_stacked_reference",
    "rbgp4_sddmm_rhs_stacked",
    "rbgp4_sddmm_rhs_stacked_reference",
    "ChainTables",
    "ChainTransposeTables",
    "ChainLinear",
    "chain_tables",
    "chain_transpose_tables",
    "chainmm_rhs",
    "chainmm_rhs_reference",
    "chain_sddmm_rhs",
    "chain_sddmm_rhs_reference",
    "build",
    "ref",
]
