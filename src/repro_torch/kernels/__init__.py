"""Hand-written CUDA kernels for Hopper, with their plain versions.

``rbgp4mm_rhs``, ``rbgp4_sddmm_rhs``, ``rbgp4mm_rhs_stacked`` and
``rbgp4_sddmm_rhs_stacked`` replace the Pallas kernels of the same names in
``repro/kernels/rbgp4mm.py``; ``ops.RBGP4Linear`` and
``ops.RBGP4LinearStacked`` are the differentiable projections built on
them.  The other Pallas kernels of the reference come with later slices
(see ROADMAP.md).
"""
from . import build, ref
from .ops import RBGP4Linear, RBGP4LinearStacked
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
    "build",
    "ref",
]
