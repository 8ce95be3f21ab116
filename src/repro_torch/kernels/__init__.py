"""Hand-written CUDA kernels for Hopper, with their plain versions.

``rbgp4mm_rhs`` and ``rbgp4_sddmm_rhs`` replace the Pallas kernels of the
same names in ``repro/kernels/rbgp4mm.py``; ``ops.RBGP4Linear`` is the
differentiable projection built on them.  The other Pallas kernels of the
reference come with later slices (see ROADMAP.md).
"""
from . import build, ref
from .ops import RBGP4Linear
from .rbgp4mm import (
    EPILOGUE_ACTS,
    KernelDims,
    KernelTables,
    TransposeTables,
    rbgp4_sddmm_rhs,
    rbgp4_sddmm_rhs_reference,
    rbgp4mm_rhs,
    rbgp4mm_rhs_reference,
)

__all__ = [
    "EPILOGUE_ACTS",
    "KernelDims",
    "KernelTables",
    "TransposeTables",
    "RBGP4Linear",
    "rbgp4mm_rhs",
    "rbgp4mm_rhs_reference",
    "rbgp4_sddmm_rhs",
    "rbgp4_sddmm_rhs_reference",
    "build",
    "ref",
]
