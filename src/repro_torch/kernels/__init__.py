"""Hand-written CUDA kernels for Hopper, with their plain versions.

``rbgp4mm_rhs`` replaces the Pallas ``repro/kernels/rbgp4mm.py``
``rbgp4mm_rhs`` forward.  The other Pallas kernels of the reference come
with later slices (see ROADMAP.md).
"""
from . import build, ref
from .rbgp4mm import (
    EPILOGUE_ACTS,
    KernelDims,
    KernelTables,
    rbgp4mm_rhs,
    rbgp4mm_rhs_reference,
)

__all__ = [
    "EPILOGUE_ACTS",
    "KernelDims",
    "KernelTables",
    "rbgp4mm_rhs",
    "rbgp4mm_rhs_reference",
    "build",
    "ref",
]
