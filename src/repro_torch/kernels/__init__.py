"""Hand-written CUDA kernels for Hopper, with their plain versions.

``rbgp4mm``, ``rbgp4_sddmm``, ``rbgp4mm_rhs``, ``rbgp4_sddmm_rhs``,
``rbgp4mm_rhs_stacked`` and ``rbgp4_sddmm_rhs_stacked`` replace the Pallas
kernels of the same names in ``repro/kernels/rbgp4mm.py``,
``chainmm_rhs`` and ``chain_sddmm_rhs`` those of
``repro/kernels/chainmm.py``; ``ops.RBGP4MatMul``, ``ops.RBGP4Linear``,
``ops.RBGP4LinearStacked`` and ``ops.ChainLinear`` are the differentiable
products built on them, and ``ops.RBGP4Op`` (cached by ``get_op``) the
per-layer bundle of the reference.  ``rbgp4mm_rhs``,
``rbgp4mm_rhs_stacked`` and ``chainmm_rhs`` take ``scales=``, the int8
leaf-block path of the weight-only PTQ storage (``sparsity/quant.py``).
``rhs_path``, ``sddmm_path``, ``chain_rhs_path`` and ``chain_sddmm_path``
say which device body (FMA, or bf16 on the tensor cores) a launch of
``rbgp4mm_rhs`` or ``rbgp4mm_rhs_stacked``, ``rbgp4_sddmm_rhs`` or
``rbgp4_sddmm_rhs_stacked``, ``chainmm_rhs`` or ``chain_sddmm_rhs``
takes.
"""
from . import build, ref
from .chainmm import (
    ChainTables,
    ChainTransposeTables,
    chain_rhs_path,
    chain_rhs_tile_rows,
    chain_sddmm_path,
    chain_sddmm_rhs,
    chain_sddmm_rhs_reference,
    chain_tables,
    chain_transpose_tables,
    chainmm_rhs,
    chainmm_rhs_reference,
)
from .ops import (ChainLinear, RBGP4Linear, RBGP4LinearStacked, RBGP4MatMul,
                  RBGP4Op, get_op)
from .rbgp4mm import (
    EPILOGUE_ACTS,
    MMA_MIN_TOKENS,
    KernelDims,
    KernelTables,
    SddmmPlan,
    TransposeTables,
    rbgp4_sddmm,
    rbgp4_sddmm_reference,
    rbgp4_sddmm_rhs,
    rbgp4_sddmm_rhs_reference,
    rbgp4_sddmm_rhs_stacked,
    rbgp4_sddmm_rhs_stacked_reference,
    rbgp4mm,
    rbgp4mm_reference,
    rbgp4mm_rhs,
    rbgp4mm_rhs_reference,
    rbgp4mm_rhs_stacked,
    rbgp4mm_rhs_stacked_reference,
    rhs_path,
    sddmm_mma_plan,
    sddmm_path,
    stacked_mma_block_tokens,
    stacked_sddmm_mma_plan,
    stacked_sddmm_tile,
)

__all__ = [
    "EPILOGUE_ACTS",
    "MMA_MIN_TOKENS",
    "KernelDims",
    "SddmmPlan",
    "rhs_path",
    "sddmm_path",
    "sddmm_mma_plan",
    "stacked_mma_block_tokens",
    "stacked_sddmm_tile",
    "stacked_sddmm_mma_plan",
    "chain_rhs_path",
    "chain_rhs_tile_rows",
    "chain_sddmm_path",
    "KernelTables",
    "TransposeTables",
    "RBGP4Linear",
    "RBGP4LinearStacked",
    "RBGP4MatMul",
    "RBGP4Op",
    "get_op",
    "rbgp4mm",
    "rbgp4mm_reference",
    "rbgp4_sddmm",
    "rbgp4_sddmm_reference",
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
