"""ChainWeight: blocked-CSR storage of a deep RBGP product chain.

The port of ``repro/sparsity/chain.py``.  A product chain with more than
two sparse Ramanujan factors has no RBGP4 layout; its weight is stored as

  * ``w_data`` — values only at the product's non-zeros, (M, prod_j d_j):
    every row holds the same number of values (each factor is regular), so
    the row pointers of the CSR are implicit;
  * the layout's kernel table (``ChainTables``, built once per layout on
    the layer's device) in place of the reference's static ``ChainLayout``
    aux: it is what the kernels read, and nothing a checkpoint stores.

``sparse_linear`` runs it on ``chainmm_rhs`` (and ``ChainLinear`` where a
gradient is asked for).  Chains have no stacked-expert storage, as in the
reference: MoE experts stay on RBGP4.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from repro_torch.kernels import ChainTables, ChainTransposeTables

__all__ = ["ChainWeight", "chain_storage_bytes"]


@dataclasses.dataclass
class ChainWeight:
    """Chain storage: ``w_data`` (M, nnz_row), the layout's ``tables``, an
    optional bias ``b`` (M,), and ``tables_t``, which returns the tables of
    the transposed layout (built once by the owning module); it is called
    only when the input needs a gradient."""

    w_data: torch.Tensor
    tables: ChainTables
    b: Optional[torch.Tensor] = None
    tables_t: Optional[Callable[[], ChainTransposeTables]] = None


def chain_storage_bytes(layout, *, value_bytes: int = 4,
                        index_bytes: int = 4) -> dict:
    """Index + value storage of one chain layer against its masked
    emulation (dense values and a full (M, K) uint8 mask)."""
    mem = layout.memory_bytes(value_bytes=value_bytes,
                              index_bytes=index_bytes)
    dense = layout.m * layout.k
    masked = dense * value_bytes + dense  # values + uint8 mask
    return {
        "chain_values": mem["values"],
        "chain_index": mem["index_succinct"],
        "chain_total": mem["total"],
        "masked_values": dense * value_bytes,
        "masked_mask": dense,
        "masked_total": masked,
        "ratio": mem["total"] / masked,
    }
