"""Plain PyTorch versions of the RBGP4 compact-storage products.

The port of ``repro/kernels/ref.py``.  These are the kernels' plain
versions: the CPU path runs them, and the card compares its kernels with
them.  ``ref_masked_mm`` is the dense-masked product of masked storage,
which runs no kernel of its own on any device.
"""
from __future__ import annotations

import torch

__all__ = ["unpack_dense", "pack_compact", "gather_mm_rhs",
           "gather_sddmm_rhs", "gather_mm_rhs_stacked",
           "gather_sddmm_rhs_stacked", "compact_gather_mm_rhs",
           "gather_mm_rhs_col0", "gather_sddmm_rhs_col0", "gather_mm",
           "gather_sddmm", "compact_gather_mm", "ref_rbgp4mm",
           "ref_rbgp4_sddmm", "ref_masked_mm", "dequant_leaf_blocks"]


def _col_index(layout, device) -> torch.Tensor:
    """(M, nnz_row) int64 dense-column index of each compact slot."""
    return torch.as_tensor(layout._col_index(), dtype=torch.int64,
                           device=device)


def dequant_leaf_blocks(q: torch.Tensor, scales: torch.Tensor, G: int,
                        C: int) -> torch.Tensor:
    """float32 values of int8 leaf blocks: ``q`` (..., M, S*C) times its
    per-(G, C)-block ``scales`` (..., M/G, S), ``q.float() * scale`` in
    float32, as the int8 kernels dequantize before their sums."""
    *lead, m, nc = q.shape
    qr = q.float().reshape(*lead, m // G, G, nc // C, C)
    return (qr * scales.float()[..., :, None, :, None]).reshape(q.shape)


def unpack_dense(layout, w_data: torch.Tensor) -> torch.Tensor:
    """Scatter compact Wdata (..., M, nnz_row) to dense (..., M, K) with
    zeros off-mask (a leading expert dim stacks experts of one layout)."""
    lead = w_data.shape[:-2]
    ci = _col_index(layout, w_data.device).expand(*lead, -1, -1)
    dense = torch.zeros((*lead, layout.m, layout.k), dtype=w_data.dtype,
                        device=w_data.device)
    return dense.scatter_(-1, ci, w_data.reshape(*lead, layout.m, -1))


def pack_compact(layout, w_dense: torch.Tensor) -> torch.Tensor:
    """Gather the masked values of dense (..., M, K) into compact
    (..., M, nnz_row)."""
    ci = _col_index(layout, w_dense.device)
    return torch.gather(w_dense, -1, ci.expand(*w_dense.shape[:-2], -1, -1))


def _gather_x(adj_o, adj_i, n_o_r: int, chunk_cols: int,
              x: torch.Tensor) -> torch.Tensor:
    """(..., N, n_o_l, d_o, u_i, d_i, C): the input columns each compact
    slot multiplies, for x (..., N, K)."""
    adj_o = torch.as_tensor(adj_o, dtype=torch.int64, device=x.device)
    adj_i = torch.as_tensor(adj_i, dtype=torch.int64, device=x.device)
    v_i = x.shape[-1] // (n_o_r * chunk_cols)
    xt = x.reshape(*x.shape[:-1], n_o_r, v_i, chunk_cols)
    return xt[..., adj_o, :, :][..., adj_i, :]


def gather_mm_rhs(adj_o, adj_i, n_o_r: int, group_rows: int,
                  chunk_cols: int, w_data: torch.Tensor,
                  x: torch.Tensor) -> torch.Tensor:
    """Y (N, M) = X (N, K) @ W_s^T from compact storage, gather + einsum.

    ``adj_o`` (n_o_l, d_o) and ``adj_i`` (u_i, d_i) are the factor
    adjacency lists (int64 tensors on the device of ``x`` cost no copy);
    output row ``m = (o, u, g)`` contracts compact slot
    ``(kk, ki, c)`` against input column
    ``adj_o[o, kk] * TK + adj_i[u, ki] * C + c``.
    """
    xg = _gather_x(adj_o, adj_i, n_o_r, chunk_cols, x)
    n, n_o_l, d_o, u_i, d_i, C = xg.shape
    w = w_data.reshape(n_o_l, u_i, group_rows, d_o, d_i, C)
    out = torch.einsum("nokuic,ougkic->noug", xg, w)
    return out.reshape(n, n_o_l * u_i * group_rows)


def gather_mm_rhs_col0(col0: torch.Tensor, group_rows: int,
                       chunk_cols: int, w_data: torch.Tensor,
                       x: torch.Tensor) -> torch.Tensor:
    """Y (..., N, M) = X (..., N, K) @ W_s^T read through a ``col0`` table
    alone, as the kernels read it: row ``rg*G + g`` contracts compact slot
    ``s*C + c`` against input column ``col0[rg, s] + c``.  It takes a
    rank's slice of a layout's tables (``KernelTables.rank_slice``), whose
    rows or slots need not form an RBGP4 layout of their own; a leading
    dim of ``w_data`` and ``x`` stacks experts of one table."""
    c = torch.arange(chunk_cols, dtype=torch.int64, device=x.device)
    cols = (col0.to(device=x.device, dtype=torch.int64)[..., None]
            + c).reshape(col0.shape[0], -1)               # (M/G, S*C)
    xg = x[..., cols]                                     # (..., N, M/G, S*C)
    w = w_data.reshape(*w_data.shape[:-2], col0.shape[0], group_rows,
                       cols.shape[1])
    out = torch.einsum("...nrs,...rgs->...nrg", xg, w)
    return out.reshape(*out.shape[:-2], -1)


def gather_sddmm_rhs(adj_o, adj_i, n_o_r: int, group_rows: int,
                     chunk_cols: int, g: torch.Tensor,
                     x: torch.Tensor) -> torch.Tensor:
    """Compact dW (M, nnz_row) = pack(g^T @ x) from token-major g (N, M)
    and x (N, K), gather + einsum: slot ``(kk, ki, c)`` of row
    ``m = (o, u, gi)`` sums ``g[n, m] * x[n, adj_o[o, kk] * TK +
    adj_i[u, ki] * C + c]`` over tokens ``n``."""
    xg = _gather_x(adj_o, adj_i, n_o_r, chunk_cols, x)
    n, n_o_l, d_o, u_i, d_i, C = xg.shape
    gg = g.reshape(n, n_o_l, u_i, group_rows)
    dw = torch.einsum("nokuic,noug->ougkic", xg, gg)
    return dw.reshape(n_o_l * u_i * group_rows, d_o * d_i * C)


def gather_sddmm_rhs_col0(col0: torch.Tensor, group_rows: int,
                          chunk_cols: int, g: torch.Tensor,
                          x: torch.Tensor) -> torch.Tensor:
    """Compact dW (M, S*C) = pack(g^T @ x) read through a ``col0`` table
    alone (``gather_mm_rhs_col0``'s layout): slot ``s*C + c`` of row
    ``rg*G + gi`` sums ``g[n, rg*G + gi] * x[n, col0[rg, s] + c]``."""
    c = torch.arange(chunk_cols, dtype=torch.int64, device=x.device)
    cols = (col0.to(device=x.device, dtype=torch.int64)[..., None]
            + c).reshape(col0.shape[0], -1)               # (M/G, S*C)
    xg = x[:, cols]                                       # (N, M/G, S*C)
    gg = g.reshape(g.shape[0], col0.shape[0], group_rows)
    dw = torch.einsum("nrs,nrg->rgs", xg, gg)
    return dw.reshape(col0.shape[0] * group_rows, cols.shape[1])


def gather_mm_rhs_stacked(adj_o, adj_i, n_o_r: int, group_rows: int,
                          chunk_cols: int, w_data: torch.Tensor,
                          x: torch.Tensor) -> torch.Tensor:
    """Y (E, N, M) = X[e] (N, K) @ W_s[e]^T for every expert e of stacked
    compact values w_data (E, M, nnz_row) over one layout:
    ``gather_mm_rhs`` with the expert as a batch dimension."""
    xg = _gather_x(adj_o, adj_i, n_o_r, chunk_cols, x)
    e, n, n_o_l, d_o, u_i, d_i, C = xg.shape
    w = w_data.reshape(e, n_o_l, u_i, group_rows, d_o, d_i, C)
    out = torch.einsum("enokuic,eougkic->enoug", xg, w)
    return out.reshape(e, n, n_o_l * u_i * group_rows)


def gather_sddmm_rhs_stacked(adj_o, adj_i, n_o_r: int, group_rows: int,
                             chunk_cols: int, g: torch.Tensor,
                             x: torch.Tensor) -> torch.Tensor:
    """Stacked compact dW (E, M, nnz_row) = pack(g[e]^T @ x[e]) from g
    (E, N, M) and x (E, N, K): ``gather_sddmm_rhs`` with the expert as a
    batch dimension."""
    xg = _gather_x(adj_o, adj_i, n_o_r, chunk_cols, x)
    e, n, n_o_l, d_o, u_i, d_i, C = xg.shape
    gg = g.reshape(e, n, n_o_l, u_i, group_rows)
    dw = torch.einsum("enokuic,enoug->eougkic", xg, gg)
    return dw.reshape(e, n_o_l * u_i * group_rows, d_o * d_i * C)


def _gather_i(adj_o, adj_i, n_o_r: int, chunk_cols: int,
              x: torch.Tensor) -> torch.Tensor:
    """(n_o_l, d_o, u_i, d_i, C, N): the input rows each compact slot
    multiplies, for feature-major x (K, N)."""
    adj_o = torch.as_tensor(adj_o, dtype=torch.int64, device=x.device)
    adj_i = torch.as_tensor(adj_i, dtype=torch.int64, device=x.device)
    v_i = x.shape[0] // (n_o_r * chunk_cols)
    xt = x.reshape(n_o_r, v_i, chunk_cols, x.shape[1])
    return xt[adj_o][:, :, adj_i]


def gather_mm(adj_o, adj_i, n_o_r: int, group_rows: int, chunk_cols: int,
              w_data: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """O (M, N) = W_s @ I from compact storage, for feature-major I (K, N),
    gather + einsum (the feature-major twin of ``gather_mm_rhs``): output
    row ``m = (o, u, g)`` contracts compact slot ``(kk, ki, c)`` against
    input row ``adj_o[o, kk] * TK + adj_i[u, ki] * C + c``."""
    xg = _gather_i(adj_o, adj_i, n_o_r, chunk_cols, x)
    n_o_l, d_o, u_i, d_i, C, n = xg.shape
    w = w_data.reshape(n_o_l, u_i, group_rows, d_o, d_i, C)
    out = torch.einsum("ougkic,okuicn->ougn", w, xg)
    return out.reshape(n_o_l * u_i * group_rows, n)


def gather_sddmm(adj_o, adj_i, n_o_r: int, group_rows: int,
                 chunk_cols: int, d_out: torch.Tensor,
                 x: torch.Tensor) -> torch.Tensor:
    """Compact dW (M, nnz_row) = pack(dO @ I^T) from feature-major dO
    (M, N) and I (K, N), gather + einsum: slot ``(kk, ki, c)`` of row
    ``m = (o, u, gi)`` sums ``dO[m, n] * I[adj_o[o, kk] * TK +
    adj_i[u, ki] * C + c, n]`` over columns ``n``."""
    xg = _gather_i(adj_o, adj_i, n_o_r, chunk_cols, x)
    n_o_l, d_o, u_i, d_i, C, n = xg.shape
    gg = d_out.reshape(n_o_l, u_i, group_rows, n)
    dw = torch.einsum("ougn,okuicn->ougkic", gg, xg)
    return dw.reshape(n_o_l * u_i * group_rows, d_o * d_i * C)


def compact_gather_mm(layout, w_data: torch.Tensor,
                      x: torch.Tensor) -> torch.Tensor:
    """O = W_s @ I from compact storage via gather + einsum, with no dense
    W (the reference's ``xla_compact`` matmul); x (K, N) -> (M, N)."""
    sp = layout.spec
    return gather_mm(layout.adj_o, layout.adj_i, sp.g_o[1], sp.group_rows,
                     sp.chunk_cols, w_data, x)


def ref_rbgp4mm(layout, w_data: torch.Tensor,
                x: torch.Tensor) -> torch.Tensor:
    """O = W_s @ I through the dense scatter of W (oracle)."""
    return unpack_dense(layout, w_data) @ x


def ref_rbgp4_sddmm(layout, d_out: torch.Tensor,
                    x: torch.Tensor) -> torch.Tensor:
    """dW = pack(dO @ I^T) (oracle; the mask is implied by pack)."""
    return pack_compact(layout, d_out @ x.T)


def ref_masked_mm(w_dense: torch.Tensor, mask: torch.Tensor,
                  x: torch.Tensor) -> torch.Tensor:
    """The dense-masked SDMM (W * mask) @ I, the paper's predefined-sparsity
    training path; x (K, N) -> (M, N)."""
    return (w_dense * mask.to(w_dense.dtype)) @ x


def compact_gather_mm_rhs(layout, w_data: torch.Tensor,
                          x: torch.Tensor) -> torch.Tensor:
    """Y = X @ W_s^T from compact storage; X (N, K) token-major -> (N, M)."""
    sp = layout.spec
    return gather_mm_rhs(layout.adj_o, layout.adj_i, sp.g_o[1],
                         sp.group_rows, sp.chunk_cols, w_data, x)
