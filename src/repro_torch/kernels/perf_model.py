"""Data-sheet roofline model of the RBGP4 and chain products on the H100.

The port of ``repro/kernels/perf_model.py``, with the reference's formulas
and the H100's machine constants in place of the TPU's.  It is a model
from the data sheet, not a measurement, and no launch's tile depends on
it: ``sparsity.solve_budget(cost_model="perf_model")`` weighs modeled
kernel time with it, the autotuner records its estimate beside each
resolution (``kernels/autotune.py``, ``obs/kernelstats.py``), and
``chip_smoke.py`` takes its memory rate and bf16 peak for every bound it
prints.

  memory time   = (W reads + I reads + O writes) / HBM_BW
    W: nnz * bytes, read once per N-tile pass (``block_n`` divides the
       W re-stream count);
    I: each output tile consumes d_o input tiles (G_o sparsity skips the
       zero tiles);
    O: M*N written once.
  compute time  = 2*M*N*nnz_row / (PEAK * u_rows * u_contract)
    tensor-core packing of each inner product (G x d_i*C) @ (d_i*C x BN)
    in ``mma.sync`` m16n8k16 tiles, the shape the port's bodies issue:
    rows pack into MMA_ROWS-row tiles (u_rows = G / roundup(G, 16)), the
    contraction into MMA_K-deep steps (u_k = d_i*C / roundup(d_i*C, 16)).

time = max(memory, compute) (+ both reported).
"""
from __future__ import annotations

import dataclasses

__all__ = [
    "PEAK_FLOPS",
    "HBM_BW",
    "MMA_ROWS",
    "MMA_K",
    "KernelEstimate",
    "estimate_rbgp4mm",
    "estimate_rbgp4mm_dims",
    "estimate_chainmm",
    "estimate_chain_spec",
    "estimate_dense",
    "estimate_unstructured",
]

#: dense bf16 tensor-core peak of the H100 SXM, data sheet (FLOP/s)
PEAK_FLOPS = 989e12
#: HBM3 memory rate of the H100 SXM, data sheet (bytes/s)
HBM_BW = 3.35e12
#: rows and contraction depth of one ``mma.sync.m16n8k16`` tile
MMA_ROWS = 16
MMA_K = 16


def _round_up(x, m):
    return ((x + m - 1) // m) * m


@dataclasses.dataclass
class KernelEstimate:
    flops: float
    bytes_w: float
    bytes_i: float
    bytes_o: float
    u_rows: float
    u_contract: float
    t_compute_s: float
    t_memory_s: float

    @property
    def t_total_s(self) -> float:
        return max(self.t_compute_s, self.t_memory_s)

    @property
    def bytes_total(self) -> float:
        return self.bytes_w + self.bytes_i + self.bytes_o


def _estimate(m_dim: int, tile_m: int, tile_k: int, group_rows: int,
              chunk_cols: int, d_o: int, d_i: int, n: int,
              bytes_per_el: int, block_n: int,
              w_bytes_per_el=None) -> KernelEstimate:
    # w_bytes_per_el: stored-value width when it differs from the
    # activation width (int8 storage: 1 + the per-leaf-block f32 scales,
    # 4/(G*C) bytes amortized per value)
    if w_bytes_per_el is None:
        w_bytes_per_el = bytes_per_el
    elif w_bytes_per_el < bytes_per_el:
        w_bytes_per_el = w_bytes_per_el + 4.0 / (group_rows * chunk_cols)
    nnz_per_row = d_o * d_i * chunk_cols
    nnz = m_dim * nnz_per_row
    flops = 2.0 * m_dim * n * nnz_per_row

    bn = min(block_n, n)
    n_tiles_m = max(m_dim // tile_m, 1)
    n_tiles_n = max(n // bn, 1)
    # W: compact values streamed once per N pass
    bytes_w = nnz * w_bytes_per_el * n_tiles_n
    # I: per output tile, d_o gathered input tiles (zero tiles skipped)
    bytes_i = n_tiles_m * n_tiles_n * d_o * (tile_k * bn) * bytes_per_el
    bytes_o = m_dim * n * bytes_per_el

    u_rows = group_rows / _round_up(group_rows, MMA_ROWS)
    kk = d_i * chunk_cols
    u_contract = kk / _round_up(kk, MMA_K)
    t_comp = flops / (PEAK_FLOPS * u_rows * u_contract)
    t_mem = (bytes_w + bytes_i + bytes_o) / HBM_BW
    return KernelEstimate(flops, bytes_w, bytes_i, bytes_o,
                          u_rows, u_contract, t_comp, t_mem)


def estimate_rbgp4mm(
    spec, n: int, *, bytes_per_el: int = 2, block_n: int = 512,
    w_bytes_per_el=None,
) -> KernelEstimate:
    """Cost of O = W_s @ I for W_s (M, K) with RBGP4Spec `spec`, I (K, n).

    ``w_bytes_per_el`` prices the stored values apart from the activations
    (int8 storage: pass 1); the scale reads are folded in.
    """
    return _estimate(spec.m, spec.tile_m, spec.tile_k, spec.group_rows,
                     spec.chunk_cols, spec.d_o, spec.d_i, n,
                     bytes_per_el, block_n, w_bytes_per_el)


def estimate_rbgp4mm_dims(
    dims, n: int, *, bytes_per_el: int = 2, block_n: int = 512,
    w_bytes_per_el=None,
) -> KernelEstimate:
    """Same model over ``KernelDims`` (``KernelTables.dims``).  The
    token-major product moves the same bytes with the two parallel grid
    dims swapped, so one model serves both forms."""
    return _estimate(dims.m, dims.tile_m, dims.tile_k, dims.group_rows,
                     dims.chunk_cols, dims.d_o, dims.d_i, n,
                     bytes_per_el, block_n, w_bytes_per_el)


def estimate_chainmm(
    dims, n: int, *, bytes_per_el: int = 2, block_n: int = 512,
    w_bytes_per_el=None,
) -> KernelEstimate:
    """Cost of the blocked-CSR chain product.

    ``dims`` carries the fields of the reference's ``ChainDims`` (``m``,
    ``tile_m``, ``tile_k``, ``group_rows``, ``chunk_cols``, ``d_o``,
    ``d_i``): the chain product moves the same traffic classes as the
    RBGP4 one (compact W once per token pass, ``d_head`` gathered input
    tiles per output tile, one output write), and its tensor-core packing
    is set by the dense leaf block (``group_rows`` rows) and the per-head-
    slot contraction (``d_i * chunk_cols``), so the shared model applies.
    """
    return _estimate(dims.m, dims.tile_m, dims.tile_k, dims.group_rows,
                     dims.chunk_cols, dims.d_o, dims.d_i, n,
                     bytes_per_el, block_n, w_bytes_per_el)


def estimate_chain_spec(
    spec, n: int, *, bytes_per_el: int = 2, block_n: int = 512,
    w_bytes_per_el=None,
) -> KernelEstimate:
    """Chain estimate straight from an ``RBGPSpec`` (no graph sampling):
    the head tile, the dense leaf block and the per-head-slot contraction
    follow from the factor sizes and degrees alone."""
    fs = spec.factors
    li = len(fs)
    while li > 1 and (fs[li - 1].kind == "complete"
                      or fs[li - 1].sparsity == 0.0):
        li -= 1
    g_rows = 1
    c_cols = 1
    for f in fs[li:]:
        g_rows *= f.n_left
        c_cols *= f.n_right
    d_head = fs[0].d_left
    inner = 1
    for f in fs[1:]:
        inner *= f.d_left
    return _estimate(spec.m, spec.m // fs[0].n_left, spec.k // fs[0].n_right,
                     g_rows, c_cols, d_head, inner // c_cols, n,
                     bytes_per_el, block_n, w_bytes_per_el)


def estimate_dense(m_dim: int, k_dim: int, n: int, *, bytes_per_el: int = 2,
                   block=(512, 512)) -> KernelEstimate:
    """Dense matmul reference (the cuBLAS row of the paper's tables)."""
    bm, bn = block
    flops = 2.0 * m_dim * k_dim * n
    bytes_w = m_dim * k_dim * bytes_per_el * max(n // bn, 1)
    bytes_i = k_dim * n * bytes_per_el * max(m_dim // bm, 1)
    bytes_o = m_dim * n * bytes_per_el
    t_comp = flops / PEAK_FLOPS
    t_mem = (bytes_w + bytes_i + bytes_o) / HBM_BW
    return KernelEstimate(flops, bytes_w, bytes_i, bytes_o, 1.0, 1.0,
                          t_comp, t_mem)


def estimate_unstructured(m_dim: int, k_dim: int, n: int, sparsity: float,
                          *, bytes_per_el: int = 2) -> KernelEstimate:
    """Unstructured CSR SDMM: gather-bound, no tile reuse.

    Every non-zero triggers an uncoalesced row read of I (the paper's 5-9x
    gap); model: I bytes = nnz * bn * bytes (no reuse across rows), plus
    index reads.
    """
    nnz = (1.0 - sparsity) * m_dim * k_dim
    flops = 2.0 * nnz * n
    bytes_w = nnz * (bytes_per_el + 4)  # values + column index
    bytes_i = nnz * n * bytes_per_el / 8  # ~1/8 cache-line utility
    bytes_o = m_dim * n * bytes_per_el
    # scalar-ish compute: no tensor-core packing for random access
    t_comp = flops / (PEAK_FLOPS * 0.05)
    t_mem = (bytes_w + bytes_i + bytes_o) / HBM_BW
    return KernelEstimate(flops, bytes_w, bytes_i, bytes_o, 0.05, 1.0,
                          t_comp, t_mem)
