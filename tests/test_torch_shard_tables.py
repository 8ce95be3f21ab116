"""A rank's share of a compact layout's kernel tables, on the CPU.

``KernelTables.rank_slice`` cuts a layout's tables to one rank's rows
(column-parallel: sub-groups of gcd(G, M/n) rows) or compact columns
(row-parallel: sub-slots of gcd(C, S*C/n) columns), and the share's plain
version (``gather_mm_rhs_col0``, reading ``col0`` as the kernels do)
must give the unsharded product's rows, or partials that sum to it in
rank order; stacked experts are cut by expert over one layout; int8 leaf
blocks are cut with their scales.  Tolerance: 1e-5 * max|ref| in float32
(the sums' order only).
"""
import numpy as np
import pytest
import torch

from repro_torch.core import RBGP4Layout, design_rbgp4
from repro_torch.kernels import (RankSlice, get_op, rbgp4mm_rhs,
                                 rbgp4mm_rhs_stacked)
from repro_torch.sparsity.quant import leaf_block_dims, quantize_block_values

torch.set_num_threads(1)
RTOL = 1e-5
# (M, K, sparsity): the reduced models' layouts (G 16, C 16 and 32), a
# wider one (C 64), more row groups than ranks, and 11 slots of 16
# columns a row (as tinyllama's down: d_o = 11), whose shares at 4 and 8
# ranks cut slots
LAYOUTS = [(64, 64, 0.5), (128, 64, 0.5), (64, 128, 0.5), (256, 512, 0.75),
           (512, 256, 0.875), (128, 1408, 0.75)]


def close(got, want):
    err = float((got.double() - want.double()).abs().max())
    assert err <= RTOL * float(want.abs().max()), err


@pytest.fixture(scope="module", params=LAYOUTS, ids=lambda p: "x".join(
    map(str, p)))
def case(request):
    m, k, sp = request.param
    tables = get_op(RBGP4Layout(design_rbgp4(m, k, sp)), "cpu").tables
    g = torch.Generator().manual_seed(m + k)
    w = torch.randn(tables.dims.m, tables.dims.data_cols, generator=g)
    x = torch.randn(9, k, generator=g)
    return tables, w, x


@pytest.mark.parametrize("n", [2, 4, 8])
def test_row_shares_give_the_unsharded_rows(case, n):
    tables, w, x = case
    want = rbgp4mm_rhs(tables, x, w)
    shares = [tables.rank_slice("rows", r, n) for r in range(n)]
    assert all(isinstance(s, RankSlice) for s in shares)
    for r, s in enumerate(shares):
        m = tables.dims.m // n
        assert (s.lo, s.hi) == (r * m, (r + 1) * m)
        assert s.tables.dims.m == m and s.tables.adj_o is None
        assert s.tables.classes.groups.numel() == m // s.tables.dims.group_rows
        close(rbgp4mm_rhs(s.tables, x, s.values(w)), want[:, s.lo:s.hi])


@pytest.mark.parametrize("n", [2, 4, 8])
def test_slot_shares_sum_to_the_unsharded_product_in_rank_order(case, n):
    tables, w, x = case
    want = rbgp4mm_rhs(tables, x, w)
    parts = []
    for r in range(n):
        s = tables.rank_slice("slots", r, n)
        assert s.values(w).shape == (tables.dims.m, tables.dims.data_cols // n)
        assert s.tables.dims.data_cols == tables.dims.data_cols // n
        parts.append(rbgp4mm_rhs(s.tables, x, s.values(w)))
    acc = parts[0]
    for p in parts[1:]:
        acc = acc + p
    close(acc, want)


@pytest.mark.parametrize("kind", ["rows", "slots"])
def test_int8_shares_keep_their_leaf_blocks_scales(case, kind):
    tables, w, x = case
    q, scales = quantize_block_values(w, *leaf_block_dims(tables))
    want = rbgp4mm_rhs(tables, x, q, scales=scales)
    n = 4
    parts = []
    for r in range(n):
        s = tables.rank_slice(kind, r, n)
        got = rbgp4mm_rhs(s.tables, x, s.values(q), scales=s.scales(scales))
        if kind == "rows":
            close(got, want[:, s.lo:s.hi])
        parts.append(got)
    if kind == "slots":
        acc = parts[0]
        for p in parts[1:]:
            acc = acc + p
        close(acc, want)


@pytest.mark.parametrize("n", [2, 4])
def test_expert_shares_are_the_stacked_product_of_their_experts(case, n):
    tables, w, x = case
    g = torch.Generator().manual_seed(7)
    E = 8
    ws = torch.randn(E, *w.shape, generator=g)
    xs = torch.randn(E, 5, x.shape[1], generator=g)
    want = rbgp4mm_rhs_stacked(tables, xs, ws)
    for r in range(n):
        lo, hi = r * E // n, (r + 1) * E // n
        close(rbgp4mm_rhs_stacked(tables, xs[lo:hi], ws[lo:hi]),
              want[lo:hi])
    q, scales = quantize_block_values(ws, *leaf_block_dims(tables))
    want = rbgp4mm_rhs_stacked(tables, xs, q, scales=scales)
    close(rbgp4mm_rhs_stacked(tables, xs[2:4], q[2:4], scales=scales[2:4]),
          want[2:4])


def test_part_of_a_row_group_and_of_a_slot_read_their_parents_columns():
    tables = get_op(RBGP4Layout(design_rbgp4(64, 64, 0.5)), "cpu").tables
    G, C = tables.dims.group_rows, tables.dims.chunk_cols
    n = 64 // (G // 2)          # each rank half a row group
    s = tables.rank_slice("rows", 1, n)
    assert s.tables.dims.group_rows == G // 2
    assert torch.equal(s.tables.col0, tables.col0[:1])
    n = tables.dims.data_cols // (C // 4)   # each rank a quarter of a slot
    s = tables.rank_slice("slots", 2, n)
    assert s.tables.dims.chunk_cols == C // 4
    assert torch.equal(s.tables.col0, tables.col0[:, :1] + 2 * (C // 4))


def test_a_share_that_is_no_whole_operand_is_refused():
    tables = get_op(RBGP4Layout(design_rbgp4(64, 64, 0.5)), "cpu").tables
    assert tables.rank_slice("rows", 0, 3) is None
    assert tables.rank_slice("slots", 0, 3) is None
    with pytest.raises(ValueError):
        tables.rank_slice("cols", 0, 2)
    np.testing.assert_array_equal(
        tables.rank_slice("rows", 0, 1).tables.col0.numpy(),
        tables.col0.numpy())
