"""A rank's share of a compact layout's kernel tables, on the CPU.

``KernelTables.rank_slice`` cuts a layout's tables to one rank's rows
(column-parallel: sub-groups of gcd(G, M/n) rows) or compact columns
(row-parallel: sub-slots of gcd(C, S*C/n) columns), and the share's plain
version (``gather_mm_rhs_col0``, reading ``col0`` as the kernels do)
must give the unsharded product's rows, or partials that sum to it in
rank order; stacked experts are cut by expert over one layout; int8 leaf
blocks are cut with their scales.  ``ChainTables.rank_slice`` cuts a chain
layout's table the same way (rows: sub-groups of gcd(G, M/n) rows; slots:
sub-chunks of gcd(C, S*C/n) columns) and recomputes the share's row-group
classes from its own ``col0``; ``chainmm_rhs``'s plain version must give
the same rows and rank-ordered sums, over ``chip_smoke.SMALL_CHAINS`` and
a reduced hierarchical-block chain (``chip_smoke.HIER`` at 512 x 256, a 8
x 8 leaf).  Tolerance: 1e-5 * max|ref| in float32 (the sums' order only).
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import (ChainLayout, RBGP4Layout, design_rbgp,
                              design_rbgp4)
from repro_torch.kernels import (RankSlice, chain_tables, chainmm_rhs,
                                 get_op, rbgp4mm_rhs, rbgp4mm_rhs_stacked)
from repro_torch.sparsity.quant import leaf_block_dims, quantize_block_values

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

torch.set_num_threads(1)
RTOL = 1e-5
# (M, K, sparsity): the reduced models' layouts (G 16, C 16 and 32), a
# wider one (C 64), more row groups than ranks, and 11 slots of 16
# columns a row (as tinyllama's down: d_o = 11), whose shares at 4 and 8
# ranks cut slots
LAYOUTS = [(64, 64, 0.5), (128, 64, 0.5), (64, 128, 0.5), (256, 512, 0.75),
           (512, 256, 0.875), (128, 1408, 0.75)]
# (M, K, factors) of the chains at 0.875: G = C = 1 (3ram), 2 (hier) and
# 8 (hier-reduced, whose 32 stored columns a row cut into sub-chunks of 4
# at 8 ranks)
CHAINS = {**chip_smoke.SMALL_CHAINS,
          "hier-reduced": (512, 256, chip_smoke.HIER)}


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


@pytest.fixture(scope="module", params=list(CHAINS))
def chain_case(request):
    m, k, factors = CHAINS[request.param]
    tables = chain_tables(ChainLayout(design_rbgp(m, k, 0.875,
                                                  factors=factors, seed=0)),
                          "cpu")
    g = torch.Generator().manual_seed(m + k + 1)
    w = torch.randn(tables.m, tables.data_cols, generator=g)
    x = torch.randn(9, k, generator=g)
    return tables, w, x


@pytest.mark.parametrize("n", [2, 4])
def test_chain_row_shares_give_the_unsharded_rows(chain_case, n):
    tables, w, x = chain_case
    want = chainmm_rhs(tables, x, w)
    for r in range(n):
        s = tables.rank_slice("rows", r, n)
        m = tables.m // n
        assert isinstance(s, RankSlice) and (s.lo, s.hi) == (r * m,
                                                           (r + 1) * m)
        assert s.tables.m == m and s.tables.dims.m == m
        close(chainmm_rhs(s.tables, x, s.values(w)), want[:, s.lo:s.hi])


@pytest.mark.parametrize("n", [2, 4, 8])
def test_chain_slot_shares_sum_to_the_unsharded_product_in_rank_order(
        chain_case, n):
    tables, w, x = chain_case
    want = chainmm_rhs(tables, x, w)
    acc = None
    for r in range(n):
        s = tables.rank_slice("slots", r, n)
        assert s.tables.data_cols == tables.data_cols // n
        assert s.tables.dims.d_head * s.tables.dims.inner == \
            s.tables.data_cols
        part = chainmm_rhs(s.tables, x, s.values(w))
        acc = part if acc is None else acc + part
    close(acc, want)


@pytest.mark.parametrize("kind", ["rows", "slots"])
@pytest.mark.parametrize("n", [2, 4])
def test_chain_share_classes_are_those_of_its_cut_table(chain_case, kind,
                                                        n):
    """Every share's classes equal ``np.unique`` of its ``col0``: each
    class's row groups read its one ``col0`` row, in increasing order."""
    tables, _, _ = chain_case
    for r in range(n):
        t = tables.rank_slice(kind, r, n).tables
        c0 = t.col0.numpy()
        rows, counts = np.unique(c0, axis=0, return_counts=True)
        cl = t.classes
        np.testing.assert_array_equal(cl.col0.numpy(), rows)
        assert cl.sizes == tuple(int(c) for c in counts)
        start, groups = cl.start.numpy(), cl.groups.numpy()
        assert sorted(groups.tolist()) == list(range(t.m // t.group_rows))
        for c in range(cl.n_classes):
            own = groups[start[c]:start[c + 1]]
            assert (np.diff(own) > 0).all()
            assert (c0[own] == rows[c]).all()


@pytest.mark.parametrize("kind", ["rows", "slots"])
def test_chain_int8_shares_keep_their_leaf_blocks_scales(chain_case, kind):
    tables, w, x = chain_case
    q, scales = quantize_block_values(w, *leaf_block_dims(tables))
    want = chainmm_rhs(tables, x, q, scales=scales)
    acc = None
    for r in range(4):
        s = tables.rank_slice(kind, r, 4)
        got = chainmm_rhs(s.tables, x, s.values(q), scales=s.scales(scales))
        if kind == "rows":
            close(got, want[:, s.lo:s.hi])
        acc = got if acc is None else acc + got
    if kind == "slots":
        close(acc, want)


def test_chain_part_of_a_row_group_and_of_a_chunk_read_their_parents():
    m, k, factors = CHAINS["hier-reduced"]
    tables = chain_tables(ChainLayout(design_rbgp(m, k, 0.875,
                                                  factors=factors, seed=0)),
                          "cpu")
    G, C = tables.group_rows, tables.chunk_cols
    s = tables.rank_slice("rows", 3, m // (G // 2))   # half a row group
    assert s.tables.group_rows == G // 2 and s.scale_index == (1,)
    assert torch.equal(s.tables.col0, tables.col0[1:2])
    s = tables.rank_slice("slots", 2, tables.data_cols // (C // 4))
    assert s.tables.chunk_cols == C // 4 and s.scale_index == (0,)
    assert torch.equal(s.tables.col0, tables.col0[:, :1] + 2 * (C // 4))
    assert tables.rank_slice("rows", 0, 3) is None
    assert tables.rank_slice("slots", 0, 3) is None
    with pytest.raises(ValueError):
        tables.rank_slice("cols", 0, 2)


@pytest.fixture(scope="module")
def phase_52_cases():
    return [c for c in chip_smoke.shard_cases() if c[2] != "experts"]


@pytest.mark.parametrize("n", chip_smoke.SHARD_MODELS)
def test_every_full_width_share_of_the_card_check_is_a_kernel_operand(
        phase_52_cases, n):
    """Phase 52's shares of the full-width layouts (tinyllama's, deepseek-v2's
    MLA projections, tinyllama's chains): each rank's share exists, its
    tables tile its rows and stored columns, and it takes the tensor-core
    body in bf16 at 512 rows and the FMA body at decode's 8 and in
    float32 (no share falls back to anything else)."""
    from repro_torch.kernels import (KernelTables, chain_rhs_path,
                                     chain_tables, rhs_path)

    for name, lay, kind, family in phase_52_cases:
        chain = family == "chain"
        tables = (chain_tables(lay, "cpu") if chain
                  else KernelTables.build(lay, "cpu"))
        for r in range(n):
            s = tables.rank_slice(kind, r, n)
            assert s is not None, (name, n, r)
            t = s.tables
            if chain:
                path = lambda rows, dt: chain_rhs_path(t, rows, dt)
                m, G, C, cols = t.m, t.group_rows, t.chunk_cols, t.data_cols
            else:
                path = lambda rows, dt: rhs_path(t.dims, rows, dt)
                d = t.dims
                m, G, C, cols = d.m, d.group_rows, d.chunk_cols, d.data_cols
            assert m % G == 0 and cols % C == 0, (name, n, r)
            assert tuple(t.col0.shape) == (m // G, cols // C)
            assert path(512, torch.bfloat16) == "mma", (name, n, r, G, C)
            assert path(8, torch.bfloat16) == "fma"
            assert path(512, torch.float32) == "fma"
