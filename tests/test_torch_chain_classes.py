"""The row-group classes of the chain tables, which the tensor-core
bodies of ``chain_sddmm_rhs`` and ``chainmm_rhs`` walk: the row groups
whose ``col0`` rows are equal.  A wrong class table gives plausible
numbers, so it is held here, on the CPU, at tinyllama-1.1b's four shapes
under the hierarchical-block plan and the two small chains of the CPU
tests (``chip_smoke.chain_layouts``), forward and transposed tables; a
plain-torch walk of the dW body's class tiles (64 class rows by 64 stored
columns, gathered through the class tables as the kernel gathers them)
must give ``chain_sddmm_rhs_reference``'s dW, and one of the forward
body's (128 tokens by ``chain_rhs_tile_rows`` class rows, the stored
columns in stages of 64) ``chainmm_rhs_reference``'s Y, on the forward
and the transposed tables, each within 1e-5 * max|ref| in float32
(summation order only).
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import (chain_rhs_tile_rows,
                                 chain_sddmm_rhs_reference, chain_tables,
                                 chain_transpose_tables,
                                 chainmm_rhs_reference)
from repro_torch.kernels.chainmm import (CHAIN_RHS_MMA_BLOCK_TOKENS,
                                         CHAIN_SDDMM_MMA_TILE)

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

torch.set_num_threads(1)
KEYS = list(chip_smoke.FULL_WIDTH) + list(chip_smoke.SMALL_CHAINS)
# distinct col0 rows of the forward tables (the ones dW reads)
CLASS_COUNTS = {"wq/wo": 32, "wk/wv": 8, "gate/up": 8, "down": 8,
                "3ram": 128, "hier": 16}


@pytest.fixture(scope="module")
def layouts():
    return chip_smoke.chain_layouts()


def tables_of(layouts, key, side):
    lay = layouts[key]
    if side == "forward":
        return chain_tables(lay, "cpu")
    return chain_transpose_tables(lay, "cpu").tables


@pytest.mark.parametrize("key", KEYS)
@pytest.mark.parametrize("side", ["forward", "transposed"])
def test_classes_partition_the_row_groups_by_col0_row(layouts, key, side):
    t = tables_of(layouts, key, side)
    cl = t.classes
    col0 = t.col0.numpy()
    groups, start = cl.groups.numpy(), cl.start.numpy()
    n_groups = t.m // t.group_rows
    assert cl.col0.dtype == cl.groups.dtype == cl.start.dtype == torch.int32
    assert start[0] == 0 and start[-1] == n_groups
    assert np.all(np.diff(start) >= 1)
    # every row group in exactly one class
    assert np.array_equal(np.sort(groups), np.arange(n_groups))
    assert cl.max_groups == int(np.diff(start).max())
    for c in range(cl.n_classes):
        members = groups[start[c]:start[c + 1]]
        assert np.all(np.diff(members) > 0), "increasing within a class"
        # each member's col0 row is the class's row
        assert np.array_equal(col0[members],
                              np.broadcast_to(cl.col0.numpy()[c],
                                              (len(members), t.n_chunks)))
    # and no two classes share a row
    assert len(np.unique(cl.col0.numpy(), axis=0)) == cl.n_classes


@pytest.mark.parametrize("key", KEYS)
def test_class_counts(layouts, key):
    """tinyllama's layouts: 32 / 8 / 8 / 8 classes among 256 / 32 / 352 /
    64 row groups (the complete 4x4 head and the complete leaf give whole
    sets of row groups one column set); the chain with no complete factor
    (G = C = 1) has one row group a class."""
    t = tables_of(layouts, key, "forward")
    assert t.classes.n_classes == CLASS_COUNTS[key]


def walk_class_tiles(t, g, x, tile=CHAIN_SDDMM_MMA_TILE):
    """dW as the tensor-core body computes it, in float32: each class's
    (tile x tile) tiles of class rows by stored columns, rows gathered
    through ``groups`` and columns through the class's ``col0`` row, one
    dense product a tile, written into the rows' own places."""
    cl = t.classes
    G, C = t.group_rows, t.chunk_cols
    groups, start = cl.groups.long(), cl.start.long()
    row_len = t.data_cols
    dw = torch.full((t.m, row_len), float("nan"))
    j = torch.arange(row_len)
    for c in range(cl.n_classes):
        members = groups[start[c]:start[c + 1]]
        rows = (members[:, None] * G + torch.arange(G)).reshape(-1)
        cols = cl.col0[c].long()[j // C] + j % C
        for i0 in range(0, len(rows), tile):
            r = rows[i0:i0 + tile]
            for j0 in range(0, row_len, tile):
                cc = cols[j0:j0 + tile]
                dw[r, j0:j0 + len(cc)] = g[:, r].T @ x[:, cc]
    return dw


@pytest.mark.parametrize("key", KEYS)
def test_class_tile_walk_matches_the_plain_version(layouts, key):
    t = tables_of(layouts, key, "forward")
    rng = np.random.default_rng(0)
    n = 37
    g = torch.tensor(rng.standard_normal((n, t.m)), dtype=torch.float32)
    x = torch.tensor(rng.standard_normal((n, t.k)), dtype=torch.float32)
    got = walk_class_tiles(t, g, x)
    want = chain_sddmm_rhs_reference(t, g, x)
    assert not torch.isnan(got).any(), "a stored value no tile wrote"
    err = float((got - want).abs().max())
    assert err <= 1e-5 * float(want.abs().max()), (key, err)


def walk_forward_class_tiles(t, x, w, stage=64):
    """Y = X @ W_s^T as the forward's tensor-core body computes it, in
    float32: each class's tiles of ``CHAIN_RHS_MMA_BLOCK_TOKENS`` tokens by
    ``chain_rhs_tile_rows`` class rows (rows gathered through ``groups``,
    rows past the class left out), X gathered at the class's one ``col0``
    row, the R stored columns in stages of ``stage`` (the last one
    zero-filled), each stage one dense product added to the tile's sums;
    written into the rows' own places of Y."""
    cl = t.classes
    G, C = t.group_rows, t.chunk_cols
    groups, start = cl.groups.long(), cl.start.long()
    row_len = t.data_cols
    bm, br = CHAIN_RHS_MMA_BLOCK_TOKENS, chain_rhs_tile_rows(t)
    n = x.shape[0]
    y = torch.full((n, t.m), float("nan"))
    j = torch.arange(row_len)
    for c in range(cl.n_classes):
        members = groups[start[c]:start[c + 1]]
        rows = (members[:, None] * G + torch.arange(G)).reshape(-1)
        cols = cl.col0[c].long()[j // C] + j % C
        xg = x[:, cols]                          # (N, R), gathered once
        for i0 in range(0, len(rows), br):
            r = rows[i0:i0 + br]
            for n0 in range(0, n, bm):
                acc = torch.zeros((min(bm, n - n0), len(r)))
                for k0 in range(0, row_len, stage):
                    xs = torch.zeros((acc.shape[0], stage))
                    ws = torch.zeros((len(r), stage))
                    kw = min(stage, row_len - k0)
                    xs[:, :kw] = xg[n0:n0 + bm, k0:k0 + kw]
                    ws[:, :kw] = w[r, k0:k0 + kw]
                    acc += xs @ ws.T
                y[n0:n0 + bm, r] = acc
    return y


@pytest.mark.parametrize("key", KEYS)
@pytest.mark.parametrize("side", ["forward", "transposed"])
def test_forward_class_tile_walk_matches_the_plain_version(layouts, key,
                                                           side):
    t = tables_of(layouts, key, side)
    rng = np.random.default_rng(1)
    n = 141  # a whole 128-token tile and a ragged one
    x = torch.tensor(rng.standard_normal((n, t.k)), dtype=torch.float32)
    w = torch.tensor(rng.standard_normal((t.m, t.data_cols)),
                     dtype=torch.float32)
    got = walk_forward_class_tiles(t, x, w)
    want = chainmm_rhs_reference(t, x, w)
    assert not torch.isnan(got).any(), "an output no tile wrote"
    err = float((got - want).abs().max())
    assert err <= 1e-5 * float(want.abs().max()), (key, side, err)
