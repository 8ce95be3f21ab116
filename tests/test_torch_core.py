"""The port's RBGP4 layouts equal the reference's, exactly.

``repro_torch.core`` is a copy of the numpy core of ``repro.core``; the
masks, adjacency lists and compact slot orders must be identical, or the
port would compute another function on the same weights.
"""
import numpy as np
import pytest
import torch

from repro import core as jcore
from repro_torch import core as tcore

torch.set_num_threads(1)

# (m, k, sparsity): the four full-width tinyllama-1.1b shapes at 0.75 and
# the reduced-config shapes
DESIGN_SHAPES = [
    (2048, 2048, 0.75), (256, 2048, 0.75), (5632, 2048, 0.75),
    (2048, 5632, 0.75),
    (64, 64, 0.75), (128, 64, 0.75), (64, 128, 0.75),
    (64, 64, 0.5), (128, 64, 0.5), (64, 128, 0.5),
]

# the tests/test_kernels.py sweep layouts: m, k, sp_o, sp_i, G, C, ui, vi
SWEEP_LAYOUTS = [
    (64, 64, 0.5, 0.5, 4, 4, 4, 4),
    (128, 64, 0.75, 0.0, 4, 8, 4, 2),
    (64, 128, 0.0, 0.5, 8, 8, 2, 4),
    (256, 128, 0.5, 0.75, 8, 8, 4, 4),
    (128, 128, 0.875, 0.0, 4, 8, 4, 2),
    (64, 64, 0.9375, 0.0, 2, 2, 2, 2),
    (32, 32, 0.5, 0.5, 2, 2, 4, 4),
]


def sweep_spec(mod, m, k, sp_o, sp_i, G, C, ui, vi, seed=7):
    return mod.RBGP4Spec(g_o=(m // (ui * G), k // (vi * C)), g_r=(G, C),
                         g_i=(ui, vi), g_b=(1, 1), sp_o=sp_o, sp_i=sp_i,
                         seed=seed)


def assert_same_layout(jl, tl):
    assert dataclass_tuple(jl.spec) == dataclass_tuple(tl.spec)
    np.testing.assert_array_equal(jl.adj_o, tl.adj_o)
    np.testing.assert_array_equal(jl.adj_i, tl.adj_i)
    np.testing.assert_array_equal(jl._col_index(), tl._col_index())
    np.testing.assert_array_equal(jl.transpose_perm(), tl.transpose_perm())


def dataclass_tuple(spec):
    return (spec.g_o, spec.g_r, spec.g_i, spec.g_b, spec.sp_o, spec.sp_i,
            spec.seed)


@pytest.mark.parametrize("m,k,sp", DESIGN_SHAPES)
def test_design_and_layout_match_reference(m, k, sp):
    js = jcore.design_rbgp4(m, k, sp, seed=0)
    ts = tcore.design_rbgp4(m, k, sp, seed=0)
    assert dataclass_tuple(js) == dataclass_tuple(ts)
    assert_same_layout(jcore.RBGP4Layout(js), tcore.RBGP4Layout(ts))


@pytest.mark.parametrize("shape", SWEEP_LAYOUTS)
def test_sweep_layout_matches_reference(shape):
    jl = jcore.RBGP4Layout(sweep_spec(jcore, *shape))
    tl = tcore.RBGP4Layout(sweep_spec(tcore, *shape))
    assert_same_layout(jl, tl)
    np.testing.assert_array_equal(jl.mask(), tl.mask())
    assert_same_layout(jl.transpose_layout(), tl.transpose_layout())


def test_full_width_layout_table():
    """The four layouts the serving kernel runs at full width."""
    want = {  # (m, k): (G, C, d_o, d_i, u_i, v_i, TM, TK, nnz/row)
        (2048, 2048): (16, 128, 2, 2, 64, 8, 1024, 1024, 512),
        (256, 2048): (16, 128, 2, 2, 16, 8, 256, 1024, 512),
        (5632, 2048): (16, 128, 2, 2, 32, 8, 512, 1024, 512),
        (2048, 5632): (16, 64, 11, 2, 64, 8, 1024, 512, 1408),
    }
    for (m, k), row in want.items():
        s = tcore.design_rbgp4(m, k, 0.75, seed=0)
        got = (s.group_rows, s.chunk_cols, s.d_o, s.d_i, s.g_i[0], s.g_i[1],
               s.tile_m, s.tile_k, s.nnz_per_row)
        assert got == row, (m, k, got)
