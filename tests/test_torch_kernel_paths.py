"""Which device body a launch of ``rbgp4mm_rhs``, ``rbgp4mm_rhs_stacked``,
``rbgp4_sddmm_rhs``, ``rbgp4_sddmm_rhs_stacked``, ``chainmm_rhs``,
``chain_sddmm_rhs``, ``rbgp4mm`` and ``rbgp4_sddmm`` takes, the dW
tensor-core bodies' blocks and token-slice plans, the chain forward's
tile rows, the feature-major forward's tiles and contraction split, and
the build's rebuild on a header edit: pure functions of dtype and shape,
checked on the CPU (the kernels themselves run in
``tests/test_torch_cuda.py``).

The layouts are tinyllama-1.1b's four and qwen2-moe-a2.7b's (attention
and the shared expert share tinyllama's widths; the routed experts are
1408 x 2048 and 2048 x 1408), each forward and transposed, from
``design_rbgp4(m, k, 0.75, seed=0)`` as the models build them; and
tinyllama's four shapes under the hierarchical-block chain plan with the
two small chains of the CPU tests (``chip_smoke.chain_layouts``); and
VGG19-CIFAR's seven feature-major layouts with WRN-40-4's 64 x 144
(``chip_smoke.fm_layouts``), forward and transposed.
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import RBGP4Layout, RBGP4Spec, design_rbgp4
from repro_torch.kernels import (FM_MMA_TILES, FM_SDDMM_TILES,
                                 MMA_MIN_TOKENS, KernelDims, KernelTables,
                                 build,
                                 chain_rhs_path, chain_rhs_tile_rows,
                                 chain_tables, chain_transpose_tables,
                                 fm_mma_tile, fm_path,
                                 fm_sddmm_path, fm_sddmm_plan,
                                 fm_sddmm_tile, rhs_path, sddmm_mma_plan,
                                 sddmm_path,
                                 stacked_mma_block_tokens,
                                 stacked_sddmm_mma_plan, stacked_sddmm_tile)
from repro_torch.kernels.chainmm import (CHAIN_SDDMM_MMA_TILE,
                                         chain_sddmm_mma_plan,
                                         chain_sddmm_path)
from repro_torch.kernels.rbgp4mm import STACKED_SDDMM_TILES, _fm_k_steps

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

torch.set_num_threads(1)

# (m, k) of tinyllama's wq/wo, wk/wv, gate/up, down; qwen2-moe's expert
# gate/up and down
TINYLLAMA = [(2048, 2048), (256, 2048), (5632, 2048), (2048, 5632)]
EXPERTS = [(1408, 2048), (2048, 1408)]
H100_SMS = 132


def dims_of(m, k):
    lay = RBGP4Layout(design_rbgp4(m, k, 0.75, seed=0))
    return (KernelDims.from_layout(lay),
            KernelDims.from_layout(lay.transpose_layout()))


@pytest.fixture(scope="module")
def all_dims():
    return {mk: dims_of(*mk) for mk in TINYLLAMA + EXPERTS}


@pytest.mark.parametrize("mk", TINYLLAMA)
@pytest.mark.parametrize("n", [8, 16, 512, 4096])
def test_paths_of_the_unstacked_layouts(all_dims, mk, n):
    """bf16: decode (8 tokens) on the FMA bodies, from 16 tokens (the
    least swept size above decode, where the tensor-core bodies were
    measured the faster) through prefill and a training step on the
    tensor-core bodies, forward and transposed (dX) alike."""
    assert MMA_MIN_TOKENS == 16
    fwd, tr = all_dims[mk]
    want = "fma" if n < MMA_MIN_TOKENS else "mma"
    assert rhs_path(fwd, n, torch.bfloat16) == want
    assert rhs_path(tr, n, torch.bfloat16) == want
    assert sddmm_path(fwd, n, torch.bfloat16) == want


@pytest.mark.parametrize("mk", EXPERTS)
@pytest.mark.parametrize("n", [8, 16, 171, 512])
def test_paths_of_the_stacked_expert_layouts(all_dims, mk, n):
    """``rbgp4mm_rhs_stacked`` takes ``rhs_path``'s body for its rows an
    expert: decode (8 rows) on the FMA body; 16 rows, a training step's
    171 and a full-capacity prefill's 512 on the tensor cores, forward
    (G = 16, C = 128 or 16) and transposed (G = 128 or 16, C = 16)."""
    fwd, tr = all_dims[mk]
    want = "fma" if n < MMA_MIN_TOKENS else "mma"
    for d in (fwd, tr):
        assert d.group_rows in (16, 128) and d.chunk_cols in (16, 128)
        assert rhs_path(d, n, torch.bfloat16) == want


@pytest.mark.parametrize("n,forward", [(16, 64), (77, 128), (128, 128),
                                       (171, 64), (256, 128), (300, 64),
                                       (342, 128), (512, 128)])
def test_stacked_token_tile(n, forward):
    """The stacked tensor-core body's token tile: 64 for dX at every size;
    for the forward 64 only where the last 128-token tile would be at most
    half full (the faster tile at each size the card's sweep timed)."""
    assert stacked_mma_block_tokens(n, transposed=False) == forward
    assert stacked_mma_block_tokens(n, transposed=True) == 64


@pytest.mark.parametrize("mk", TINYLLAMA + EXPERTS)
@pytest.mark.parametrize("n", [8, 512, 4096])
def test_float32_keeps_the_fma_bodies(all_dims, mk, n):
    """No TF32: float32 takes the FMA bodies at every layout and N,
    stacked or not.  (The int8 entry points have no other body; the CUDA
    tests check that their launches leave the tensor-core counters
    alone.)"""
    for d in all_dims[mk]:
        assert rhs_path(d, n, torch.float32) == "fma"
        assert sddmm_path(d, n, torch.float32) == "fma"


@pytest.mark.parametrize("mk", EXPERTS)
@pytest.mark.parametrize("n", [8, 16, 77, 171, 512])
def test_stacked_sddmm_path_and_tile(all_dims, mk, n):
    """The stacked dW takes ``sddmm_path``'s body for its rows an expert:
    the FMA body at decode's 8 rows, the tensor cores from 16 on, in
    bf16 at both expert layouts (G = 16, C = 128 and C = 16); float32
    keeps the FMA body.  Its block is one of the swept tiles, with columns
    the compact row fills at least half of: gate/up's one 128-column slot,
    down's 352 columns in blocks of 128 (eight slots of 16 a block)."""
    fwd, _ = all_dims[mk]
    want = "fma" if n < MMA_MIN_TOKENS else "mma"
    assert sddmm_path(fwd, n, torch.bfloat16) == want
    assert sddmm_path(fwd, n, torch.float32) == "fma"
    tile = stacked_sddmm_tile(fwd, n)
    assert tile in STACKED_SDDMM_TILES
    bc, stage = tile
    assert 2 * fwd.data_cols > bc or bc == 16
    assert fwd.data_cols == {(1408, 2048): 512, (2048, 1408): 352}[mk]


@pytest.mark.parametrize("mk", EXPERTS)
def test_stacked_sddmm_plan_at_a_training_step(all_dims, mk):
    """60 experts of 171 rows: tens of thousands of blocks, one slice, no
    f32 workspace; every expert's tokens covered in whole stages."""
    fwd, _ = all_dims[mk]
    plan = stacked_sddmm_mma_plan(fwd, 60, 171, H100_SMS)
    bc, stage = stacked_sddmm_tile(fwd, 171)
    assert (plan.block_cols, plan.stage_tokens) == (bc, stage)
    assert plan.n_slices == 1 and plan.workspace_shape(fwd, 60) is None
    assert plan.slice_len >= 171 and plan.slice_len % stage == 0
    assert plan.blocks == 60 * (fwd.m // 16) * -(-fwd.data_cols // bc)
    assert plan.blocks >= 20000


@pytest.mark.parametrize("e,n", [(1, 4096), (2, 1037), (4, 300)])
def test_stacked_sddmm_plan_slices_few_experts(all_dims, e, n):
    """Few experts of many rows: the grid is cut into token slices as the
    unstacked plan's, and the workspace holds each expert's slices."""
    fwd, _ = all_dims[(2048, 1408)]
    plan = stacked_sddmm_mma_plan(fwd, e, n, H100_SMS)
    assert plan.slice_len % plan.stage_tokens == 0
    assert (plan.n_slices - 1) * plan.slice_len < n
    assert plan.n_slices * plan.slice_len >= n
    shape = plan.workspace_shape(fwd, e)
    assert shape == (None if plan.n_slices == 1
                     else (e * plan.n_slices, fwd.m, fwd.data_cols))


def test_unstacked_sddmm_plan_keeps_one_slot_a_block(all_dims):
    """The unstacked dW's default plan: the widest block of columns that
    divides C (one slot a block), 128-token stages; given a tile, the
    same plan as the stacked entry point's for one expert."""
    for mk in TINYLLAMA + EXPERTS:
        fwd, tr = all_dims[mk]
        for d in (fwd, tr):
            if sddmm_path(d, 4096, torch.bfloat16) != "mma":
                continue
            plan = sddmm_mma_plan(d, 4096, H100_SMS)
            assert d.chunk_cols % plan.block_cols == 0
            assert plan.stage_tokens == 128
    fwd, _ = all_dims[(2048, 1408)]
    tile = stacked_sddmm_tile(fwd, 171)
    assert sddmm_mma_plan(fwd, 171, H100_SMS, 1, tile) == \
        stacked_sddmm_mma_plan(fwd, 1, 171, H100_SMS)


@pytest.fixture(scope="module")
def chain_tabs():
    return {key: chain_tables(lay, "cpu")
            for key, lay in chip_smoke.chain_layouts().items()}


@pytest.fixture(scope="module")
def chain_tabs_t():
    return {key: chain_transpose_tables(lay, "cpu").tables
            for key, lay in chip_smoke.chain_layouts().items()}


@pytest.mark.parametrize("key", list(chip_smoke.FULL_WIDTH)
                         + list(chip_smoke.SMALL_CHAINS))
@pytest.mark.parametrize("n", [8, 16, 4096])
def test_chain_rhs_paths(chain_tabs, chain_tabs_t, key, n):
    """bf16 forward (and its recompute) and dX of tinyllama's four chain
    layouts take the tensor-core body from 16 tokens on, on the forward
    and the transposed tables alike; decode's 8 rows, float32 and the
    small test chains (G = C = 1, a 2 x 2 leaf) keep the FMA body."""
    full = key in chip_smoke.FULL_WIDTH
    want = "mma" if full and n >= MMA_MIN_TOKENS else "fma"
    for t in (chain_tabs[key], chain_tabs_t[key]):
        assert chain_rhs_path(t, n, torch.bfloat16) == want
        assert chain_rhs_path(t, n, torch.float32) == "fma"


def test_chain_rhs_tile_rows(chain_tabs, chain_tabs_t):
    """32 class rows a block where the largest class has 32 (wk/wv's
    forward table), 64 elsewhere (classes of 64, 256 and 704 rows)."""
    got = {(key, side): chain_rhs_tile_rows(t[key])
           for side, t in (("fwd", chain_tabs), ("tr", chain_tabs_t))
           for key in chip_smoke.FULL_WIDTH}
    assert got == {(key, side): 32 if (key, side) == ("wk/wv", "fwd")
                   else 64 for key, side in got}
    for key in chip_smoke.FULL_WIDTH:
        for t in (chain_tabs[key], chain_tabs_t[key]):
            rows = t.classes.max_groups * t.group_rows
            assert rows % chain_rhs_tile_rows(t) == 0


def test_chain_rhs_path_refuses_shapes_it_cannot_take(chain_tabs):
    import dataclasses

    t = chain_tabs["wq/wo"]
    for bad in (dict(group_rows=4), dict(chunk_cols=12), dict(k=2044)):
        assert chain_rhs_path(dataclasses.replace(t, **bad), 4096,
                              torch.bfloat16) == "fma", bad
    assert chain_rhs_path(t, MMA_MIN_TOKENS - 1, torch.bfloat16) == "fma"
    assert chain_rhs_path(t, MMA_MIN_TOKENS, torch.bfloat16) == "mma"


@pytest.mark.parametrize("key", list(chip_smoke.FULL_WIDTH)
                         + list(chip_smoke.SMALL_CHAINS))
@pytest.mark.parametrize("n", [8, 16, 4096])
def test_chain_sddmm_paths(chain_tabs, key, n):
    """bf16 dW of tinyllama's four chain layouts (leaves 8 x 8, 16 x 32,
    32 x 16) takes the tensor-core body from 16 tokens on; the small test
    chains (G = C = 1, a 2 x 2 leaf) keep the FMA body at every N, and
    float32 keeps it everywhere."""
    t = chain_tabs[key]
    full = key in chip_smoke.FULL_WIDTH
    want = "mma" if full and n >= MMA_MIN_TOKENS else "fma"
    assert chain_sddmm_path(t, n, torch.bfloat16) == want
    assert chain_sddmm_path(t, n, torch.float32) == "fma"


@pytest.mark.parametrize("key", list(chip_smoke.FULL_WIDTH))
@pytest.mark.parametrize("n", [16, 77, 1037, 4096])
def test_chain_sddmm_plan_covers_the_tokens_and_fills_the_card(chain_tabs,
                                                               key, n):
    t = chain_tabs[key]
    cl = t.classes
    plan = chain_sddmm_mma_plan(t, n, H100_SMS)
    assert plan.block_cols == CHAIN_SDDMM_MMA_TILE
    assert plan.slice_len % 32 == 0
    assert (plan.n_slices - 1) * plan.slice_len < n
    assert plan.n_slices * plan.slice_len >= n
    tiles = (cl.n_classes * -(-cl.max_groups * t.group_rows // 64)
             * -(-t.data_cols // 64))
    assert plan.blocks == tiles * plan.n_slices
    if n == 4096:
        assert plan.blocks >= 2 * H100_SMS
    shape = plan.workspace_shape(t)
    assert shape == (None if plan.n_slices == 1
                     else (plan.n_slices, t.m, t.data_cols))


def test_chain_sddmm_plan_at_a_training_step(chain_tabs):
    """4096 tokens: wq/wo's 32 classes of 64 x 256 give 128 tiles, cut
    into 3 slices; wk/wv's 8 classes of 32 x 256 give 32, cut into 9;
    gate/up (8 of 704 x 256) and down (8 of 256 x 704) run 352 uncut."""
    got = {key: chain_sddmm_mma_plan(chain_tabs[key], 4096, H100_SMS)
           for key in chip_smoke.FULL_WIDTH}
    assert {k: (p.n_slices, p.slice_len, p.blocks)
            for k, p in got.items()} == {
        "wq/wo": (3, 1376, 384), "wk/wv": (9, 480, 288),
        "gate/up": (1, 4096, 352), "down": (1, 4096, 352)}


def test_the_mma_bodies_refuse_shapes_they_cannot_take():
    fwd, _ = dims_of(2048, 2048)
    n = 4096
    import dataclasses

    for bad in (dict(group_rows=8), dict(group_rows=48),
                dict(chunk_cols=12), dict(k=2044)):
        d = dataclasses.replace(fwd, **bad)
        assert rhs_path(d, n, torch.bfloat16) == "fma", bad
    for bad in (dict(group_rows=8), dict(chunk_cols=8), dict(k=2044)):
        d = dataclasses.replace(fwd, **bad)
        assert sddmm_path(d, n, torch.bfloat16) == "fma", bad
    # G = 48 is no template of the forward, but a multiple of 16 for dW
    d = dataclasses.replace(fwd, group_rows=48, m=48 * 16)
    assert sddmm_path(d, n, torch.bfloat16) == "mma"
    assert rhs_path(fwd, MMA_MIN_TOKENS - 1, torch.bfloat16) == "fma"
    assert rhs_path(fwd, MMA_MIN_TOKENS, torch.bfloat16) == "mma"


@pytest.mark.parametrize("mk", TINYLLAMA)
@pytest.mark.parametrize("n", [64, 77, 1037, 4096])
def test_sddmm_plan_covers_the_tokens_and_fills_the_card(all_dims, mk, n):
    d = all_dims[mk][0]
    plan = sddmm_mma_plan(d, n, H100_SMS)
    assert plan.n_slices >= 1
    assert d.chunk_cols % plan.block_cols == 0
    assert plan.block_cols in (16, 32, 64, 128)
    # whole stages, every token in exactly one slice, the last ragged
    assert plan.slice_len % 128 == 0
    assert (plan.n_slices - 1) * plan.slice_len < n
    assert plan.n_slices * plan.slice_len >= n
    base = (d.m // 16) * d.d_o * d.d_i * (d.chunk_cols // plan.block_cols)
    assert plan.blocks == base * plan.n_slices
    if n == 4096:
        # a training step's dW fills two waves of an H100 SXM's 132 SMs
        assert plan.blocks >= 2 * H100_SMS
    shape = plan.workspace_shape(d)
    if plan.n_slices == 1:
        assert shape is None
    else:
        assert shape == (plan.n_slices, d.m, d.data_cols)


def test_sddmm_plan_at_a_training_step():
    """tinyllama at 4096 tokens: only wk/wv (64 (row group, slot) pairs)
    is cut, into 5 slices of 896 tokens and a 2.5 MiB workspace; the
    other layouts already have 512 to 2816 blocks."""
    wq, _ = dims_of(2048, 2048)
    wk, _ = dims_of(256, 2048)
    p = sddmm_mma_plan(wk, 4096, H100_SMS)
    assert (p.block_cols, p.n_slices, p.slice_len, p.blocks) == (
        128, 5, 896, 320)
    assert p.workspace_shape(wk) == (5, 256, 512)
    p = sddmm_mma_plan(wq, 4096, H100_SMS)
    assert (p.n_slices, p.slice_len, p.blocks) == (1, 4096, 512)
    # fewer SMs, fewer slices; few tokens, no cut below 256 a slice
    assert sddmm_mma_plan(wk, 4096, 16).n_slices == 1
    assert sddmm_mma_plan(wk, 300, H100_SMS).n_slices == 2


def test_library_path_hashes_the_shared_headers(tmp_path, monkeypatch):
    """An edit to a ``csrc/*.cuh`` header names a new library, so the
    next use builds it anew; so does an edit to the source."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for f in list(build.CSRC.glob("*.cuh")) + [
            build.CSRC / build.SOURCES["rbgp4mm_rhs"]]:
        (csrc / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(build, "CSRC", csrc)
    first = build.library_path("rbgp4mm_rhs")
    assert first == build.library_path("rbgp4mm_rhs")
    header = csrc / "mma_bf16.cuh"
    header.write_bytes(header.read_bytes() + b"\n// edited\n")
    second = build.library_path("rbgp4mm_rhs")
    assert second != first
    src = csrc / build.SOURCES["rbgp4mm_rhs"]
    src.write_bytes(src.read_bytes() + b"\n")
    assert build.library_path("rbgp4mm_rhs") not in (first, second)


# -- the feature-major kernels: rbgp4mm (O, dI) and rbgp4_sddmm (dW) ----------

VGG19_FM = [(64, 576), (128, 576), (128, 1152), (256, 1152), (256, 2304),
            (512, 2304), (512, 4608)]
WRN_FM = (64, 144)
# N of VGG19-CIFAR's layers at batch 256 (res^2 * 256) and the least N
VGG19_N = [16, 1024, 4096, 16384, 65536, 262144]


@pytest.fixture(scope="module")
def fm_tables():
    return {mk: (KernelTables.build(lay, "cpu"),
                 KernelTables.build(lay.transpose_layout(), "cpu"))
            for mk, lay in chip_smoke.fm_layouts().items()}


@pytest.fixture(scope="module")
def fm_dims(fm_tables):
    return {mk: (f.dims, t.dims) for mk, (f, t) in fm_tables.items()}


def test_fm_layouts_are_the_ones_the_bodies_were_built_for(fm_dims):
    """Forward: G = 16, 18 slots of C = 8, 8, 16, 16, 32, 32, 64;
    transposed: C = 16, G = 8, 8, 16, 16, 32, 32, 64 with 1, 2, 2, 4, 4,
    8, 8 slots; WRN-40-4: C = 2 forward, G = 2 transposed."""
    got = [(f.group_rows, f.d_o * f.d_i, f.chunk_cols, t.group_rows,
            t.d_o * t.d_i, t.chunk_cols)
           for f, t in (fm_dims[mk] for mk in VGG19_FM + [WRN_FM])]
    assert got == [(16, 18, c, gt, s, 16) for c, gt, s in (
        (8, 8, 1), (8, 8, 2), (16, 16, 2), (16, 16, 4), (32, 32, 4),
        (32, 32, 8), (64, 64, 8))] + [(16, 18, 2, 2, 1, 16)]


@pytest.mark.parametrize("mk", VGG19_FM + [WRN_FM])
@pytest.mark.parametrize("n", VGG19_N)
def test_fm_paths_of_the_vgg19_layouts(fm_dims, mk, n):
    """bf16 from the least N (16) through every VGG19 layer's N: O on the
    forward tables, dI on the transposed ones (G = 8 included) and dW take
    the tensor-core bodies at VGG19's seven layouts; WRN-40-4's C = 2 and
    transposed G = 2 keep the FMA bodies."""
    fwd, tr = fm_dims[mk]
    want = "fma" if mk == WRN_FM else "mma"
    assert fm_path(fwd, n, torch.bfloat16) == want
    assert fm_path(tr, n, torch.bfloat16) == want
    assert fm_sddmm_path(fwd, n, torch.bfloat16) == want


@pytest.mark.parametrize("mk", VGG19_FM + [WRN_FM])
@pytest.mark.parametrize("n", [1, 8, 1037, 4095, 4097])
def test_fm_float32_few_and_odd_n_keep_the_fma_bodies(fm_dims, mk, n):
    """float32 (no TF32) at every N, and bf16 below 16 columns or at N not
    a multiple of 8 (a row of I would not start 16-byte aligned) take the
    FMA bodies."""
    for d in fm_dims[mk]:
        for dt in (torch.float32, torch.bfloat16):
            assert fm_path(d, n, dt) == "fma"
            assert fm_sddmm_path(d, n, dt) == "fma"
        assert fm_path(d, 4096, torch.float32) == "fma"
        assert fm_sddmm_path(d, 4096, torch.float32) == "fma"


@pytest.mark.parametrize("g_o,g_r,g_i", [((4, 4), (4, 4), (4, 4)),
                                         ((2, 4), (9, 4), (2, 4)),
                                         ((2, 4), (256, 2), (2, 2))])
def test_fm_paths_of_the_cpu_test_layouts(g_o, g_r, g_i):
    """The CUDA tests' small feature-major layouts (G = C = 4, an odd G =
    9 and G = 256 with C = 2; transposed C = 4, 9 and 256) keep the FMA
    bodies in bf16 too."""
    lay = RBGP4Layout(RBGP4Spec(g_o=g_o, g_r=g_r, g_i=g_i, g_b=(1, 1),
                                sp_o=0.5, sp_i=0.5, seed=7))
    for d in (KernelDims.from_layout(lay),
              KernelDims.from_layout(lay.transpose_layout())):
        assert fm_path(d, 4096, torch.bfloat16) == "fma"
        assert fm_sddmm_path(d, 4096, torch.bfloat16) == "fma"


def test_fm_paths_refuse_shapes_they_cannot_take(fm_dims):
    import dataclasses

    fwd, tr = fm_dims[(512, 4608)]
    for bad in (dict(group_rows=48, m=48 * 32), dict(group_rows=128),
                dict(group_rows=4), dict(chunk_cols=12)):
        assert fm_path(dataclasses.replace(fwd, **bad), 4096,
                       torch.bfloat16) == "fma", bad
    for bad in (dict(group_rows=8), dict(group_rows=24),
                dict(chunk_cols=4)):
        assert fm_sddmm_path(dataclasses.replace(fwd, **bad), 4096,
                             torch.bfloat16) == "fma", bad
    # G = 48 is no template of the forward, but a multiple of 16 for dW
    d48 = dataclasses.replace(fwd, group_rows=48, m=48 * 32)
    assert fm_sddmm_path(d48, 4096, torch.bfloat16) == "mma"
    assert fm_path(tr, MMA_MIN_TOKENS - 8, torch.bfloat16) == "fma"
    assert fm_path(tr, MMA_MIN_TOKENS, torch.bfloat16) == "mma"


@pytest.mark.parametrize("mk", VGG19_FM)
@pytest.mark.parametrize("n", VGG19_N)
def test_fm_tiles_are_built_tiles(fm_tables, mk, n):
    fwd, tr = fm_tables[mk]
    assert fm_mma_tile(fwd, n) in FM_MMA_TILES
    assert fm_mma_tile(tr, n) in FM_MMA_TILES
    assert fm_sddmm_tile(fwd.dims, n) in FM_SDDMM_TILES


# the sparsities of the paper's Table 1 (benchmarks/table1_models.py)
TABLE1_SPARSITIES = (0.5, 0.75, 0.875, 0.9375)


@pytest.mark.parametrize("sp", TABLE1_SPARSITIES)
@pytest.mark.parametrize("mk", VGG19_FM + [WRN_FM])
def test_fm_tiles_are_built_tiles_at_table1_sparsities(sp, mk):
    """At every sparsity of Table 1, on VGG19-CIFAR's seven layouts and
    WRN-40-4's 64 x 144 (its other layouts are VGG19's), forward and
    transposed: wherever ``fm_path`` takes the tensor-core body,
    ``fm_mma_tile`` names a tile that is built (at 0.5, 512 x 2304's
    transposed tables have G = 64, classes of 9 and 256 compact
    columns a row)."""
    lay = RBGP4Layout(design_rbgp4(*mk, sp))
    for side in (lay, lay.transpose_layout()):
        t = KernelTables.build(side, "cpu")
        for n in VGG19_N + [1000, 4104]:
            if fm_path(t.dims, n, torch.bfloat16) == "mma":
                assert fm_mma_tile(t, n) in FM_MMA_TILES, (t.dims, n)
                assert fm_sddmm_tile(t.dims, n) in FM_SDDMM_TILES


def test_fm_tile_rule_names_exactly_the_built_tiles():
    """Over class sizes, G, row lengths and N, ``fm_mma_tile`` names every
    tile of ``FM_MMA_TILES`` and no other: none it names lacks a
    template, and none is built that it never names."""
    from types import SimpleNamespace

    named = set()
    for sizes in ((1,) * 4, (1,) * 64, (2,) * 16, (9,) * 8, (18,) * 4):
        for g in (8, 16, 32, 64):
            for cols in (16, 128, 144, 256, 1152):
                for n in (16, 1024, 262144):
                    t = SimpleNamespace(
                        dims=SimpleNamespace(group_rows=g, data_cols=cols),
                        classes=SimpleNamespace(sizes=sizes,
                                                max_groups=max(sizes)))
                    named.add(fm_mma_tile(t, n))
    assert named == set(FM_MMA_TILES)


@pytest.mark.parametrize("mk", VGG19_FM + [WRN_FM])
@pytest.mark.parametrize("side", [0, 1])
def test_fm_classes_partition_the_row_groups_by_col0_row(fm_tables, mk,
                                                        side):
    """``rbgp4mm``'s tensor-core body walks ``KernelTables.classes``: every
    row group in exactly one class, increasing within it, each member's
    ``col0`` row the class's, no two classes alike.  The transposed tables
    have classes of 9 row groups (18 at C = 8 forward: 64 x 576 and WRN's
    64 x 144), one a tile-row of the complete outer graph; the forward
    tables classes of 1 to 5."""
    t = fm_tables[mk][side]
    cl = t.classes
    col0 = t.col0.numpy()
    groups, start = cl.groups.numpy(), cl.start.numpy()
    n_groups = t.dims.m // t.dims.group_rows
    assert start[0] == 0 and start[-1] == n_groups
    assert np.array_equal(np.sort(groups), np.arange(n_groups))
    sizes = np.diff(start)
    assert sizes.min() >= 1 and cl.max_groups == sizes.max()
    for c in range(cl.n_classes):
        members = groups[start[c]:start[c + 1]]
        assert np.all(np.diff(members) > 0)
        assert (col0[members] == cl.col0.numpy()[c]).all()
    assert len(np.unique(cl.col0.numpy(), axis=0)) == cl.n_classes
    if side == 1:
        assert set(sizes) == ({18} if mk in ((64, 576), WRN_FM) else {9})
    else:
        assert cl.max_groups <= 5


@pytest.mark.parametrize("mk", VGG19_FM + [WRN_FM])
@pytest.mark.parametrize("side", [0, 1])
@pytest.mark.parametrize("wk", sorted({t[2] for t in FM_MMA_TILES}))
def test_fm_k_steps_cover_every_slot_once(fm_dims, mk, side, wk):
    """The contraction warps of ``rbgp4mm``'s tensor-core body walk every
    k16 step of the row once, each its steps in increasing order, so
    every compact column, and so every slot's C columns, is contracted
    exactly once (C = 8: one step holds two slots)."""
    d = fm_dims[mk][side]
    steps = _fm_k_steps(d, wk)
    assert len(steps) == wk
    for own in steps:
        assert own == sorted(own)
    flat = sorted(s_ for own in steps for s_ in own)
    assert flat == list(range(-(-d.data_cols // 16)))
    seen = np.zeros(d.data_cols, np.int64)
    for own in steps:
        for s_ in own:
            seen[16 * s_:16 * s_ + 16] += 1
    assert (seen == 1).all()
    per_slot = seen.reshape(d.d_o * d.d_i, d.chunk_cols).sum(1)
    assert (per_slot == d.chunk_cols).all()


@pytest.mark.parametrize("mk", VGG19_FM)
@pytest.mark.parametrize("n", VGG19_N[1:] + [1000, 4104])
@pytest.mark.parametrize("bc", FM_SDDMM_TILES)
def test_fm_sddmm_plan_covers_the_tokens_and_fills_the_card(fm_dims, mk, n,
                                                            bc):
    """The dW body's slices cover N in whole 64-token stages, none empty,
    and bring the grid to about two waves of an H100 SXM's 132 SMs (fewer
    only where the slices already have the least 256 tokens each)."""
    d = fm_dims[mk][0]
    plan = fm_sddmm_plan(d, n, H100_SMS, bc)
    assert plan.block_cols == bc and plan.stage_tokens == 64
    assert plan.slice_len % 64 == 0
    assert (plan.n_slices - 1) * plan.slice_len < n
    assert plan.n_slices * plan.slice_len >= n
    base = (d.m // 16) * -(-d.data_cols // bc)
    assert plan.blocks == base * plan.n_slices
    # whole stages may cost a slice of the two waves' worth
    assert plan.blocks >= 0.9 * 2 * H100_SMS or plan.n_slices * 256 >= n
    assert plan.blocks < 2 * H100_SMS + base
    shape = plan.workspace_shape(d)
    assert shape == (None if plan.n_slices == 1
                     else (plan.n_slices, d.m, d.data_cols))
    assert fm_sddmm_plan(d, n, H100_SMS) == fm_sddmm_plan(
        d, n, H100_SMS, fm_sddmm_tile(d, n))

