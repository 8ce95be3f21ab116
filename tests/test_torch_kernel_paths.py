"""Which device body a launch of ``rbgp4mm_rhs`` and ``rbgp4_sddmm_rhs``
takes, the dW tensor-core body's token-slice plan, and the build's
rebuild on a header edit: pure functions of dtype and shape, checked on
the CPU (the kernels themselves run in ``tests/test_torch_cuda.py``).

The layouts are tinyllama-1.1b's four and qwen2-moe-a2.7b's (attention
and the shared expert share tinyllama's widths; the routed experts are
1408 x 2048 and 2048 x 1408), each forward and transposed, from
``design_rbgp4(m, k, 0.75, seed=0)`` as the models build them.
"""
import pytest
import torch

from repro_torch.core import RBGP4Layout, design_rbgp4
from repro_torch.kernels import (MMA_MIN_TOKENS, KernelDims, build,
                                 rhs_path, sddmm_mma_plan, sddmm_path)

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


@pytest.mark.parametrize("mk", TINYLLAMA + EXPERTS)
@pytest.mark.parametrize("n", [8, 512, 4096])
def test_float32_keeps_the_fma_bodies(all_dims, mk, n):
    """No TF32: float32 takes the FMA bodies at every layout and N.  (The
    stacked and int8 entry points have no other body; the CUDA tests
    check that their launches leave the tensor-core counters alone.)"""
    for d in all_dims[mk]:
        assert rhs_path(d, n, torch.float32) == "fma"
        assert sddmm_path(d, n, torch.float32) == "fma"


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
