"""The port's ``rbgp4mm_rhs`` against the reference's.

On the CPU the wrapper runs its plain version; it is held against the JAX
package's Pallas ``rbgp4mm_rhs`` (interpret mode) on the
``tests/test_kernels.py`` sweep layouts, and against the reference's
``compact_gather_mm_rhs`` at full width.  The CUDA kernel's ``col0``
addressing is emulated in numpy here; the kernel itself runs only on the
card (``tests/test_torch_cuda.py``).

Tolerances scale with max|ref|: 1e-5 in float32 (reduction order only),
2e-2 in bfloat16 (one output rounding).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import RBGP4Layout as JLayout
from repro.core import RBGP4Spec as JSpec
from repro.core import design_rbgp4 as j_design
from repro.kernels import KernelDims as JDims
from repro.kernels import rbgp4mm_rhs as j_rbgp4mm_rhs
from repro.kernels import ref as jref
from repro_torch.core import RBGP4Layout, RBGP4Spec, design_rbgp4
from repro_torch.kernels import (KernelTables, rbgp4mm_rhs,
                                 rbgp4mm_rhs_reference)
from repro_torch.kernels import ref as tref

torch.set_num_threads(1)

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JAX_DT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
ACTS = [None, "relu", "gelu", "silu"]

# tests/test_kernels.py sweep: m, k, n, sp_o, sp_i, G, C, ui, vi
SWEEP = [
    (64, 64, 16, 0.5, 0.5, 4, 4, 4, 4),
    (128, 64, 32, 0.75, 0.0, 4, 8, 4, 2),
    (64, 128, 8, 0.0, 0.5, 8, 8, 2, 4),
    (256, 128, 64, 0.5, 0.75, 8, 8, 4, 4),
    (128, 128, 24, 0.875, 0.0, 4, 8, 4, 2),
    (64, 64, 16, 0.9375, 0.0, 2, 2, 2, 2),
    (32, 32, 128, 0.5, 0.5, 2, 2, 4, 4),
]
FULL_WIDTH = [(2048, 2048), (256, 2048), (5632, 2048), (2048, 5632)]


def layouts(m, k, sp_o, sp_i, G, C, ui, vi, seed=7):
    kw = dict(g_o=(m // (ui * G), k // (vi * C)), g_r=(G, C), g_i=(ui, vi),
              g_b=(1, 1), sp_o=sp_o, sp_i=sp_i, seed=seed)
    return JLayout(JSpec(**kw)), RBGP4Layout(RBGP4Spec(**kw))


def inputs(rng, n, k, m, nnz_row, bias, residual):
    x = rng.standard_normal((n, k)).astype(np.float32)
    w = rng.standard_normal((m, nnz_row)).astype(np.float32)
    b = rng.standard_normal(m).astype(np.float32) if bias else None
    r = rng.standard_normal((n, m)).astype(np.float32) if residual else None
    return x, w, b, r


def run_both(shape, dtype, act, bias, residual, seed=0):
    m, k, n, sp_o, sp_i, G, C, ui, vi = shape
    jl, tl = layouts(m, k, sp_o, sp_i, G, C, ui, vi)
    x, w, b, r = inputs(np.random.default_rng(seed), n, k, m,
                        tl.data_shape[1], bias, residual)
    jd, td = JAX_DT[dtype], TORCH_DT[dtype]
    opt = lambda a, f: None if a is None else f(a)
    want = j_rbgp4mm_rhs(
        JDims.from_layout(jl), jnp.asarray(jl.adj_o), jnp.asarray(x, jd),
        jnp.asarray(w, jd), interpret=True, block_n=16,
        bias=opt(b, lambda a: jnp.asarray(a, jd)), act=act,
        residual=opt(r, lambda a: jnp.asarray(a, jd)))
    got = rbgp4mm_rhs(
        KernelTables.build(tl, "cpu"), torch.tensor(x).to(td),
        torch.tensor(w).to(td), bias=opt(b, lambda a: torch.tensor(a).to(td)),
        act=act, residual=opt(r, lambda a: torch.tensor(a).to(td)))
    assert got.dtype == td and tuple(got.shape) == (n, m)
    return np.asarray(want, np.float32), got.float().numpy()


def assert_close(got, want, dtype):
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= TOL[dtype] * scale, (err, scale)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("i", range(len(SWEEP)))
def test_rhs_matches_reference_kernel_on_sweep(i, dtype):
    """Every sweep layout in both dtypes; the epilogue rotates through the
    activations and bias/residual on/off so each combination appears."""
    j = i + (dtype == "bfloat16")
    act = ACTS[j % len(ACTS)]
    bias, residual = bool(j % 2), bool((j // 2) % 2)
    want, got = run_both(SWEEP[i], dtype, act, bias, residual, seed=i)
    assert_close(got, want, dtype)


@pytest.mark.parametrize("bias,residual", [(False, False), (True, True),
                                           (True, False), (False, True)])
@pytest.mark.parametrize("act", ACTS)
def test_rhs_epilogue_matches_reference_kernel(act, bias, residual):
    want, got = run_both(SWEEP[3], "float32", act, bias, residual, seed=5)
    assert_close(got, want, "float32")


@pytest.mark.parametrize("m,k", FULL_WIDTH)
def test_plain_version_matches_reference_at_full_width(m, k):
    jl = JLayout(j_design(m, k, 0.75, seed=0))
    tl = RBGP4Layout(design_rbgp4(m, k, 0.75, seed=0))
    rng = np.random.default_rng(m + k)
    x = rng.standard_normal((4, k)).astype(np.float32)
    w = rng.standard_normal(tl.data_shape).astype(np.float32)
    want = np.asarray(jref.compact_gather_mm_rhs(jl, jnp.asarray(w),
                                                 jnp.asarray(x)))
    got = tref.compact_gather_mm_rhs(tl, torch.tensor(w), torch.tensor(x))
    assert_close(got.numpy(), want, "float32")
    via_wrapper = rbgp4mm_rhs(KernelTables.build(tl, "cpu"), torch.tensor(x),
                              torch.tensor(w))
    assert_close(via_wrapper.numpy(), want, "float32")


def kernel_addressing(tables, x, w):
    """The CUDA kernel's arithmetic, vectorized: output row rg*G + g sums
    w[row, s*C + c] * x[:, col0[rg, s] + c] over slots s and columns c."""
    col0 = tables.col0.numpy()                               # (RG, S)
    G, C = tables.dims.group_rows, tables.dims.chunk_cols
    rg, s = col0.shape
    xg = x[:, col0[:, :, None] + np.arange(C)]               # (N, RG, S, C)
    wr = w.reshape(rg, G, s, C)
    return np.einsum("nrsc,rgsc->nrg", xg, wr).reshape(x.shape[0], -1)


@pytest.mark.parametrize("m,k", FULL_WIDTH + [(64, 64), (128, 64)])
def test_col0_table_addresses_the_compact_layout(m, k):
    lay = RBGP4Layout(design_rbgp4(m, k, 0.75, seed=0))
    tables = KernelTables.build(lay, "cpu")
    assert tables.col0.dtype == torch.int32 and tables.col0.is_contiguous()
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, k))
    w = rng.standard_normal(lay.data_shape)
    # exact equality of the index sets, then the product
    col = tables.col0.numpy()
    C = tables.dims.chunk_cols
    full = (col[:, :, None] + np.arange(C)).reshape(col.shape[0], -1)
    np.testing.assert_array_equal(
        np.repeat(full, tables.dims.group_rows, axis=0), lay._col_index())
    want = x @ lay.unpack(w).T
    assert_close(kernel_addressing(tables, x, w), want, "float32")


@pytest.mark.parametrize("shape", [SWEEP[0], SWEEP[4]])
def test_pack_unpack_match_reference_exactly(shape):
    m, k, _, sp_o, sp_i, G, C, ui, vi = shape
    jl, tl = layouts(m, k, sp_o, sp_i, G, C, ui, vi)
    w = np.random.default_rng(3).standard_normal(tl.data_shape).astype(
        np.float32)
    want = np.asarray(jref.unpack_dense(jl, jnp.asarray(w)))
    dense = tref.unpack_dense(tl, torch.tensor(w))
    np.testing.assert_array_equal(dense.numpy(), want)
    np.testing.assert_array_equal(tref.pack_compact(tl, dense).numpy(), w)


@pytest.mark.parametrize("compact", [True, False])
def test_sparse_linear_epilogue_matches_reference(compact):
    """SparseLinear with bias, fused gelu and residual, in compact storage
    (the kernel's epilogue) and in dense storage (plain ops)."""
    from repro.sparsity import CompactWeight as JCompact
    from repro.sparsity import DenseWeight as JDense
    from repro.sparsity import SparseLinear as JSparseLinear
    from repro.sparsity import SparsityConfig as JSparsityConfig
    from repro_torch.sparsity import SparseLinear, SparsityConfig

    kw = dict(pattern="rbgp4", sparsity=0.75, min_dim=64 if compact else 512)
    jmod = JSparseLinear(64, 128, JSparsityConfig(backend="auto", **kw),
                         use_bias=True)
    tmod = SparseLinear(64, 128, SparsityConfig(**kw), use_bias=True,
                        device="cpu")
    assert tmod.mode == ("compact" if compact else "dense")
    rng = np.random.default_rng(4)
    values = tmod.w_data if compact else tmod.w
    w = rng.standard_normal(tuple(values.shape)).astype(np.float32)
    b = rng.standard_normal(128).astype(np.float32)
    x = rng.standard_normal((3, 5, 64)).astype(np.float32)
    r = rng.standard_normal((3, 5, 128)).astype(np.float32)
    jw = (JCompact(w_data=jnp.asarray(w), b=jnp.asarray(b),
                   layout=jmod.layout) if compact
          else JDense(w=jnp.asarray(w), b=jnp.asarray(b)))
    want = jmod.apply(jw, jnp.asarray(x), fuse="gelu",
                      residual=jnp.asarray(r))
    with torch.no_grad():
        values.copy_(torch.tensor(w))
        tmod.b.copy_(torch.tensor(b))
    got = tmod(torch.tensor(x), fuse="gelu", residual=torch.tensor(r))
    assert tuple(got.shape) == (3, 5, 128)
    assert_close(got.numpy(), np.asarray(want), "float32")


def test_plain_version_is_what_cpu_tensors_run():
    _, tl = layouts(*SWEEP[0][:2], *SWEEP[0][3:])
    x = torch.randn(5, tl.k, generator=torch.Generator().manual_seed(0))
    w = torch.randn(tl.data_shape, generator=torch.Generator().manual_seed(1))
    before = rbgp4mm_rhs.launches
    tables = KernelTables.build(tl, "cpu")
    a = rbgp4mm_rhs(tables, x, w, act="silu")
    b = rbgp4mm_rhs_reference(tables, x, w, act="silu")
    assert torch.equal(a, b)
    assert rbgp4mm_rhs.launches == before
