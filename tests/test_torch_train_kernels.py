"""The training kernels of the port against the reference's, on the CPU.

``rbgp4_sddmm_rhs``, ``rbgp4mm_rhs(save_preact=True)`` and the
differentiable ``RBGP4Linear`` run their plain versions here; they are
held against the JAX package's Pallas kernels and ``RBGP4Op.linear``'s
custom VJP (interpret mode, ``block_n=8``) on the ``tests/test_fused_
kernels.py`` sweep layouts (G, C <= 8; one ragged N), and ``dW``/``dX``
also against dense autograd through ``unpack_dense``, since a wrong
``col0`` or transpose permutation still gives plausible numbers.  The
CUDA kernels' addressing is emulated in numpy at the full-width layouts;
the kernels themselves run only on the card (``tests/test_torch_cuda.py``).

Tolerance: max|diff| <= 1e-5 * max|ref| in float32 (reduction order only).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import RBGP4Layout as JLayout
from repro.core import RBGP4Spec as JSpec
from repro.kernels import KernelDims as JDims
from repro.kernels import RBGP4Op
from repro.kernels import rbgp4_sddmm_rhs as j_sddmm_rhs
from repro.kernels import rbgp4mm_rhs as j_rbgp4mm_rhs
from repro_torch.core import RBGP4Layout, RBGP4Spec, design_rbgp4
from repro_torch.kernels import (KernelTables, RBGP4Linear, TransposeTables,
                                 rbgp4_sddmm_rhs, rbgp4_sddmm_rhs_reference,
                                 rbgp4mm_rhs)
from repro_torch.kernels.ref import pack_compact, unpack_dense
from repro_torch.sparsity import SparseLinear, SparsityConfig

torch.set_num_threads(1)
RTOL = 1e-5

# tests/test_fused_kernels.py sweep: m, k, n, sp_o, sp_i, G, C, ui, vi
SWEEP = [
    (64, 64, 16, 0.5, 0.5, 4, 4, 4, 4),
    (128, 64, 32, 0.75, 0.0, 4, 8, 4, 2),
    (64, 128, 24, 0.0, 0.5, 8, 8, 2, 4),
    (128, 128, 40, 0.875, 0.0, 4, 8, 4, 2),  # n not a block multiple
]
FULL_WIDTH = [(2048, 2048), (256, 2048), (5632, 2048), (2048, 5632)]
EPILOGUES = [(None, False, False), ("silu", False, False),
             ("gelu", True, True)]


def layouts(m, k, sp_o, sp_i, G, C, ui, vi, seed=31):
    kw = dict(g_o=(m // (ui * G), k // (vi * C)), g_r=(G, C), g_i=(ui, vi),
              g_b=(1, 1), sp_o=sp_o, sp_i=sp_i, seed=seed)
    return JLayout(JSpec(**kw)), RBGP4Layout(RBGP4Spec(**kw))


def assert_close(got, want, rtol=RTOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = float(np.abs(got - want).max())
    scale = float(np.abs(want).max())
    assert err <= rtol * scale, (err, scale)


def randn(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("shape", SWEEP)
def test_plain_sddmm_matches_reference_kernel(shape):
    m, k, n, sp_o, sp_i, G, C, ui, vi = shape
    jl, tl = layouts(m, k, sp_o, sp_i, G, C, ui, vi)
    rng = np.random.default_rng(m + k + n)
    g, x = randn(rng, n, m), randn(rng, n, k)
    want = j_sddmm_rhs(JDims.from_layout(jl), jnp.asarray(jl.adj_o),
                       jnp.asarray(g), jnp.asarray(x), interpret=True,
                       block_n=8)
    got = rbgp4_sddmm_rhs(KernelTables.build(tl, "cpu"), torch.tensor(g),
                          torch.tensor(x))
    assert got.dtype == torch.float32 and tuple(got.shape) == tl.data_shape
    assert_close(got.numpy(), want)
    # and against the dense product, packed
    dense = torch.tensor(g).T @ torch.tensor(x)
    assert_close(got.numpy(), pack_compact(tl, dense).numpy())


@pytest.mark.parametrize("act,bias", [("silu", False), ("gelu", True),
                                      ("relu", True)])
@pytest.mark.parametrize("shape", SWEEP[2:])
def test_save_preact_matches_reference_kernel(shape, act, bias):
    m, k, n, sp_o, sp_i, G, C, ui, vi = shape
    jl, tl = layouts(m, k, sp_o, sp_i, G, C, ui, vi)
    rng = np.random.default_rng(n)
    x, w = randn(rng, n, k), randn(rng, *tl.data_shape)
    b = randn(rng, m) if bias else None
    jy, jz = j_rbgp4mm_rhs(
        JDims.from_layout(jl), jnp.asarray(jl.adj_o), jnp.asarray(x),
        jnp.asarray(w), interpret=True, block_n=8, act=act,
        bias=None if b is None else jnp.asarray(b), save_preact=True)
    y, z = rbgp4mm_rhs(KernelTables.build(tl, "cpu"), torch.tensor(x),
                       torch.tensor(w), act=act, save_preact=True,
                       bias=None if b is None else torch.tensor(b))
    assert_close(y.numpy(), jy)
    assert_close(z.numpy(), jz)


def linear_both(shape, fuse, bias, residual, seed=0):
    """(port forward + grads, reference forward + grads) of one layer."""
    m, k, n, sp_o, sp_i, G, C, ui, vi = shape
    jl, tl = layouts(m, k, sp_o, sp_i, G, C, ui, vi)
    rng = np.random.default_rng(seed)
    x, w, gy = randn(rng, n, k), randn(rng, *tl.data_shape), randn(rng, n, m)
    b = randn(rng, m) if bias else None
    r = randn(rng, n, m) if residual else None

    op = RBGP4Op(jl, interpret=True, block_n=8)

    def f(x, w, b, r):
        return op.linear(x, w, bias=b, fuse=fuse, residual=r)

    opt = lambda a: None if a is None else jnp.asarray(a)
    jy, pull = jax.vjp(f, jnp.asarray(x), jnp.asarray(w), opt(b), opt(r))
    want = [np.asarray(jy)] + [None if v is None else np.asarray(v)
                               for v in pull(jnp.asarray(gy))]

    leaf = lambda a: (None if a is None
                      else torch.tensor(a).requires_grad_())
    tx, tw, tb, tr = leaf(x), leaf(w), leaf(b), leaf(r)
    ty = RBGP4Linear.apply(tx, tw, tb, tr, KernelTables.build(tl, "cpu"),
                           TransposeTables.build(tl, "cpu"), fuse)
    ty.backward(torch.tensor(gy))
    got = [ty.detach().numpy()] + [None if t is None else t.grad.numpy()
                                   for t in (tx, tw, tb, tr)]
    return tl, (x, w, b, r, gy), got, want


@pytest.mark.parametrize("fuse,bias,residual", EPILOGUES)
@pytest.mark.parametrize("shape", SWEEP)
def test_rbgp4_linear_matches_reference_vjp(shape, fuse, bias, residual):
    """y, dX, dW, db, dresidual against ``jax.vjp`` of the reference's
    ``RBGP4Op.linear`` (its custom VJP on the Pallas kernels)."""
    _, _, got, want = linear_both(shape, fuse, bias, residual)
    for name, a, b in zip(("y", "dx", "dw", "db", "dr"), got, want):
        assert (a is None) == (b is None), name
        if a is not None:
            assert_close(a, b)


@pytest.mark.parametrize("fuse", [None, "silu"])
@pytest.mark.parametrize("shape", [SWEEP[0], SWEEP[3]])
def test_rbgp4_linear_grads_match_dense_autograd(shape, fuse):
    """dW and dX equal autograd through the dense matrix, packed: what a
    wrong ``col0`` or transpose permutation would break."""
    tl, (x, w, b, r, gy), got, _ = linear_both(shape, fuse, False, False,
                                               seed=5)
    tx = torch.tensor(x).requires_grad_()
    wd = unpack_dense(tl, torch.tensor(w)).requires_grad_()
    y = tx @ wd.T
    if fuse is not None:
        y = torch.nn.functional.silu(y)
    y.backward(torch.tensor(gy))
    assert_close(got[1], tx.grad.numpy())
    assert_close(got[2], pack_compact(tl, wd.grad).numpy())


@pytest.mark.parametrize("m,k", FULL_WIDTH)
def test_transposed_values_pack_the_transpose_exactly(m, k):
    """At the four full-width layouts: the permuted values are the dense
    transpose packed in the transposed layout, bit for bit, and the
    permutation built on the device equals the layout's own."""
    lay = RBGP4Layout(design_rbgp4(m, k, 0.75, seed=0))
    tt = TransposeTables.build(lay, "cpu")
    lt = lay.transpose_layout()
    w = torch.tensor(randn(np.random.default_rng(1), *lay.data_shape))
    want = pack_compact(lt, unpack_dense(lay, w).T.contiguous())
    assert torch.equal(tt.values(w), want)
    np.testing.assert_array_equal(tt.perm.numpy(), lay.transpose_perm())
    assert tt.perm.dtype == torch.int32
    assert tuple(tt.tables.col0.shape) == (
        lt.m // lt.spec.group_rows, lt.spec.d_o * lt.spec.d_i)


def rhs_kernel_addressing(tables, x, w):
    """The forward CUDA kernel's arithmetic: row rg*G + g sums
    w[row, s*C + c] * x[:, col0[rg, s] + c] over slots s, columns c."""
    col0 = tables.col0.numpy()
    G, C = tables.dims.group_rows, tables.dims.chunk_cols
    rg, s = col0.shape
    xg = x[:, col0[:, :, None] + np.arange(C)]               # (N, RG, S, C)
    return np.einsum("nrsc,rgsc->nrg", xg,
                     w.reshape(rg, G, s, C)).reshape(x.shape[0], -1)


def sddmm_kernel_addressing(tables, g, x):
    """The sddmm CUDA kernel's arithmetic: block (rg, s) writes
    dW[rg*G + gi, s*C + c] = sum_n g[n, rg*G + gi] x[n, col0[rg, s] + c]."""
    col0 = tables.col0.numpy()
    G, C = tables.dims.group_rows, tables.dims.chunk_cols
    rg, s = col0.shape
    xg = x[:, col0[:, :, None] + np.arange(C)]               # (N, RG, S, C)
    gg = g.reshape(g.shape[0], rg, G)
    return np.einsum("nrg,nrsc->rgsc", gg, xg).reshape(rg * G, s * C)


@pytest.mark.parametrize("m,k", FULL_WIDTH)
def test_kernel_addressing_gives_dw_and_dx_at_full_width(m, k):
    """dW through the sddmm kernel's ``col0`` addressing and dX through the
    forward kernel's addressing on the transposed tables (G = 64 or 128,
    C = 16) equal the dense gradients."""
    lay = RBGP4Layout(design_rbgp4(m, k, 0.75, seed=0))
    tables = KernelTables.build(lay, "cpu")
    tt = TransposeTables.build(lay, "cpu")
    rng = np.random.default_rng(2)
    w = randn(rng, *lay.data_shape)
    g, x = randn(rng, 3, m), randn(rng, 3, k)
    dense = lay.unpack(w)
    assert_close(sddmm_kernel_addressing(tables, g, x),
                 lay.pack(g.T @ x))
    w_t = tt.values(torch.tensor(w)).numpy()
    assert_close(rhs_kernel_addressing(tt.tables, g, w_t), g @ dense)


def test_plain_versions_are_what_cpu_tensors_run():
    _, tl = layouts(*SWEEP[0][:2], *SWEEP[0][3:])
    tables = KernelTables.build(tl, "cpu")
    g = torch.randn(5, tl.m, generator=torch.Generator().manual_seed(0))
    x = torch.randn(5, tl.k, generator=torch.Generator().manual_seed(1))
    counters = lambda: (rbgp4_sddmm_rhs.launches, rbgp4mm_rhs.launches,
                        rbgp4mm_rhs.launches_dx)
    before = counters()
    a = rbgp4_sddmm_rhs(tables, g, x)
    assert torch.equal(a, rbgp4_sddmm_rhs_reference(tables, g, x))
    tt = TransposeTables.build(tl, "cpu")
    rbgp4mm_rhs(tt.tables, g, tt.values(torch.ones(tl.data_shape)))
    assert counters() == before
    empty = rbgp4_sddmm_rhs(tables, g[:0], x[:0])
    assert tuple(empty.shape) == tl.data_shape and not empty.any()


def test_transposed_tables_are_built_only_for_an_input_gradient():
    """``SparseLinear`` builds its transposed tables at the first call that
    needs dX, and not for a forward with gradients on but no input
    gradient (a weight-only gradient needs dW alone)."""
    layer = SparseLinear(64, 128, SparsityConfig(pattern="rbgp4",
                                                 sparsity=0.75, min_dim=64),
                         device="cpu")
    assert layer.mode == "compact"
    x = torch.randn(3, 64, generator=torch.Generator().manual_seed(0))
    layer(x)
    layer.w_data.requires_grad_()
    layer(x).sum().backward()
    assert layer._tables_t is None and layer.w_data.grad is not None
    xg = x.clone().requires_grad_()
    layer(xg).sum().backward()
    assert layer._tables_t is not None and xg.grad is not None
    tt = layer._tables_t
    layer(xg).sum().backward()
    assert layer._tables_t is tt
