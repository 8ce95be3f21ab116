"""The port's feature-major path computes the reference's function.

``rbgp4mm`` (O = W_s @ I for I (K, N), and dI on the transposed layout),
``rbgp4_sddmm`` (compact dW = pack(dO @ I^T)), ``RBGP4Op.matmul`` with its
VJP and ``sparse_matmul``, each run here through its plain version and
held against the JAX package: the Pallas kernels in interpret mode, the
reference's ``RBGP4Op`` under ``jax.grad`` and its ``sparse_matmul``.
Layouts: ``tests/test_kernels.py``'s G = C = 4 layout, and
``design_rbgp4(64, 576, 0.75)`` and ``design_rbgp4(64, 144, 0.75)`` (C = 2),
the narrowest of VGG19-CIFAR's and WideResNet-40-4's sparse convs, with a
ragged N.  Tolerance 1e-5 * max|ref| in float32 (summation order only).
The CUDA kernels run only on the card (``tests/test_torch_cuda.py``); a
plain-torch walk of their tensor-core bodies' decomposition (the k16
steps that pair two C = 8 slots, the contraction warps summed in warp
order, transposed G = 8 on the n8 side, dW's column blocks and token
slices) is held here against the plain versions and the JAX kernels.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import RBGP4Layout as JLayout
from repro.core import RBGP4Spec as JSpec
from repro.core import design_rbgp4 as j_design
from repro.kernels import KernelDims as JDims
from repro.kernels import RBGP4Op as JOp
from repro.kernels import rbgp4_sddmm as j_rbgp4_sddmm
from repro.kernels import rbgp4mm as j_rbgp4mm
from repro.kernels import ref as jref
from repro_torch.core import RBGP4Layout, RBGP4Spec, design_rbgp4
from repro_torch.kernels import (FM_MMA_TILES, FM_SDDMM_TILES,
                                 KernelTables, RBGP4MatMul, RBGP4Op,
                                 TransposeTables, fm_path,
                                 fm_sddmm_path, fm_sddmm_plan, get_op,
                                 rbgp4_sddmm, rbgp4_sddmm_reference, rbgp4mm,
                                 rbgp4mm_reference)
from repro_torch.kernels import ref as tref
from repro_torch.kernels.rbgp4mm import _fm_k_steps

torch.set_num_threads(1)
RTOL = 1e-5

# name -> (m, k) of design_rbgp4(m, k, 0.75), or the test_kernels.py
# G = C = 4 spec (m, k, sp_o, sp_i, G, C, ui, vi)
LAYOUTS = {
    "g4c4": (64, 64, 0.5, 0.5, 4, 4, 4, 4),
    "vgg 64x576": (64, 576),
    "wrn 64x144": (64, 144),
}
N_RAGGED = 37


def pair(name, seed=0):
    """(reference layout, port layout) of the same spec."""
    shape = LAYOUTS[name] if name in LAYOUTS else MMA_LAYOUTS[name]
    if len(shape) == 2:
        return (JLayout(j_design(*shape, 0.75, seed=seed)),
                RBGP4Layout(design_rbgp4(*shape, 0.75, seed=seed)))
    m, k, sp_o, sp_i, G, C, ui, vi = shape
    kw = dict(g_o=(m // (ui * G), k // (vi * C)), g_r=(G, C), g_i=(ui, vi),
              g_b=(1, 1), sp_o=sp_o, sp_i=sp_i, seed=7)
    return JLayout(JSpec(**kw)), RBGP4Layout(RBGP4Spec(**kw))


def randn(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def assert_close(got, want, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max())
    scale = float(np.abs(want).max())
    assert err <= RTOL * scale, (what, err, scale)


def t(a):
    return torch.tensor(np.asarray(a))


# -- the plain versions against the JAX interpret kernels ---------------------

@pytest.mark.parametrize("name", list(LAYOUTS))
@pytest.mark.parametrize("n", [1, N_RAGGED])
def test_rbgp4mm_plain_version_matches_reference_kernel(name, n):
    jl, tl = pair(name)
    rng = np.random.default_rng(1)
    w, x = randn(rng, *tl.data_shape), randn(rng, tl.k, n)
    want = j_rbgp4mm(JDims.from_layout(jl), jnp.asarray(jl.adj_o),
                     jnp.asarray(w), jnp.asarray(x), interpret=True,
                     block_n=16)
    got = rbgp4mm_reference(KernelTables.build(tl, "cpu"), t(x), t(w))
    assert_close(got.numpy(), want, name)
    assert_close(tref.compact_gather_mm(tl, t(w), t(x)).numpy(), want)
    assert_close(tref.ref_rbgp4mm(tl, t(w), t(x)).numpy(),
                 jref.ref_rbgp4mm(jl, jnp.asarray(w), jnp.asarray(x)))


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_rbgp4mm_on_transposed_tables_matches_reference_kernel(name):
    """dI = W_s^T @ dO: the forward on the transposed layout's tables over
    the permuted values, against the reference kernel on its transposed
    layout over ``RBGP4Op.transpose_data``."""
    jl, tl = pair(name)
    rng = np.random.default_rng(2)
    w, g = randn(rng, *tl.data_shape), randn(rng, tl.m, N_RAGGED)
    jop = JOp(jl, interpret=True, block_n=16)
    jlt = jl.transpose_layout()
    want = j_rbgp4mm(JDims.from_layout(jlt), jnp.asarray(jlt.adj_o),
                     jop.transpose_data(jnp.asarray(w)), jnp.asarray(g),
                     interpret=True, block_n=16)
    tt = TransposeTables.build(tl, "cpu")
    assert tt.tables.transposed
    got = rbgp4mm_reference(tt.tables, t(g), tt.values(t(w)))
    assert_close(got.numpy(), want, name)
    # and it is W^T @ dO on the dense matrix
    dense = tl.unpack(w)
    assert_close(got.numpy(), dense.T.astype(np.float64) @ g)


@pytest.mark.parametrize("name", list(LAYOUTS))
@pytest.mark.parametrize("n", [1, N_RAGGED])
def test_rbgp4_sddmm_plain_version_matches_reference_kernel(name, n):
    jl, tl = pair(name)
    rng = np.random.default_rng(3)
    g, x = randn(rng, tl.m, n), randn(rng, tl.k, n)
    want = j_rbgp4_sddmm(JDims.from_layout(jl), jnp.asarray(jl.adj_o),
                         jnp.asarray(g), jnp.asarray(x), interpret=True,
                         block_n=16)
    got = rbgp4_sddmm_reference(KernelTables.build(tl, "cpu"), t(g), t(x))
    assert tuple(got.shape) == tl.data_shape
    assert_close(got.numpy(), want, name)
    assert_close(tref.ref_rbgp4_sddmm(tl, t(g), t(x)).numpy(),
                 jref.ref_rbgp4_sddmm(jl, jnp.asarray(g), jnp.asarray(x)))


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_col0_addressing_is_the_layout(name):
    """What the CUDA kernels compute from ``col0``, written out in numpy:
    row ``rg*G + g``, slot ``s`` reads input rows ``col0[rg, s] + c``.  It
    must be the dense product, and the SDDMM its masked gradient."""
    _, tl = pair(name)
    tables = KernelTables.build(tl, "cpu")
    d = tables.dims
    col0 = tables.col0.numpy().astype(np.int64)
    rng = np.random.default_rng(4)
    w, x, g = (randn(rng, *tl.data_shape), randn(rng, tl.k, 5),
               randn(rng, tl.m, 5))
    out = np.zeros((tl.m, 5))
    dw = np.zeros(tl.data_shape)
    for m in range(tl.m):
        rg = m // d.group_rows
        for s in range(d.d_o * d.d_i):
            for c in range(d.chunk_cols):
                row = col0[rg, s] + c
                out[m] += w[m, s * d.chunk_cols + c] * x[row]
                dw[m, s * d.chunk_cols + c] = g[m] @ x[row]
    dense = tl.unpack(w).astype(np.float64)
    assert_close(out, dense @ x)
    assert_close(dw, tl.pack((g.astype(np.float64) @ x.T)))


def test_plain_versions_are_what_cpu_tensors_run():
    _, tl = pair("g4c4")
    tables = KernelTables.build(tl, "cpu")
    gen = torch.Generator().manual_seed(0)
    w = torch.randn(tl.data_shape, generator=gen)
    x = torch.randn(tl.k, 9, generator=gen)
    g = torch.randn(tl.m, 9, generator=gen)
    counts = (rbgp4mm.launches, rbgp4mm.launches_dx, rbgp4_sddmm.launches)
    assert torch.equal(rbgp4mm(tables, x, w),
                       rbgp4mm_reference(tables, x, w))
    assert torch.equal(rbgp4_sddmm(tables, g, x),
                       rbgp4_sddmm_reference(tables, g, x))
    assert (rbgp4mm.launches, rbgp4mm.launches_dx,
            rbgp4_sddmm.launches) == counts
    assert tuple(rbgp4mm(tables, x[:, :0], w).shape) == (tl.m, 0)
    assert not rbgp4_sddmm(tables, g[:, :0], x[:, :0]).any()
    with pytest.raises(ValueError):
        rbgp4mm(tables, x[:-1], w)
    with pytest.raises(ValueError):
        rbgp4_sddmm(tables, g[:, :-1], x)


# -- RBGP4Op.matmul and its VJP -----------------------------------------------

@pytest.mark.parametrize("name", list(LAYOUTS))
def test_matmul_vjp_matches_reference_and_dense_autograd(name):
    """O, dW and dI of ``RBGP4Op.matmul`` against ``jax.grad`` through the
    reference's ``RBGP4Op.matmul`` (its Pallas kernels in interpret mode),
    and against autograd through the dense matrix ``unpack_dense``: a
    wrong ``col0`` or slot permutation would still give plausible
    numbers."""
    jl, tl = pair(name)
    rng = np.random.default_rng(5)
    w, x = randn(rng, *tl.data_shape), randn(rng, tl.k, N_RAGGED)
    cot = randn(rng, tl.m, N_RAGGED)
    jop = JOp(jl, interpret=True, block_n=16)
    jo, pull = jax.vjp(jop.matmul, jnp.asarray(w), jnp.asarray(x))
    jdw, jdx = pull(jnp.asarray(cot))

    op = RBGP4Op(tl, device="cpu")
    wt, xt = t(w).requires_grad_(), t(x).requires_grad_()
    out = op.matmul(wt, xt)
    out.backward(t(cot))
    assert_close(out.detach().numpy(), jo, "O")
    assert_close(wt.grad.numpy(), jdw, "dW")
    assert_close(xt.grad.numpy(), jdx, "dI")

    wd, xd = t(w).requires_grad_(), t(x).requires_grad_()
    (tref.unpack_dense(tl, wd) @ xd).backward(t(cot))
    assert_close(wt.grad.numpy(), wd.grad.numpy(), "dW vs dense")
    assert_close(xt.grad.numpy(), xd.grad.numpy(), "dI vs dense")


def test_matmul_builds_transposed_tables_only_for_an_input_gradient():
    _, tl = pair("g4c4")
    op = RBGP4Op(tl, device="cpu")
    gen = torch.Generator().manual_seed(6)
    w = torch.randn(tl.data_shape, generator=gen).requires_grad_()
    x = torch.randn(tl.k, 7, generator=gen)
    op.matmul(w, x).sum().backward()
    assert op._tables_t is None and w.grad is not None
    xg = x.clone().requires_grad_()
    op.matmul(w.detach(), xg).sum().backward()
    assert op._tables_t is not None and xg.grad is not None
    with pytest.raises(ValueError, match="transposed"):
        RBGP4MatMul.apply(w.detach(), xg, op.tables, None)


def test_op_bundle_matches_reference_op():
    """``linear``, ``linear_stacked``, ``transpose_data`` and
    ``init_data`` of the port's ``RBGP4Op`` against the reference's."""
    jl, tl = pair("vgg 64x576")
    jop, op = JOp(jl, interpret=True, block_n=16), RBGP4Op(tl, device="cpu")
    rng = np.random.default_rng(7)
    w, x = randn(rng, *tl.data_shape), randn(rng, 2, 3, tl.k)
    b, r = randn(rng, tl.m), randn(rng, 2, 3, tl.m)
    want = jop.linear(jnp.asarray(x), jnp.asarray(w), bias=jnp.asarray(b),
                      fuse="gelu", residual=jnp.asarray(r))
    got = op.linear(t(x), t(w), bias=t(b), fuse="gelu", residual=t(r))
    assert_close(got.numpy(), want, "linear")
    ws, xs = randn(rng, 3, *tl.data_shape), randn(rng, 3, 5, tl.k)
    want = jop.linear_stacked(jnp.asarray(xs), jnp.asarray(ws), fuse="silu")
    got = op.linear_stacked(t(xs), t(ws), fuse="silu")
    assert_close(got.numpy(), want, "linear_stacked")
    np.testing.assert_array_equal(op.transpose_data(t(w)).numpy(),
                                  np.asarray(jop.transpose_data(
                                      jnp.asarray(w))))
    np.testing.assert_array_equal(
        op.transpose_data_stacked(t(ws)).numpy(),
        np.asarray(jop.transpose_data_stacked(jnp.asarray(ws))))
    init = op.init_data(torch.Generator().manual_seed(0))
    assert tuple(init.shape) == tl.data_shape
    assert abs(float(init.std()) - (2.0 / tl.spec.nnz_per_row) ** 0.5) < 0.05


# -- get_op --------------------------------------------------------------------

def test_get_op_is_keyed_on_layout_content_and_device():
    _, tl = pair("vgg 64x576")
    _, again = pair("vgg 64x576")
    op = get_op(tl, "cpu")
    assert get_op(again, "cpu") is op and op.device == torch.device("cpu")
    # a square spec transposes to itself: a layout designed from the
    # transposed spec is the forward layout again (one op), while the
    # transpose_layout() product has that spec but the transposed graph
    # samples (its own op); a key on the spec alone would mix them up
    sq = RBGP4Layout(design_rbgp4(128, 128, 0.75, seed=0))
    prod = sq.transpose_layout()
    fresh = RBGP4Layout(sq.spec.transpose())
    assert prod.spec == fresh.spec == sq.spec
    assert not np.array_equal(prod.adj_i, fresh.adj_i)
    assert get_op(fresh, "cpu") is get_op(sq, "cpu")
    assert get_op(prod, "cpu") is not get_op(fresh, "cpu")
    assert get_op(prod, "cpu") is get_op(sq.transpose_layout(), "cpu")


# -- sparse_matmul ---------------------------------------------------------------

def _containers(kind, bias, rng):
    """(reference container, port container, numpy leaves)."""
    from repro.core import ChainLayout as JChainLayout
    from repro.core import design_rbgp as j_design_rbgp
    from repro.sparsity import ChainWeight as JChain
    from repro.sparsity import CompactWeight as JCompact
    from repro.sparsity import DenseWeight as JDense
    from repro_torch.core import ChainLayout, design_rbgp
    from repro_torch.kernels import chain_tables, chain_transpose_tables
    from repro_torch.sparsity import ChainWeight, CompactWeight, DenseWeight

    if kind == "compact":
        jl, tl = pair("vgg 64x576")
        shape = tl.data_shape
    elif kind == "chain":
        factors = (("complete", 4, 4, 0.0), ("ramanujan", 0, 0, 0.5),
                   ("ramanujan", 0, 0, 0.5), ("ramanujan", 0, 0, 0.5),
                   ("complete", 2, 2, 0.0))
        jl = JChainLayout(j_design_rbgp(128, 256, 0.875, factors=factors,
                                        seed=1))
        tl = ChainLayout(design_rbgp(128, 256, 0.875, factors=factors,
                                     seed=1))
        shape = tl.data_shape
    else:
        jl = tl = None
        shape = (48, 80)
    m = shape[0]
    w = randn(rng, *shape)
    b = randn(rng, m) if bias else None
    jb = jnp.asarray(b) if bias else None
    tb = t(b) if bias else None
    if kind == "compact":
        op = RBGP4Op(tl, device="cpu")
        jw = JCompact(w_data=jnp.asarray(w), b=jb, layout=jl)
        tw = CompactWeight(w_data=t(w), tables=op.tables, b=tb,
                           tables_t=op.transpose_tables)
        k = tl.k
    elif kind == "chain":
        jw = JChain(w_data=jnp.asarray(w), b=jb, layout=jl)
        tw = ChainWeight(w_data=t(w), tables=chain_tables(tl, "cpu"), b=tb,
                         tables_t=lambda: chain_transpose_tables(tl, "cpu"))
        k = tl.k
    else:
        jw, tw, k = JDense(w=jnp.asarray(w), b=jb), DenseWeight(w=t(w), b=tb), 80
    return jw, tw, k


@pytest.mark.parametrize("kind,bias", [("compact", False), ("compact", True),
                                       ("dense", True), ("chain", True)])
def test_sparse_matmul_matches_reference(kind, bias):
    """Values and gradients (w, b, x) of ``sparse_matmul`` against the
    reference's ``sparse_matmul`` on the same container."""
    from repro.sparsity import sparse_matmul as j_sparse_matmul
    from repro_torch.sparsity import sparse_matmul

    rng = np.random.default_rng(8)
    jw, tw, k = _containers(kind, bias, rng)
    x = randn(rng, k, N_RAGGED)
    leaf = "w" if kind == "dense" else "w_data"
    jleaves = {leaf: getattr(jw, leaf)}
    if bias:
        jleaves["b"] = jw.b

    def jfn(leaves, xx):
        return j_sparse_matmul(dataclasses.replace(jw, **leaves), xx)

    jo, pull = jax.vjp(jfn, jleaves, jnp.asarray(x))
    cot = randn(rng, *jo.shape)
    jgl, jgx = pull(jnp.asarray(cot))

    tleaves = {name: getattr(tw, name).requires_grad_() for name in jleaves}
    xt = t(x).requires_grad_()
    out = sparse_matmul(tw, xt)
    out.backward(t(cot))
    assert_close(out.detach().numpy(), jo, f"{kind} O")
    assert_close(xt.grad.numpy(), jgx, f"{kind} dI")
    for name, leaf_t in tleaves.items():
        assert_close(leaf_t.grad.numpy(), jgl[name], f"{kind} d{name}")


def test_sparse_matmul_without_gradients_calls_the_kernel_wrapper():
    from repro_torch.sparsity import sparse_matmul

    rng = np.random.default_rng(9)
    _, tw, k = _containers("compact", False, rng)
    x = t(randn(rng, k, 11))
    with torch.no_grad():
        out = sparse_matmul(tw, x, dtype=torch.bfloat16)
    assert out.dtype == torch.bfloat16 and tuple(out.shape) == (64, 11)
    want = rbgp4mm(tw.tables, x.bfloat16(), tw.w_data.bfloat16())
    assert torch.equal(out, want)


# -- VGG19-CIFAR at full width: shapes and layouts --------------------------------

def test_chip_smoke_vgg19_shapes_are_table1s():
    from benchmarks.table1_models import sparse_layer_shapes
    import chip_smoke

    assert chip_smoke.vgg19_sdmm_layers() == sparse_layer_shapes("vgg19")[0]


VGG19_LAYOUTS = [(64, 576), (128, 576), (128, 1152), (256, 1152),
                 (256, 2304), (512, 2304), (512, 4608), (64, 144)]


@pytest.mark.parametrize("m,k", VGG19_LAYOUTS)
def test_full_width_layouts_match_reference(m, k):
    """The port's ``design_rbgp4`` at VGG19-CIFAR's seven distinct sparse
    layouts (and WRN-40-4's 64 x 144): the same spec, adjacencies, slot
    order and transposed permutation as the reference's; G = 16 and the
    outer graph complete, one slot per 3x3 tap."""
    js, ts = j_design(m, k, 0.75), design_rbgp4(m, k, 0.75)
    jl, tl = JLayout(js), RBGP4Layout(ts)
    assert (js.g_o, js.g_r, js.g_i, js.g_b, js.sp_o, js.sp_i, js.seed) == \
        (ts.g_o, ts.g_r, ts.g_i, ts.g_b, ts.sp_o, ts.sp_i, ts.seed)
    for a in ("adj_o", "adj_i"):
        np.testing.assert_array_equal(getattr(jl, a), getattr(tl, a))
    np.testing.assert_array_equal(jl._col_index(), tl._col_index())
    np.testing.assert_array_equal(jl.transpose_perm(), tl.transpose_perm())
    assert ts.group_rows == 16 and ts.g_o == (1, 9)
    assert ts.d_o * ts.d_i == 18 and ts.chunk_cols == k // 72


# -- the device default (SparseLinear, RBGP4Op) ---------------------------------

def test_sparse_linear_and_op_default_to_the_card():
    """Without ``device`` the port builds on the card; with no CUDA that
    raises and names ``device="cpu"`` (the JAX ``SparseLinear`` places its
    values on the accelerator too)."""
    from repro_torch.sparsity import SparseLinear, SparsityConfig

    cfg = SparsityConfig(pattern="rbgp4", sparsity=0.75, min_dim=64)
    if torch.cuda.is_available():
        assert SparseLinear(64, 128, cfg).w_data.device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SparseLinear(64, 128, cfg)
    _, tl = pair("g4c4")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        RBGP4Op(tl)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        get_op(tl)
    layer = SparseLinear(64, 128, cfg, device="cpu")
    assert layer.w_data.device.type == "cpu"


def test_moe_modules_default_to_the_card():
    """``StackedExperts`` and ``MoELayer`` resolve a missing ``device``
    the same way."""
    from repro_torch.configs.base import MoEConfig
    from repro_torch.models.moe import MoELayer, StackedExperts
    from repro_torch.sparsity import SparsityConfig

    cfg = SparsityConfig(pattern="rbgp4", sparsity=0.75, min_dim=64)
    moe = MoEConfig(n_experts=4, top_k=2, n_shared=1, d_expert=64)
    if torch.cuda.is_available():
        assert StackedExperts(4, 64, 64, cfg).tables["in"].col0.is_cuda
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        StackedExperts(4, 64, 64, cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MoELayer(64, moe, cfg, "silu")
    assert MoELayer(64, moe, cfg, "silu", device="cpu").router.device.type \
        == "cpu"


# -- the tensor-core bodies' decomposition, walked on the CPU ------------------

# a small layout with VGG19's forward shape (G = 16, C = 8; transposed
# G = 8, C = 16) beside VGG19's narrowest layer
MMA_LAYOUTS = {
    "g16c8": (64, 32, 0.5, 0.5, 16, 8, 2, 2),
    "vgg 64x576": (64, 576),
}


def walk_fm(tables, x, w, tile):
    """O = W_s @ I as ``rbgp4mm``'s tensor-core body computes it, in
    float32: per row-group class (``tables.classes``) and tile of
    ``tile[0]`` class rows by 128 tokens, the class rows gathered
    through ``groups`` (rows past the class left out) and the input rows
    through the class's one ``col0`` row, one compact column at a time
    (zero past the row, up to a whole k16 step); each contraction warp of
    ``_fm_k_steps`` sums its k16 steps in order, the warps' sums added in
    warp order; written into the rows' own places."""
    d = tables.dims
    cl = tables.classes
    G, C, length = d.group_rows, d.chunk_cols, d.data_cols
    klen = -(-length // 16) * 16
    n = x.shape[1]
    out = torch.full((d.m, n), float("nan"))
    kk = torch.arange(length)
    steps = _fm_k_steps(d, tile[2])
    groups, start = cl.groups.long(), cl.start.long()
    for c in range(cl.n_classes):
        members = groups[start[c]:start[c + 1]]
        rows = (members[:, None] * G + torch.arange(G)).reshape(-1)
        xi = torch.zeros((klen, n))
        xi[:length] = x[cl.col0[c].long()[kk // C] + kk % C]
        for i0 in range(0, len(rows), tile[0]):
            r = rows[i0:i0 + tile[0]]
            wr = torch.zeros((len(r), klen))
            wr[:, :length] = w[r]
            for n0 in range(0, n, 128):
                tok = slice(n0, min(n0 + 128, n))
                total = None
                for own in steps:
                    acc = torch.zeros((len(r), tok.stop - n0))
                    for s_ in own:
                        k16 = slice(16 * s_, 16 * s_ + 16)
                        acc = acc + wr[:, k16] @ xi[k16, tok]
                    total = acc if total is None else total + acc
                out[r, tok] = total
    return out


def walk_fm_sddmm(tables, g, x, plan):
    """Compact dW as ``rbgp4_sddmm``'s tensor-core body computes it, in
    float32: blocks of 16 rows by ``plan.block_cols`` compact columns
    (several slots a block where C is smaller), the input rows gathered
    through ``col0``, each slice's tokens in stages of
    ``plan.stage_tokens``, the slices' partial sums added in slice
    order."""
    d = tables.dims
    G, C, length = d.group_rows, d.chunk_cols, d.data_cols
    col0 = tables.col0.long()
    n = x.shape[1]
    dw = torch.full((d.m, length), float("nan"))
    for r0 in range(0, d.m, 16):
        rg = r0 // G
        for j0 in range(0, length, plan.block_cols):
            cols = torch.arange(j0, min(j0 + plan.block_cols, length))
            xr = x[col0[rg, cols // C] + cols % C]
            total = None
            for sl in range(plan.n_slices):
                t0 = sl * plan.slice_len
                t1 = min(n, t0 + plan.slice_len)
                assert t1 > t0, "an empty slice"
                acc = torch.zeros((16, len(cols)))
                for s0 in range(t0, t1, plan.stage_tokens):
                    st = slice(s0, min(s0 + plan.stage_tokens, t1))
                    acc = acc + g[r0:r0 + 16, st] @ xr[:, st].T
                total = acc if total is None else total + acc
            dw[r0:r0 + 16, cols] = total
    return dw


def _assert_walked(got, want, what):
    assert not torch.isnan(got).any(), (what, "an output no block wrote")
    assert_close(got.numpy(), want, what)


@pytest.mark.parametrize("name", list(MMA_LAYOUTS))
def test_k16_steps_pair_two_slots_at_c8(name):
    """At C = 8 every k16 step of the forward tables holds two adjacent
    slots (compact columns 16s .. 16s+15 are slots 2s and 2s+1), and the
    gathered rows of a step are those two slots' input rows."""
    _, tl = pair(name)
    tables = KernelTables.build(tl, "cpu")
    d = tables.dims
    assert d.chunk_cols == 8 and d.group_rows == 16
    col0 = tables.col0.long()
    kk = torch.arange(d.data_cols)
    for rg in range(d.m // d.group_rows):
        rows = col0[rg, kk // 8] + kk % 8
        for s_ in range(d.data_cols // 16):
            step = rows[16 * s_:16 * s_ + 16]
            assert torch.equal(step[:8], col0[rg, 2 * s_] + torch.arange(8))
            assert torch.equal(step[8:],
                               col0[rg, 2 * s_ + 1] + torch.arange(8))


@pytest.mark.parametrize("name", list(MMA_LAYOUTS))
@pytest.mark.parametrize("transposed", [False, True])
@pytest.mark.parametrize("tile", FM_MMA_TILES)
def test_fm_mma_walk_matches_plain_version(name, transposed, tile):
    """The forward body's walk at every built tile, on the forward tables
    (C = 8) and the transposed ones (G = 8, classes of 2 and 18 row
    groups, so some class tiles are ragged) from ``transpose_layout()``,
    against ``rbgp4mm_reference`` at a whole and a ragged token tile."""
    _, tl = pair(name)
    rng = np.random.default_rng(10)
    n = 152
    if transposed:
        tt = TransposeTables.build(tl, "cpu")
        tables = tt.tables
        w = tt.values(t(randn(rng, *tl.data_shape)))
        x = t(randn(rng, tl.m, n))
    else:
        tables = KernelTables.build(tl, "cpu")
        w, x = t(randn(rng, *tl.data_shape)), t(randn(rng, tl.k, n))
    assert fm_path(tables.dims, n, torch.bfloat16) == "mma"
    got = walk_fm(tables, x, w, tile)
    _assert_walked(got, rbgp4mm_reference(tables, x, w).numpy(),
                   (name, transposed, tile))


@pytest.mark.parametrize("name", list(MMA_LAYOUTS))
def test_fm_mma_walk_matches_reference_kernels(name):
    """The walk (the wrappers' own tiles) on the forward and transposed
    tables against the JAX kernels in interpret mode: O and dI."""
    from repro_torch.kernels import fm_mma_tile

    jl, tl = pair(name)
    rng = np.random.default_rng(11)
    n = 136
    w, x, g = (randn(rng, *tl.data_shape), randn(rng, tl.k, n),
               randn(rng, tl.m, n))
    tables = KernelTables.build(tl, "cpu")
    want = j_rbgp4mm(JDims.from_layout(jl), jnp.asarray(jl.adj_o),
                     jnp.asarray(w), jnp.asarray(x), interpret=True,
                     block_n=128)
    _assert_walked(walk_fm(tables, t(x), t(w),
                           fm_mma_tile(tables, n)), want, "O")
    jop = JOp(jl, interpret=True, block_n=128)
    jlt = jl.transpose_layout()
    want = j_rbgp4mm(JDims.from_layout(jlt), jnp.asarray(jlt.adj_o),
                     jop.transpose_data(jnp.asarray(w)), jnp.asarray(g),
                     interpret=True, block_n=128)
    tt = TransposeTables.build(tl, "cpu")
    _assert_walked(walk_fm(tt.tables, t(g), tt.values(t(w)),
                           fm_mma_tile(tt.tables, n)), want, "dI")


@pytest.mark.parametrize("name", list(MMA_LAYOUTS))
@pytest.mark.parametrize("bc", FM_SDDMM_TILES)
def test_fm_sddmm_walk_matches_plain_version_and_reference(name, bc):
    """The dW body's walk with each built block of columns and its token
    slices (520 tokens on 132 SMs: three slices, the last ragged) against
    ``rbgp4_sddmm_reference`` and the JAX kernel in interpret mode."""
    jl, tl = pair(name)
    tables = KernelTables.build(tl, "cpu")
    rng = np.random.default_rng(12)
    n = 520
    g, x = randn(rng, tl.m, n), randn(rng, tl.k, n)
    assert fm_sddmm_path(tables.dims, n, torch.bfloat16) == "mma"
    plan = fm_sddmm_plan(tables.dims, n, 132, bc)
    assert plan.n_slices == 3 and plan.slice_len % plan.stage_tokens == 0
    got = walk_fm_sddmm(tables, t(g), t(x), plan)
    _assert_walked(got, rbgp4_sddmm_reference(tables, t(g), t(x)).numpy(),
                   (name, bc))
    want = j_rbgp4_sddmm(JDims.from_layout(jl), jnp.asarray(jl.adj_o),
                         jnp.asarray(g), jnp.asarray(x), interpret=True,
                         block_n=128)
    _assert_walked(got, np.asarray(want), (name, bc, "reference kernel"))
