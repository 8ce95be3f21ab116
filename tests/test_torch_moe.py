"""The port's MoE kernels and modules against the reference's, on the CPU.

The stacked products (``rbgp4mm_rhs_stacked``, ``rbgp4_sddmm_rhs_stacked``)
run their plain versions here and are held against the JAX package's
stacked Pallas kernels and ``RBGP4Op.linear_stacked``'s custom VJP
(interpret mode, ``block_n=8``), E = 4, on small layouts; their gradients
also against dense autograd through ``unpack_dense``, per expert, since a
wrong per-expert offset into the transpose permutation still gives
plausible numbers.  Then ``StackedExperts`` and ``MoELayer`` (the JAX side
on the ``pallas`` backend, interpret mode): outputs, aux loss and
gradients, with and without full capacity.  The reduced qwen2-moe model
is held against the reference in ``test_torch_moe_model.py`` and
``test_torch_moe_train.py``.

Tolerances: 1e-5 * max|ref| for one product, 1e-4 * max|ref| for a layer
or a gradient (float32 throughout; the gap is summation order).  Routing
is discrete, so every parity test over routed tokens also asserts that
the smallest top-k margin of the router probabilities (k-th minus
(k+1)-th) is at least ``MARGIN``, 1e-4, about a thousand times the float32
noise of the probabilities: a routing flip would be reported as such, not
as a tolerance miss.
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import MoEConfig as JMoEConfig
from repro.core import RBGP4Layout as JLayout
from repro.core import RBGP4Spec as JSpec
from repro.kernels import KernelDims as JDims
from repro.kernels import RBGP4Op
from repro.kernels import rbgp4_sddmm_rhs_stacked as j_sddmm_stacked
from repro.kernels import rbgp4mm_rhs_stacked as j_mm_stacked
from repro.models.moe import MoELayer as JMoELayer
from repro.models.moe import StackedExperts as JStackedExperts
from repro.sparsity import SparsityConfig as JSparsityConfig
from repro_torch.configs import MoEConfig
from repro_torch.core import RBGP4Layout, RBGP4Spec
from repro_torch.kernels import (KernelTables, RBGP4LinearStacked,
                                 TransposeTables, rbgp4_sddmm_rhs_stacked,
                                 stacked_sddmm_tile,
                                 rbgp4mm_rhs_stacked)
from repro_torch.kernels.ref import pack_compact, unpack_dense
from repro_torch.models.moe import MoELayer, StackedExperts
from repro_torch.sparsity import SparsityConfig

from test_torch_model import jax_tree_to_numpy

torch.set_num_threads(1)
RTOL = 1e-4
RTOL_PRODUCT = 1e-5
MARGIN = 1e-4
E = 4

# m, k, n, sp_o, sp_i, G, C, ui, vi (tests/test_fused_kernels.py sweep)
SWEEP = [
    (64, 64, 16, 0.5, 0.5, 4, 4, 4, 4),
    (128, 64, 32, 0.75, 0.0, 4, 8, 4, 2),
    (64, 128, 13, 0.0, 0.5, 8, 8, 2, 4),   # n not a block multiple
]
EPILOGUES = [(None, False), ("silu", False), ("gelu", True)]
SP = dict(pattern="rbgp4", sparsity=0.75, min_dim=64)


def layouts(m, k, sp_o, sp_i, G, C, ui, vi, seed=31):
    kw = dict(g_o=(m // (ui * G), k // (vi * C)), g_r=(G, C), g_i=(ui, vi),
              g_b=(1, 1), sp_o=sp_o, sp_i=sp_i, seed=seed)
    return JLayout(JSpec(**kw)), RBGP4Layout(RBGP4Spec(**kw))


def assert_close(got, want, rtol=RTOL, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = float(np.abs(got - want).max())
    scale = float(np.abs(want).max())
    assert err <= rtol * scale, (what, err, scale)


def randn(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def flatten(tree: dict, prefix: str = "") -> dict:
    """A JAX parameter tree (numpy leaves, containers as their field
    dicts) as {dotted name: array}, the port's ``state_dict`` names."""
    out = {}
    for k, v in tree.items():
        name = f"{prefix}.{k}" if prefix else k
        if isinstance(v, dict):
            out.update(flatten(v, name))
        elif v is not None:
            out[name] = np.asarray(v)
    return out


def load_module(module, tree: dict) -> None:
    """Load a JAX parameter tree into ``module``; every name must match."""
    module.load_state_dict({k: torch.tensor(v)
                            for k, v in flatten(tree).items()}, strict=True)


@contextlib.contextmanager
def topk_margins(module):
    """Collects, for every ``MoELayer`` call inside ``module``, the smallest
    gap between the k-th and (k+1)-th router probability over its tokens."""
    margins = []

    def hook(layer, args):
        margins.append(layer.topk_margin(args[0]))

    handles = [m.register_forward_pre_hook(hook) for m in module.modules()
               if isinstance(m, MoELayer)]
    try:
        yield margins
    finally:
        for h in handles:
            h.remove()
    assert margins, "no MoE layer ran"
    assert min(margins) >= MARGIN, ("a near tie in the routing", margins)


# -- the stacked products ----------------------------------------------------

@pytest.mark.parametrize("act,bias", EPILOGUES)
@pytest.mark.parametrize("shape", SWEEP)
def test_plain_stacked_mm_matches_reference_kernel(shape, act, bias):
    m, k, n, sp_o, sp_i, G, C, ui, vi = shape
    jl, tl = layouts(m, k, sp_o, sp_i, G, C, ui, vi)
    rng = np.random.default_rng(n + m)
    x, w = randn(rng, E, n, k), randn(rng, E, *tl.data_shape)
    b = randn(rng, E, m) if bias else None
    jy, jz = j_mm_stacked(JDims.from_layout(jl), jnp.asarray(jl.adj_o),
                          jnp.asarray(x), jnp.asarray(w), interpret=True,
                          block_n=8, act=act, save_preact=True,
                          bias=None if b is None else jnp.asarray(b))
    tables = KernelTables.build(tl, "cpu")
    tb = None if b is None else torch.tensor(b)
    y, z = rbgp4mm_rhs_stacked(tables, torch.tensor(x), torch.tensor(w),
                               bias=tb, act=act, save_preact=True)
    assert tuple(y.shape) == (E, n, m) and y.dtype == torch.float32
    assert_close(y.numpy(), jy, RTOL_PRODUCT)
    assert_close(z.numpy(), jz, RTOL_PRODUCT)
    y1 = rbgp4mm_rhs_stacked(tables, torch.tensor(x), torch.tensor(w),
                             bias=tb, act=act)
    assert torch.equal(y1, y)


@pytest.mark.parametrize("shape", SWEEP)
def test_plain_stacked_sddmm_matches_reference_kernel(shape):
    m, k, n, sp_o, sp_i, G, C, ui, vi = shape
    jl, tl = layouts(m, k, sp_o, sp_i, G, C, ui, vi)
    rng = np.random.default_rng(m + k + n)
    g, x = randn(rng, E, n, m), randn(rng, E, n, k)
    want = j_sddmm_stacked(JDims.from_layout(jl), jnp.asarray(jl.adj_o),
                           jnp.asarray(g), jnp.asarray(x), interpret=True,
                           block_n=8)
    got = rbgp4_sddmm_rhs_stacked(KernelTables.build(tl, "cpu"),
                                  torch.tensor(g), torch.tensor(x))
    assert tuple(got.shape) == (E, *tl.data_shape)
    assert_close(got.numpy(), want, RTOL_PRODUCT)
    # and against the dense products, packed per expert
    dense = torch.tensor(g).transpose(1, 2) @ torch.tensor(x)
    assert_close(got.numpy(), pack_compact(tl, dense).numpy(), RTOL_PRODUCT)


# layouts with G and C multiples of 16, the stacked dW tensor-core body's:
# C = 16 with 2 slots a row (a block of 32 columns spans both) and C = 32
# with 4 (a block of 128 columns spans all)
MMA_SWEEP = [
    (128, 128, 0, 0.5, 0.5, 16, 16, 2, 2),
    (128, 256, 0, 0.0, 0.5, 16, 32, 2, 2),
]


def walk_stacked_sddmm_blocks(tables, g, x, tile):
    """dW as ``rbgp4_sddmm_rhs_stacked``'s tensor-core body computes it
    with block ``tile`` = (block_cols, stage_tokens), in float32: for each
    expert, 16-row sub-tile and block of ``block_cols`` compact columns
    (several slots where C is smaller; columns past the row left out),
    the tokens in stages of ``stage_tokens``, warp w of a stage summing
    its tokens 16w .. 16w+15 into its own sums, the warps' sums added in
    warp order at the end."""
    dims = tables.dims
    bc, stage = tile
    warps = stage // 16
    row_len, C = dims.data_cols, dims.chunk_cols
    e, n, m = g.shape
    j = torch.arange(row_len)
    dw = torch.full((e, m, row_len), float("nan"))
    for ex in range(e):
        for r0 in range(0, m, 16):
            cols = tables.col0[r0 // dims.group_rows].long()[j // C] + j % C
            for j0 in range(0, row_len, bc):
                cc = cols[j0:j0 + bc]
                sums = torch.zeros((warps, 16, len(cc)))
                for t0 in range(0, n, stage):
                    for w in range(warps):
                        a, b = t0 + 16 * w, min(t0 + 16 * w + 16, n)
                        if a < b:
                            sums[w] += g[ex, a:b, r0:r0 + 16].T @ \
                                x[ex, a:b][:, cc]
                out = torch.zeros((16, len(cc)))
                for w in range(warps):
                    out += sums[w]
                dw[ex, r0:r0 + 16, j0:j0 + len(cc)] = out
    return dw


@pytest.mark.parametrize("n", [13, 77])
@pytest.mark.parametrize("shape", MMA_SWEEP)
def test_stacked_sddmm_block_walk_matches_reference_kernel(shape, n):
    """The blocking ``stacked_sddmm_tile`` picks (slots spanned by one
    block, ragged stages), walked in float32, gives the plain version's
    dW, which gives the reference kernel's."""
    m, k, _, sp_o, sp_i, G, C, ui, vi = shape
    jl, tl = layouts(m, k, sp_o, sp_i, G, C, ui, vi)
    rng = np.random.default_rng(m + k + n)
    g, x = randn(rng, E, n, m), randn(rng, E, n, k)
    tables = KernelTables.build(tl, "cpu")
    tile = stacked_sddmm_tile(tables.dims, n)
    want = j_sddmm_stacked(JDims.from_layout(jl), jnp.asarray(jl.adj_o),
                           jnp.asarray(g), jnp.asarray(x), interpret=True,
                           block_n=8)
    plain = rbgp4_sddmm_rhs_stacked(tables, torch.tensor(g),
                                    torch.tensor(x))
    assert_close(plain.numpy(), want, RTOL_PRODUCT)
    got = walk_stacked_sddmm_blocks(tables, torch.tensor(g), torch.tensor(x),
                                    tile)
    assert not torch.isnan(got).any(), "an output no block wrote"
    assert_close(got.numpy(), plain.numpy(), RTOL_PRODUCT, tile)
    if tile[0] > C:
        assert tables.dims.data_cols > C, "the block spans slots"


def linear_stacked_both(shape, fuse, bias, seed=0):
    """(port forward + grads, reference forward + grads) of one stacked
    projection."""
    m, k, n, sp_o, sp_i, G, C, ui, vi = shape
    jl, tl = layouts(m, k, sp_o, sp_i, G, C, ui, vi)
    rng = np.random.default_rng(seed)
    x, w = randn(rng, E, n, k), randn(rng, E, *tl.data_shape)
    gy = randn(rng, E, n, m)
    b = randn(rng, E, m) if bias else None
    op = RBGP4Op(jl, interpret=True, block_n=8)
    jy, pull = jax.vjp(
        lambda x, w, b: op.linear_stacked(x, w, bias=b, fuse=fuse),
        jnp.asarray(x), jnp.asarray(w),
        None if b is None else jnp.asarray(b))
    want = [np.asarray(jy)] + [None if v is None else np.asarray(v)
                               for v in pull(jnp.asarray(gy))]
    leaf = lambda a: None if a is None else torch.tensor(a).requires_grad_()
    tx, tw, tb = leaf(x), leaf(w), leaf(b)
    ty = RBGP4LinearStacked.apply(tx, tw, tb, KernelTables.build(tl, "cpu"),
                                  TransposeTables.build(tl, "cpu"), fuse)
    ty.backward(torch.tensor(gy))
    got = [ty.detach().numpy()] + [None if t is None else t.grad.numpy()
                                   for t in (tx, tw, tb)]
    return tl, (x, w, gy), got, want


@pytest.mark.parametrize("fuse,bias", EPILOGUES)
@pytest.mark.parametrize("shape", SWEEP[:2])
def test_linear_stacked_matches_reference_vjp(shape, fuse, bias):
    """y, dX, dW and db against ``jax.vjp`` of the reference's
    ``RBGP4Op.linear_stacked`` (its custom VJP on the stacked kernels)."""
    _, _, got, want = linear_stacked_both(shape, fuse, bias)
    for name, a, b in zip(("y", "dx", "dw", "db"), got, want):
        assert (a is None) == (b is None), name
        if a is not None:
            assert_close(a, b, RTOL, name)


@pytest.mark.parametrize("fuse", [None, "silu"])
@pytest.mark.parametrize("shape", [SWEEP[0], SWEEP[2]])
def test_linear_stacked_grads_match_dense_autograd(shape, fuse):
    """dW and dX of every expert equal autograd through its dense matrix,
    packed: what a wrong per-expert offset into ``perm`` would break."""
    tl, (x, w, gy), got, _ = linear_stacked_both(shape, fuse, False, seed=5)
    tx = torch.tensor(x).requires_grad_()
    wd = unpack_dense(tl, torch.tensor(w)).requires_grad_()
    y = tx @ wd.transpose(1, 2)
    if fuse is not None:
        y = torch.nn.functional.silu(y)
    y.backward(torch.tensor(gy))
    assert_close(got[1], tx.grad.numpy(), RTOL_PRODUCT, "dx")
    assert_close(got[2], pack_compact(tl, wd.grad).numpy(), RTOL_PRODUCT,
                 "dw")


def test_stacked_transposed_values_are_each_experts_transpose():
    _, tl = layouts(*SWEEP[1][:2], *SWEEP[1][3:])
    tt = TransposeTables.build(tl, "cpu")
    w = torch.tensor(randn(np.random.default_rng(1), E, *tl.data_shape))
    want = pack_compact(tl.transpose_layout(),
                        unpack_dense(tl, w).transpose(1, 2).contiguous())
    assert torch.equal(tt.values(w), want)
    for e in range(E):
        assert torch.equal(tt.values(w)[e], tt.values(w[e]))


def test_stacked_plain_versions_launch_nothing_on_the_cpu():
    _, tl = layouts(*SWEEP[0][:2], *SWEEP[0][3:])
    tables = KernelTables.build(tl, "cpu")
    counters = lambda: (rbgp4mm_rhs_stacked.launches,
                        rbgp4mm_rhs_stacked.launches_dx,
                        rbgp4_sddmm_rhs_stacked.launches)
    before = counters()
    x = torch.randn(E, 5, tl.k)
    rbgp4mm_rhs_stacked(tables, x, torch.randn(E, *tl.data_shape))
    rbgp4_sddmm_rhs_stacked(tables, torch.randn(E, 5, tl.m), x)
    assert counters() == before
    with pytest.raises(ValueError):
        rbgp4mm_rhs_stacked(tables, x, torch.randn(E + 1, *tl.data_shape))


# -- StackedExperts and MoELayer ------------------------------------------------

def j_sparsity(**kw):
    return JSparsityConfig(**{**SP, "backend": "pallas", **kw})


def moe_pair(seed=0):
    """JAX and port MoELayer on the same weights: d_model 64, 4 experts of
    width 128, top-2, one shared expert of width 128, capacity factor 1."""
    kw = dict(n_experts=E, top_k=2, n_shared=1, d_expert=128,
              capacity_factor=1.0)
    jl = JMoELayer(64, JMoEConfig(**kw), j_sparsity(), "silu")
    jp = jl.init(jax.random.PRNGKey(seed))
    tl = MoELayer(64, MoEConfig(**kw), SparsityConfig(**SP), "silu",
                  device="cpu")
    load_module(tl, jax_tree_to_numpy(jp))
    return jl, jp, tl


def test_stacked_experts_match_reference():
    jse = JStackedExperts(E, 64, 128, j_sparsity(), "silu")
    jp = jse.init(jax.random.PRNGKey(1))
    se = StackedExperts(E, 64, 128, SparsityConfig(**SP), "silu",
                        device="cpu")
    assert se.compact and jse.compact
    load_module(se, jax_tree_to_numpy(jp))
    xe = randn(np.random.default_rng(2), 1, E, 9, 64)
    want = jax.jit(jse.apply)(jp, jnp.asarray(xe))[0]
    got = se(torch.tensor(xe[0]))
    assert_close(got.detach().numpy(), want)


def test_dense_stacked_experts_match_reference():
    """Below ``min_dim`` the experts are dense (E, M, K) values."""
    jse = JStackedExperts(E, 64, 128, j_sparsity(min_dim=512), "silu")
    jp = jse.init(jax.random.PRNGKey(3))
    se = StackedExperts(E, 64, 128, SparsityConfig(**{**SP, "min_dim": 512}),
                        "silu", device="cpu")
    assert not se.compact and jse.storage == "dense"
    load_module(se, jax_tree_to_numpy(jp))
    xe = randn(np.random.default_rng(4), 1, E, 7, 64)
    want = jse.apply(jp, jnp.asarray(xe))[0]
    assert_close(se(torch.tensor(xe[0])).detach().numpy(), want)


@pytest.mark.parametrize("full_capacity", [True, False])
def test_moe_layer_output_aux_and_grads_match_reference(full_capacity):
    jl, jp, tl = moe_pair()
    rng = np.random.default_rng(6)
    x, gy = randn(rng, 2, 12, 64), randn(rng, 2, 12, 64)

    def jloss(p, x):
        y, aux = jl.apply(p, x, full_capacity=full_capacity)
        return jnp.sum(y * jnp.asarray(gy)) + aux, (y, aux)

    (_, (jy, jaux)), (jg_p, jg_x) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(jp, jnp.asarray(x))
    for p in tl.parameters():
        p.requires_grad_(True)
    tx = torch.tensor(x).requires_grad_()
    with topk_margins(tl):
        y, aux = tl(tx, full_capacity=full_capacity)
    (torch.sum(y * torch.tensor(gy)) + aux).backward()
    assert_close(y.detach().numpy(), jy, what="y")
    assert abs(aux.item() - float(jaux)) <= RTOL * abs(float(jaux))
    assert_close(tx.grad.numpy(), jg_x, what="dx")
    want = flatten(jax_tree_to_numpy(jg_p))
    got = {n: p.grad for n, p in tl.named_parameters()}
    assert set(got) == set(want)
    for name, g in got.items():
        assert_close(g.numpy(), want[name], what=name)
    if not full_capacity:
        # some expert is over its capacity here, so (token, k) pairs are
        # dropped and the cumsum order decides which
        _, _, idx = tl.route(tx.detach().reshape(-1, 64))
        load = torch.bincount(idx.reshape(-1), minlength=E)
        assert bool((load > tl.capacity(24, False)).any()), load


def test_moe_layer_dense_shared_and_experts_match_reference():
    """Without the sparsity pattern (dense experts and shared expert)."""
    jmoe = JMoEConfig(n_experts=E, top_k=2, n_shared=1, d_expert=32)
    jl = JMoELayer(64, jmoe, JSparsityConfig(), "gelu")
    jp = jl.init(jax.random.PRNGKey(7))
    tl = MoELayer(64, MoEConfig(n_experts=E, top_k=2, n_shared=1,
                                d_expert=32), None, "gelu", device="cpu")
    load_module(tl, jax_tree_to_numpy(jp))
    x = randn(np.random.default_rng(8), 2, 10, 64)
    jy, jaux = jax.jit(jl.apply)(jp, jnp.asarray(x))
    with topk_margins(tl):
        y, aux = tl(torch.tensor(x))
    assert_close(y.numpy(), jy)
    assert abs(aux.item() - float(jaux)) <= RTOL * abs(float(jaux))


def test_moe_layer_refuses_a_router_dtype_other_than_float32():
    """The router runs in float32 (routing is discrete); a config that
    asks for another router dtype is refused, not silently overridden."""
    moe = MoEConfig(n_experts=E, top_k=2, d_expert=32,
                    router_dtype="bfloat16")
    with pytest.raises(ValueError, match="router_dtype"):
        MoELayer(64, moe, None, "silu", device="cpu")
