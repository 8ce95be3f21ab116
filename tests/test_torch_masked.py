"""The port's masked storage and the unstructured and block patterns against
the reference's, on the CPU.

  * ``make_pattern`` gives the reference's masks bit for bit (the same
    numpy RNG calls) for ``unstructured``, ``block``, ``rbgp4`` and
    ``rbgp``, at the conv shapes of the paper's models (64 x 144, 128 x
    576, ...) and others; ``expand_rbgp4_mask`` rebuilds an RBGP4 mask from
    its base-graph factors as the reference's does; ``memory_bytes`` and
    ``SparseLinear.n_params`` / ``n_effective_params`` equal the
    reference's;
  * ``MaskedWeight`` through ``sparse_linear`` (with bias, activation and
    residual), ``sparse_linear_batched`` and ``sparse_matmul``, and the
    gradient of ``w``, against the reference's ``xla_masked`` backend;
  * a masked ``SparseLinear`` keeps its mask in integer buffers that no
    optimizer takes; ``StackedExperts`` and the reduced tinyllama under
    ``xla_masked`` against the reference through the weight bridge, which
    holds the masks equal and loads only the values.

Tolerances: 1e-5 * max|ref| for one product, 1e-4 * max|ref| for a model
(float32 throughout, the gap being summation order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import apply_sparsity as j_apply_sparsity
from repro.configs import get_config as j_get_config
from repro.configs import reduce_config as j_reduce_config
from repro.kernels.ref import ref_masked_mm as j_ref_masked_mm
from repro.models import LMModel as JLMModel
from repro.models.moe import StackedExperts as JStackedExperts
from repro.sparsity import MaskedWeight as JMaskedWeight
from repro.sparsity import SparseLinear as JSparseLinear
from repro.sparsity import SparsityConfig as JSparsityConfig
from repro.sparsity import expand_rbgp4_mask as j_expand
from repro.sparsity import make_pattern as j_make_pattern
from repro.sparsity import sparse_linear as j_sparse_linear
from repro.sparsity import sparse_linear_batched as j_sparse_linear_batched
from repro.sparsity import sparse_matmul as j_sparse_matmul
from repro_torch.bridge import load_jax_params, load_jax_vision_params
from repro_torch.configs import apply_sparsity, get_config, reduce_config
from repro_torch.kernels.ref import ref_masked_mm
from repro_torch.models import LMModel
from repro_torch.models.moe import StackedExperts
from repro_torch.sparsity import (MaskedWeight, SparseLinear, SparsityConfig,
                                  dense_weight, expand_rbgp4_mask,
                                  make_pattern, sparse_linear,
                                  sparse_linear_batched, sparse_matmul)
from repro_torch.train import trainable

from test_torch_model import jax_tree_to_numpy

torch.set_num_threads(1)
RTOL = 1e-4
RTOL_PRODUCT = 1e-5

# (m, k): the narrowest WRN-40-4 conv, VGG19's first two sparse convs'
# shape, a square and a wide one, and shapes off the power-of-two grid
SHAPES = [(64, 144), (128, 576), (256, 256), (64, 1152), (96, 64),
          (48, 200)]


def assert_close(got, want, rtol=RTOL, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = float(np.abs(got - want).max())
    scale = float(np.abs(want).max())
    assert err <= rtol * scale, (what, err, scale)


def randn(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def configs(pattern, sparsity, **kw):
    kw = dict(pattern=pattern, sparsity=sparsity, backend="xla_masked",
              min_dim=16, **kw)
    return JSparsityConfig(**kw), SparsityConfig(**kw)


# -- masks --------------------------------------------------------------------

@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("sparsity", [0.5, 0.75])
@pytest.mark.parametrize("pattern", ["unstructured", "block"])
def test_masks_are_the_references_bit_for_bit(pattern, sparsity, shape):
    m, k = shape
    for seed in (0, 5):
        jcfg, cfg = configs(pattern, sparsity, seed=seed)
        want, got = j_make_pattern(jcfg, m, k), make_pattern(cfg, m, k)
        assert got.mask().dtype == np.uint8
        np.testing.assert_array_equal(got.mask(), want.mask())
        assert (got.sparsity, got.nnz) == (want.sparsity, want.nnz)
        assert int(got.mask().sum()) == got.nnz
        for vb, ib in ((4, 4), (2, 4), (2, 2)):
            assert got.memory_bytes(vb, ib) == want.memory_bytes(vb, ib)


@pytest.mark.parametrize("shape", [(64, 144), (128, 576), (256, 1152)])
@pytest.mark.parametrize("pattern", ["rbgp4", "rbgp", "dense"])
def test_layout_masks_and_memory_match_the_reference(pattern, shape):
    m, k = shape
    jcfg, cfg = configs(pattern, 0.75)
    want, got = j_make_pattern(jcfg, m, k), make_pattern(cfg, m, k)
    np.testing.assert_array_equal(got.mask(), want.mask())
    assert (got.index_bytes_succinct, got.index_bytes_full) == \
        (want.index_bytes_succinct, want.index_bytes_full)
    assert got.memory_bytes() == want.memory_bytes()
    assert got.memory_bytes(2, 2) == want.memory_bytes(2, 2)


def test_block_refuses_a_shape_its_blocks_do_not_tile():
    _, cfg = configs("block", 0.75, block=(4, 4))
    with pytest.raises(ValueError, match="does not tile"):
        make_pattern(cfg, 64, 146)


@pytest.mark.parametrize("shape", [(64, 144), (128, 576), (512, 4608)])
@pytest.mark.parametrize("sparsity", [0.5, 0.75])
def test_expand_rbgp4_mask_matches_the_reference(shape, sparsity):
    jcfg, cfg = configs("rbgp4", sparsity)
    lay = make_pattern(cfg, *shape).layout
    sp = lay.spec
    want = np.asarray(j_expand(jnp.asarray(lay.graph_o.biadjacency),
                               jnp.asarray(lay.graph_i.biadjacency),
                               sp.group_rows, sp.chunk_cols))
    got = expand_rbgp4_mask(torch.as_tensor(lay.graph_o.biadjacency),
                            torch.as_tensor(lay.graph_i.biadjacency),
                            sp.group_rows, sp.chunk_cols)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), lay.mask())


@pytest.mark.parametrize("pattern", ["unstructured", "block", "rbgp4"])
@pytest.mark.parametrize("backend", ["xla_masked", "auto"])
@pytest.mark.parametrize("bias", [False, True])
def test_layer_counts_match_the_reference(pattern, backend, bias):
    for (m, k) in [(64, 144), (128, 576), (8, 144)]:
        kw = dict(pattern=pattern, sparsity=0.75, backend=backend,
                  min_dim=64)
        jl = JSparseLinear(k, m, JSparsityConfig(**kw), use_bias=bias)
        tl = SparseLinear(k, m, SparsityConfig(**kw), use_bias=bias,
                          device="cpu")
        assert tl.mode == jl.mode
        assert tl.n_params() == jl.n_params()
        assert tl.n_effective_params() == jl.n_effective_params()


# -- the masked products ------------------------------------------------------

def masked_pair(pattern, m, k, rng, bias=False, lead=()):
    """The same MaskedWeight in both packages (RBGP4 as factors, the others
    as a full mask)."""
    jcfg, cfg = configs(pattern, 0.75)
    pat = make_pattern(cfg, m, k)
    w = randn(rng, *lead, m, k)
    b = randn(rng, *lead, m) if bias else None
    jb = jnp.asarray(b) if bias else None
    tb = torch.tensor(b) if bias else None
    if pat.layout is not None:
        sp, lay = pat.layout.spec, pat.layout
        fo, fi = lay.graph_o.biadjacency, lay.graph_i.biadjacency
        jw = JMaskedWeight(w=jnp.asarray(w), ba_o=jnp.asarray(fo),
                           ba_i=jnp.asarray(fi), b=jb,
                           group_rows=sp.group_rows,
                           chunk_cols=sp.chunk_cols)
        tw = MaskedWeight(w=torch.tensor(w), ba_o=torch.as_tensor(fo),
                          ba_i=torch.as_tensor(fi), b=tb,
                          group_rows=sp.group_rows, chunk_cols=sp.chunk_cols)
    else:
        mask = pat.mask()
        jw = JMaskedWeight(w=jnp.asarray(w), mask=jnp.asarray(mask), b=jb)
        tw = MaskedWeight(w=torch.tensor(w), mask=torch.as_tensor(mask),
                          b=tb)
    return jw, tw, pat


@pytest.mark.parametrize("pattern", ["unstructured", "block", "rbgp4"])
@pytest.mark.parametrize("fuse,bias,res", [(None, False, False),
                                           ("silu", True, False),
                                           ("gelu", True, True)])
def test_masked_linear_and_its_w_gradient_match_xla_masked(pattern, fuse,
                                                           bias, res):
    rng = np.random.default_rng(1)
    m, k, n = 64, 144, 11
    jw, tw, pat = masked_pair(pattern, m, k, rng, bias=bias)
    x, gy = randn(rng, 2, n, k), randn(rng, 2, n, m)
    r = randn(rng, 2, n, m) if res else None

    def jf(w, x):
        y = j_sparse_linear(w, x, backend="xla_masked", fuse=fuse,
                            residual=None if r is None else jnp.asarray(r))
        return jnp.sum(y * gy), y

    (_, want), (jgw, jgx) = jax.value_and_grad(
        jf, argnums=(0, 1), has_aux=True, allow_int=True)(jw, jnp.asarray(x))
    tw.w.requires_grad_(True)
    tx = torch.tensor(x, requires_grad=True)
    y = sparse_linear(tw, tx, fuse=fuse,
                      residual=None if r is None else torch.tensor(r))
    (y * torch.tensor(gy)).sum().backward()
    assert_close(y.detach().numpy(), want, RTOL_PRODUCT, "y")
    assert_close(tw.w.grad.numpy(), jgw.w, RTOL_PRODUCT, "dw")
    assert_close(tx.grad.numpy(), jgx, RTOL_PRODUCT, "dx")
    # the gradient lies on the mask: off-mask values move by weight decay
    # alone
    assert not tw.w.grad.numpy()[pat.mask() == 0].any()


@pytest.mark.parametrize("pattern", ["unstructured", "rbgp4"])
def test_masked_matmul_batched_and_dense_weight_match_xla_masked(pattern):
    rng = np.random.default_rng(2)
    m, k = 128, 576
    jw, tw, pat = masked_pair(pattern, m, k, rng, bias=True)
    x = randn(rng, k, 7)
    assert_close(sparse_matmul(tw, torch.tensor(x)).numpy(),
                 j_sparse_matmul(jw, jnp.asarray(x), backend="xla_masked"),
                 RTOL_PRODUCT)
    np.testing.assert_array_equal(dense_weight(tw).numpy(),
                                  np.asarray(jw.materialize()))
    assert_close(ref_masked_mm(tw.w, torch.as_tensor(pat.mask()),
                               torch.tensor(x)).numpy(),
                 j_ref_masked_mm(jw.w, jnp.asarray(pat.mask()),
                                 jnp.asarray(x)), RTOL_PRODUCT)
    # stacked experts: w (E, M, K) under one broadcast mask
    jw3, tw3, _ = masked_pair(pattern, m, k, rng, lead=(3,))
    x3 = randn(rng, 3, 5, k)
    assert_close(
        sparse_linear_batched(tw3, torch.tensor(x3), fuse="silu").numpy(),
        j_sparse_linear_batched(jw3, jnp.asarray(x3), backend="xla_masked",
                                fuse="silu"), RTOL_PRODUCT)


# -- modules ------------------------------------------------------------------

@pytest.mark.parametrize("pattern", ["unstructured", "block", "rbgp4"])
def test_masked_layer_matches_the_reference_layer(pattern):
    kw = dict(pattern=pattern, sparsity=0.75, backend="xla_masked",
              min_dim=64)
    jl = JSparseLinear(576, 128, JSparsityConfig(**kw), use_bias=True)
    jp = jl.init(jax.random.PRNGKey(3))
    tl = SparseLinear(576, 128, SparsityConfig(**kw), use_bias=True,
                      device="cpu")
    load_jax_vision_params(tl, jax_tree_to_numpy(jp))
    buffers = dict(tl.named_buffers())
    assert set(buffers) == ({"ba_o", "ba_i"} if pattern == "rbgp4"
                            else {"mask"})
    assert not any(b.is_floating_point() for b in buffers.values())
    assert set(trainable(tl)) == {"w", "b"}
    x = randn(np.random.default_rng(4), 9, 576)
    assert_close(tl(torch.tensor(x)).numpy(),
                 jl.apply(jp, jnp.asarray(x)), RTOL_PRODUCT)
    # a mask that is not the port's own is refused, not loaded
    tree = jax_tree_to_numpy(jp)
    key = "ba_o" if pattern == "rbgp4" else "mask"
    tree[key] = 1 - tree[key]
    with pytest.raises(ValueError, match="mask differs"):
        load_jax_vision_params(tl, tree)


def test_masked_stacked_experts_match_the_reference():
    kw = dict(pattern="rbgp4", sparsity=0.5, backend="xla_masked",
              min_dim=64)
    jse = JStackedExperts(4, 64, 128, JSparsityConfig(**kw), "silu")
    jp = jse.init(jax.random.PRNGKey(1))
    se = StackedExperts(4, 64, 128, SparsityConfig(**kw), "silu",
                        device="cpu")
    assert se.masked and jse.masked and not se.compact
    load_jax_vision_params(se, jax_tree_to_numpy(jp))
    assert se.gate.w.shape == (4, 128, 64)
    assert not se.gate.ba_o.is_floating_point()
    xe = randn(np.random.default_rng(2), 1, 4, 9, 64)
    want = jax.jit(jse.apply)(jp, jnp.asarray(xe))[0]
    assert_close(se(torch.tensor(xe[0])).detach().numpy(), want)


@pytest.mark.parametrize("pattern", ["rbgp4", "block"])
def test_masked_tinyllama_matches_the_reference(pattern):
    """The reduced tinyllama with every projection of at least 64 a side in
    masked storage (the reference's default backend), through
    ``load_jax_params``: the training forward's logits and their loss."""
    kw = dict(pattern=pattern, sparsity=0.75, backend="xla_masked",
              min_dim=64)
    jcfg = j_apply_sparsity(j_reduce_config(j_get_config("tinyllama-1.1b")),
                            **kw)
    jm = JLMModel(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    cfg = apply_sparsity(reduce_config(get_config("tinyllama-1.1b")), **kw)
    tm = LMModel(cfg, device="cpu")
    load_jax_params(tm, jax_tree_to_numpy(jp))
    modes = {m.mode for m in tm.modules() if isinstance(m, SparseLinear)}
    assert modes == {"masked", "dense"}
    tokens = np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 12))
    want, _ = jm.forward(jp, {"tokens": jnp.asarray(tokens)})
    got, _ = tm(torch.tensor(tokens))
    assert_close(got.detach().numpy(), want)
