"""The port's deep-chain path computes the reference's function.

Layouts: the three chains of ``tests/test_chain_executor.py`` (three and
four Ramanujan factors with no complete leaf, and a hierarchical chain with
a 2x2 leaf) and tinyllama-1.1b's four full-width projection shapes under
the hierarchical-block plan of ``benchmarks/chain_executor.py`` (complete
4x4, three Ramanujan factors, complete 8x8, at 0.875).  Designs, sampled
adjacencies, compact slot orders and transpose permutations must be equal
to the reference's bit for bit; the products are held to 1e-5 * max|ref|
in float32 (summation order only).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ChainLayout as JChainLayout
from repro.core import design_rbgp as j_design_rbgp
from repro.kernels import chainmm as JC
from repro.sparsity import PatternSpec as JPatternSpec
from repro.sparsity import PlanRule as JPlanRule
from repro.sparsity import SparsityConfig as JSparsityConfig
from repro.sparsity import SparsityPlan as JSparsityPlan
from repro.sparsity import chain_storage_bytes as j_chain_storage_bytes
from repro.sparsity.plan import lower_config as j_lower_config
from repro_torch.core import ChainLayout, design_rbgp
from repro_torch.kernels import (ChainLinear, ChainTables, chain_sddmm_rhs,
                                 chain_sddmm_rhs_reference, chain_tables,
                                 chain_transpose_tables, chainmm_rhs,
                                 chainmm_rhs_reference)
from repro_torch.kernels.chainmm import (chain_gather_mm_rhs, chain_init,
                                         chain_pack_compact, chain_ref_linear,
                                         chain_unpack_dense)
from repro_torch.sparsity import (ChainWeight, PatternSpec, PlanRule,
                                  SparseLinear, SparsityConfig, SparsityPlan,
                                  chain_storage_bytes, dense_weight,
                                  lower_config, sparse_linear)

torch.set_num_threads(1)
RTOL = 1e-5

T3 = (("ramanujan", 0, 0, 0.5),) * 3
T4 = (("ramanujan", 0, 0, 0.5),) * 4
HIER_SMALL = (("complete", 4, 4, 0.0), ("ramanujan", 0, 0, 0.5),
              ("ramanujan", 0, 0, 0.5), ("ramanujan", 0, 0, 0.5),
              ("complete", 2, 2, 0.0))
# benchmarks/chain_executor.py: factor sparsities left to the designer
HIER = (("complete", 4, 4, 0.0), ("ramanujan", 0, 0, -1.0),
        ("ramanujan", 0, 0, -1.0), ("ramanujan", 0, 0, -1.0),
        ("complete", 8, 8, 0.0))

CHAINS = {
    "3ram": (128, 128, 0.875, T3),
    "4ram": (256, 256, 0.9375, T4),
    "hier": (128, 256, 0.875, HIER_SMALL),
}
FULL = {
    "wq/wo": (2048, 2048, 0.875, HIER),
    "wk/wv": (256, 2048, 0.875, HIER),
    "gate/up": (5632, 2048, 0.875, HIER),
    "down": (2048, 5632, 0.875, HIER),
}
ALL = {**CHAINS, **FULL}
# (G, C, chunks a row) forward and transposed, at full width
FULL_TABLES = {
    "wq/wo": ((8, 8, 32), (8, 8, 32)),
    "wk/wv": ((8, 8, 32), (8, 8, 4)),
    "gate/up": ((16, 32, 8), (32, 16, 44)),
    "down": ((32, 16, 44), (16, 32, 8)),
}


def pair_layouts(key, seed=1):
    m, k, sp, factors = ALL[key]
    return (JChainLayout(j_design_rbgp(m, k, sp, factors=factors, seed=seed)),
            ChainLayout(design_rbgp(m, k, sp, factors=factors, seed=seed)))


def randn(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def assert_close(got, want, rtol=RTOL, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = float(np.abs(got - want).max())
    scale = float(np.abs(want).max())
    assert err <= rtol * scale, (what, err, scale)


def factor_rows(spec):
    return [(f.kind, f.n_left, f.n_right, f.sparsity) for f in spec.factors]


@pytest.mark.parametrize("key", list(ALL))
def test_design_and_layout_match_reference(key):
    jl, tl = pair_layouts(key, seed=0)
    assert factor_rows(jl.spec) == factor_rows(tl.spec)
    assert jl.spec.seed == tl.spec.seed
    for lj, lt in ((jl, tl), (jl.transpose_layout(), tl.transpose_layout())):
        assert len(lj.adjs) == len(lt.adjs)
        for a, b in zip(lj.adjs, lt.adjs):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(lj._col_index(), lt._col_index())
    np.testing.assert_array_equal(jl.transpose_perm(), tl.transpose_perm())
    assert jl.memory_bytes() == tl.memory_bytes()
    assert j_chain_storage_bytes(jl) == chain_storage_bytes(tl)


@pytest.mark.parametrize("key", list(ALL))
def test_tables_hold_the_layout_and_its_transpose(key):
    """``col0`` rebuilds every compact slot's column (the contiguity the
    kernels rely on), and the transposed tables and permutation pack the
    dense transpose in ``transpose_layout()``, bit for bit."""
    _, lay = pair_layouts(key, seed=0)
    t = chain_tables(lay, "cpu")
    tt = chain_transpose_tables(lay, "cpu")
    lt = lay.transpose_layout()
    np.testing.assert_array_equal(t.col_index().numpy(), lay._col_index())
    np.testing.assert_array_equal(tt.tables.col_index().numpy(),
                                  lt._col_index())
    np.testing.assert_array_equal(tt.perm.numpy(), lay.transpose_perm())
    assert tt.tables.transposed and not t.transposed
    assert chain_tables(lay, "cpu") is t  # one table per layout content
    w = torch.tensor(randn(np.random.default_rng(1), *lay.data_shape))
    want = chain_pack_compact(lt, chain_unpack_dense(lay, w).T.contiguous())
    assert torch.equal(tt.values(w), want)
    if key in FULL_TABLES:
        fwd, bwd = FULL_TABLES[key]
        assert (t.group_rows, t.chunk_cols, t.n_chunks) == fwd
        t_ = tt.tables
        assert (t_.group_rows, t_.chunk_cols, t_.n_chunks) == bwd
    elif key in ("3ram", "4ram"):
        assert (t.group_rows, t.chunk_cols) == (1, 1)


def test_tables_refuse_a_layout_whose_chunks_are_not_contiguous():
    _, lay = pair_layouts("hier")
    G, C = ChainTables.build(lay, "cpu").group_rows, 2
    ci = lay._col_index().copy()
    bad = ChainLayout(lay.spec)
    ci_swap = ci.copy()
    ci_swap[0, [0, 1]] = ci_swap[0, [1, 0]]   # reversed inside a chunk
    bad._ci = ci_swap
    with pytest.raises(ValueError, match="not"):
        ChainTables.build(bad, "cpu")
    ci_row = ci.copy()
    ci_row[G - 1, :C] = ci[G, :C]             # a group's rows disagree
    bad._ci = ci_row
    with pytest.raises(ValueError, match="not"):
        ChainTables.build(bad, "cpu")


def plans(port: bool):
    """(name, plan) pairs built the same way in either package."""
    PS, PR, SP = ((PatternSpec, PlanRule, SparsityPlan) if port else
                  (JPatternSpec, JPlanRule, JSparsityPlan))
    lower = lower_config if port else j_lower_config
    cfg = (SparsityConfig if port else JSparsityConfig)(
        pattern="rbgp4", sparsity=0.75, backend="auto", min_dim=64)
    hier = PS(pattern="rbgp", sparsity=0.875, backend="auto", factors=HIER,
              min_dim=256)
    return {
        "uniform-rbgp4": lower(cfg),
        "hier": SP.uniform(hier, note="hierarchical-block chain"),
        "two-rule": SP(rules=(PR(r"l0\..*", PS(backend="auto"),
                                 note="keep dense"),
                              PR(".*", hier))),
    }


@pytest.mark.parametrize("name", ["uniform-rbgp4", "hier", "two-rule"])
def test_plan_json_and_fingerprint_match_reference(name):
    tp, jp = plans(True)[name], plans(False)[name]
    assert tp.fingerprint() == jp.fingerprint()
    assert tp.dumps() == jp.dumps()
    assert SparsityPlan.loads(jp.dumps()) == tp
    assert JSparsityPlan.loads(tp.dumps()) == jp
    for tr, jr in zip(tp.rules, jp.rules):
        assert tr.spec.storage() == jr.spec.storage()
        assert tr.spec.is_chain() == jr.spec.is_chain()


@pytest.mark.parametrize("backend", ["auto", "pallas", "xla_compact",
                                     "chain", "xla_masked", "ref"])
@pytest.mark.parametrize("factors", [None, HIER])
def test_storage_kind_and_fingerprint_follow_the_backend(backend, factors):
    """The fingerprint hashes the storage kind, not the backend name:
    both packages agree for every backend name of the reference."""
    kw = dict(pattern="rbgp", sparsity=0.875, backend=backend,
              factors=factors, min_dim=64)
    tp = SparsityPlan.uniform(PatternSpec(**kw))
    jp = JSparsityPlan.uniform(JPatternSpec(**kw))
    assert tp.rules[0].spec.storage() == jp.rules[0].spec.storage()
    assert tp.fingerprint() == jp.fingerprint()


def test_plan_resolves_like_the_reference():
    tp, jp = plans(True)["two-rule"], plans(False)["two-rule"]
    for path in ("l0.attn.wq", "l1.attn.wq", "l10.mlp.down",
                 "l0.moe.experts.in"):
        assert tp.resolve(path).to_json() == jp.resolve(path).to_json()
    # chain and compact rules keep their seed, the dense rule moves
    shifted = tp.offset_masked_seeds(1000)
    assert shifted.to_json() == jp.offset_masked_seeds(1000).to_json()
    assert shifted.rules[1] == tp.rules[1]
    assert shifted.rules[0].spec.seed == 1000
    shifted = plans(True)["uniform-rbgp4"].offset_masked_seeds(1000)
    assert shifted.rules[0].spec.seed == 0     # compact too
    paths = [("l0.attn.wq", 2048, 2048), ("l1.mlp.down", 2048, 5632)]
    assert tp.signature(paths)[0] != tp.signature(paths)[1]


def test_quantized_storage_is_not_yet_ported():
    # named for the slice that refused quant='int8'; the int8 storage is
    # ported now (tests/test_torch_quant.py): 'int8' is accepted and kept
    # in the spec, any other value is refused
    spec = PatternSpec(pattern="rbgp4", sparsity=0.75, quant="int8")
    assert spec.quant == "int8" and spec.to_config().quant == "int8"
    with pytest.raises(ValueError):
        SparsityConfig(quant="int4")


@pytest.mark.parametrize("key", list(CHAINS))
def test_plain_versions_match_reference_kernels(key):
    """``chainmm_rhs_reference`` and ``chain_sddmm_rhs_reference`` against
    the reference's Pallas kernels in interpret mode; on the transposed
    tables the forward gives g @ W."""
    jl, tl = pair_layouts(key)
    rng = np.random.default_rng(3)
    w = randn(rng, *tl.data_shape)
    x, g = randn(rng, 37, tl.k), randn(rng, 37, tl.m)
    dims = JC.chain_dims(jl)
    adj = jnp.asarray(jl.adjs[0])
    want_y = JC.chainmm_rhs(dims, adj, jnp.asarray(x), jnp.asarray(w),
                            block_n=8, interpret=True)
    want_dw = JC.chain_sddmm_rhs(dims, adj, jnp.asarray(g), jnp.asarray(x),
                                 block_n=8, interpret=True)
    t = chain_tables(tl, "cpu")
    assert_close(chainmm_rhs_reference(t, torch.tensor(x), torch.tensor(w)),
                 want_y, what="y")
    assert_close(chain_sddmm_rhs_reference(t, torch.tensor(g),
                                           torch.tensor(x)), want_dw,
                 what="dw")
    tt = chain_transpose_tables(tl, "cpu")
    dx = chainmm_rhs_reference(tt.tables, torch.tensor(g),
                               tt.values(torch.tensor(w)))
    assert_close(dx, g @ jl.unpack(w), what="dx")


@pytest.mark.parametrize("key", list(CHAINS))
def test_oracles_and_packing_match_reference(key):
    jl, tl = pair_layouts(key)
    rng = np.random.default_rng(4)
    w = randn(rng, *tl.data_shape)
    x = randn(rng, 2, 5, tl.k)
    wt, xt = torch.tensor(w), torch.tensor(x)
    np.testing.assert_array_equal(chain_unpack_dense(tl, wt).numpy(),
                                  jl.unpack(w))
    dense = randn(rng, tl.m, tl.k)
    np.testing.assert_array_equal(
        chain_pack_compact(tl, torch.tensor(dense)).numpy(), jl.pack(dense))
    jw, jx = jnp.asarray(w), jnp.asarray(x)
    assert_close(chain_gather_mm_rhs(tl, wt, xt),
                 JC.chain_gather_mm_rhs(jl, jw, jx), what="gather")
    assert_close(chain_ref_linear(tl, wt, xt),
                 JC.chain_ref_linear(jl, jw, jx), what="ref_linear")
    w0 = chain_init(tl, generator=torch.Generator().manual_seed(0))
    assert tuple(w0.shape) == tl.data_shape
    assert abs(float(w0.std()) - (2.0 / tl.nnz_per_row) ** 0.5) < 0.1 * (
        2.0 / tl.nnz_per_row) ** 0.5


@pytest.mark.parametrize("key", list(ALL))
def test_chain_linear_grads_match_dense_autograd(key):
    """dW through ``chain_sddmm_rhs`` and dX through ``chainmm_rhs`` on the
    transposed tables against autograd of x @ W^T with W scattered dense
    (a wrong ``col0`` row or a wrong permutation would still give
    plausible numbers, so every entry is held)."""
    _, lay = pair_layouts(key, seed=0)
    rng = np.random.default_rng(5)
    w = torch.tensor(randn(rng, *lay.data_shape))
    x = torch.tensor(randn(rng, 3, lay.k))
    g = torch.tensor(randn(rng, 3, lay.m))
    t, tt = chain_tables(lay, "cpu"), chain_transpose_tables(lay, "cpu")
    xa, wa = x.clone().requires_grad_(), w.clone().requires_grad_()
    y = ChainLinear.apply(xa, wa, t, tt)
    y.backward(g)
    xd, wd = x.clone().requires_grad_(), w.clone().requires_grad_()
    yd = xd @ chain_unpack_dense(lay, wd).T
    yd.backward(g)
    assert_close(y.detach(), yd.detach(), what="y")
    assert_close(xa.grad, xd.grad, what="dx")
    assert_close(wa.grad, wd.grad, what="dw")


def test_chain_linear_matches_chain_op_vjp():
    """``ChainLinear`` against the reference's ``ChainOp`` custom VJP (its
    Pallas kernels in interpret mode)."""
    jl, tl = pair_layouts("hier")
    rng = np.random.default_rng(6)
    w, x, g = (randn(rng, *tl.data_shape), randn(rng, 19, tl.k),
               randn(rng, 19, tl.m))
    op = JC.ChainOp(jl, block_n=8, interpret=True)
    jy, pull = jax.vjp(lambda w_, x_: op.linear(x_, w_), jnp.asarray(w),
                       jnp.asarray(x))
    jdw, jdx = pull(jnp.asarray(g))
    xa = torch.tensor(x).requires_grad_()
    wa = torch.tensor(w).requires_grad_()
    y = ChainLinear.apply(xa, wa, chain_tables(tl, "cpu"),
                          chain_transpose_tables(tl, "cpu"))
    y.backward(torch.tensor(g))
    assert_close(y.detach(), jy, what="y")
    assert_close(xa.grad, jdx, what="dx")
    assert_close(wa.grad, jdw, what="dw")


def test_plain_versions_are_what_cpu_tensors_run():
    _, lay = pair_layouts("hier")
    t, tt = chain_tables(lay, "cpu"), chain_transpose_tables(lay, "cpu")
    gen = torch.Generator().manual_seed(0)
    w = torch.randn(lay.data_shape, generator=gen)
    x = torch.randn(5, lay.k, generator=gen)
    g = torch.randn(5, lay.m, generator=gen)
    counters = lambda: (chainmm_rhs.launches, chainmm_rhs.launches_dx,
                        chain_sddmm_rhs.launches)
    before = counters()
    assert torch.equal(chainmm_rhs(t, x, w), chainmm_rhs_reference(t, x, w))
    assert torch.equal(chain_sddmm_rhs(t, g, x),
                       chain_sddmm_rhs_reference(t, g, x))
    chainmm_rhs(tt.tables, g, tt.values(w))
    assert counters() == before
    empty = chain_sddmm_rhs(t, g[:0], x[:0])
    assert tuple(empty.shape) == lay.data_shape and not empty.any()
    with pytest.raises(ValueError):
        chainmm_rhs(t, x[:, :-1], w)


@pytest.mark.parametrize("fuse,bias,residual", [(None, False, False),
                                                ("silu", True, True)])
def test_sparse_linear_runs_chain_storage(fuse, bias, residual):
    """A ``SparseLinear`` under a chain plan: chain storage, and
    ``act(x W^T + b) + r`` equal to the dense formula on its dense weight,
    with gradients through ``ChainLinear``; the transposed tables are built
    at the first input gradient only."""
    plan = SparsityPlan.uniform(PatternSpec(
        pattern="rbgp", sparsity=0.875, backend="auto", factors=HIER_SMALL,
        min_dim=64))
    layer = SparseLinear(256, 128, plan, use_bias=bias, device="cpu",
                         generator=torch.Generator().manual_seed(0),
                         name="l0.attn.wq")
    assert layer.mode == "chain" and layer.layout is None
    assert layer.chain_layout.m == 128
    if bias:
        layer.b.data.normal_(generator=torch.Generator().manual_seed(1))
    gen = torch.Generator().manual_seed(2)
    x = torch.randn(2, 3, 256, generator=gen)
    r = torch.randn(2, 3, 128, generator=gen) if residual else None
    wt = layer.weight()
    assert isinstance(wt, ChainWeight)
    dense = dense_weight(wt)
    want = x @ dense.T + (layer.b if bias else 0)
    if fuse:
        want = torch.nn.functional.silu(want)
    if residual:
        want = want + r
    assert_close(layer(x, fuse=fuse, residual=r), want)
    layer.w_data.requires_grad_()
    layer(x, fuse=fuse, residual=r).sum().backward()
    assert layer._tables_t is None and layer.w_data.grad is not None
    xg = x.clone().requires_grad_()
    out = sparse_linear(layer.weight(), xg, fuse=fuse, residual=r)
    out.sum().backward()
    assert layer._tables_t is not None and xg.grad is not None
