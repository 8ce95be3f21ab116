"""The port's weight-only int8 storage against the reference's.

``repro/sparsity/quant.py`` and the int8 Q/DQ of ``repro/train/compress.py``
against their ports, on the same numpy-seeded values:

  * ``quantize_int8`` / ``dequantize_int8`` and ``quantize_block_values``
    give ``q_data`` and ``scales`` bit-equal to the reference's, on 2-D
    RBGP4 values, stacked (E, M, nnz_row) values, the two small chains of
    ``tests/test_torch_chain.py`` and an all-zero leaf block;
  * ``leaf_block_dims`` and ``quant_storage_bytes`` equal the reference's;
  * the plain ``rbgp4mm_rhs``, ``rbgp4mm_rhs_stacked`` and ``chainmm_rhs``
    with ``scales`` stay within 1e-5 * max|ref| (float32, summation order)
    of the reference's Pallas kernels with ``scales`` in interpret mode;
  * ``sparse_linear`` and ``sparse_linear_batched`` on a
    ``QuantizedWeight`` (on the CPU: dequantize and delegate) are bit-equal
    to the same call on the dequantized container; chain storage has no
    stacked call; a gradient through PTQ storage is refused;
  * ``SparsityPlan.with_quant`` gives the reference's JSON and
    fingerprints; a checkpoint keeps int8, and int8 and full-precision
    snapshots refuse each other.
"""
import dataclasses
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ChainLayout as JChainLayout
from repro.core import RBGP4Layout as JLayout
from repro.core import RBGP4Spec as JSpec
from repro.core import design_rbgp as j_design_rbgp
from repro.kernels import KernelDims as JDims
from repro.sparsity import PatternSpec as JPatternSpec
from repro.sparsity import PlanRule as JPlanRule
from repro.sparsity import SparsityPlan as JSparsityPlan
from repro.sparsity.quant import leaf_block_dims as j_leaf_block_dims
from repro.sparsity.quant import quant_storage_bytes as j_quant_storage_bytes
from repro.sparsity.quant import \
    quantize_block_values as j_quantize_block_values
from repro.train.compress import dequantize_int8 as j_dequantize_int8
from repro.train.compress import quantize_int8 as j_quantize_int8
from repro_torch.core import ChainLayout, RBGP4Layout, RBGP4Spec, design_rbgp
from repro_torch.kernels import (KernelTables, chain_tables, chainmm_rhs,
                                 rbgp4mm_rhs, rbgp4mm_rhs_stacked)
from repro_torch.sparsity import (ChainWeight, CompactWeight, DenseWeight,
                                  PatternSpec, PlanRule, QuantizedWeight,
                                  SparseLinear, SparsityConfig, SparsityPlan,
                                  dense_weight, dequantize_weights,
                                  leaf_block_dims, quant_storage_bytes,
                                  quantize_weight, quantize_weights,
                                  sparse_linear, sparse_linear_batched,
                                  sparse_matmul)
from repro_torch.sparsity.quant import (dequantize_block_values,
                                        quantize_block_values)
from repro_torch.train import CheckpointManager
from repro_torch.train.compress import dequantize_int8, quantize_int8

torch.set_num_threads(1)
RTOL = 1e-5
JR = importlib.import_module("repro.kernels.rbgp4mm")
JC = importlib.import_module("repro.kernels.chainmm")

# the RBGP4 layout of tests/test_quant.py (G = 4, C = 8) and the two small
# chains of tests/test_torch_chain.py: three Ramanujan factors (G = C = 1)
# and the hierarchical chain with a 2 x 2 leaf
RBGP4_KW = dict(g_o=(4, 4), g_r=(4, 8), g_i=(4, 2), g_b=(1, 1), sp_o=0.5,
                sp_i=0.5, seed=3)
T3 = (("ramanujan", 0, 0, 0.5),) * 3
HIER_SMALL = (("complete", 4, 4, 0.0), ("ramanujan", 0, 0, 0.5),
              ("ramanujan", 0, 0, 0.5), ("ramanujan", 0, 0, 0.5),
              ("complete", 2, 2, 0.0))
CHAINS = {"3ram": (128, 128, 0.875, T3), "hier": (128, 256, 0.875,
                                                  HIER_SMALL)}


def rbgp4_pair(seed=3):
    kw = dict(RBGP4_KW, seed=seed)
    return JLayout(JSpec(**kw)), RBGP4Layout(RBGP4Spec(**kw))


def chain_pair(key):
    m, k, sp, factors = CHAINS[key]
    return (JChainLayout(j_design_rbgp(m, k, sp, factors=factors, seed=1)),
            ChainLayout(design_rbgp(m, k, sp, factors=factors, seed=1)))


def randn(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def assert_close(got, want, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want).max()
    assert err <= RTOL * np.abs(want).max(), (what, err,
                                              np.abs(want).max())


# -- Q/DQ: bit-equal to the reference ----------------------------------------

@pytest.mark.parametrize("axis,keepdims", [(None, False), (0, False),
                                           ((0, 2), False), ((-1,), True)])
def test_quantize_int8_bit_equal(axis, keepdims):
    x = randn(np.random.default_rng(0), 6, 5, 7) * 3.0
    x[1] = 0.0                      # an all-zero slice
    jq, js = j_quantize_int8(jnp.asarray(x), axis=axis, keepdims=keepdims)
    q, s = quantize_int8(torch.tensor(x), axis=axis, keepdims=keepdims)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    deq = dequantize_int8(q, s, axis=None if keepdims else axis)
    np.testing.assert_array_equal(
        deq.numpy(), np.asarray(j_dequantize_int8(
            jq, js, axis=None if keepdims else axis)))


def _block_cases():
    """(name, values, G, C) for every layout kind the storage covers."""
    rng = np.random.default_rng(1)
    _, lay = rbgp4_pair()
    G, C = leaf_block_dims(lay)
    w2 = randn(rng, *lay.data_shape)
    w2[:G, :C] = 0.0                # an all-zero leaf block
    out = [("rbgp4", w2, G, C),
           ("stacked", randn(rng, 3, *lay.data_shape), G, C)]
    for key in CHAINS:
        _, cl = chain_pair(key)
        out.append((key, randn(rng, *cl.data_shape), *leaf_block_dims(cl)))
    return out


@pytest.mark.parametrize("case", range(4))
def test_quantize_block_values_bit_equal(case):
    name, w, G, C = _block_cases()[case]
    jq, js = j_quantize_block_values(jnp.asarray(w), G, C)
    q, s = quantize_block_values(torch.tensor(w), G, C)
    assert q.dtype == torch.int8 and tuple(q.shape) == w.shape, name
    assert tuple(s.shape) == (*w.shape[:-2], w.shape[-2] // G,
                              w.shape[-1] // C), name
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq), err_msg=name)
    np.testing.assert_array_equal(s.numpy(), np.asarray(js), err_msg=name)
    if name == "rbgp4":             # the zero block: zeros, a tiny scale
        assert not q[:G, :C].any() and float(s[0, 0]) == np.float32(1e-12)
    back = dequantize_block_values(q, s, G, C)
    # per-leaf-block max-abs scale: every value within half a step
    err = (back - torch.tensor(w)).abs().reshape(
        *w.shape[:-2], w.shape[-2] // G, G, w.shape[-1] // C, C)
    assert bool((err.amax(dim=(-3, -1)) <= s / 2 + 1e-6).all()), name


def test_leaf_block_dims_and_storage_bytes_match_reference():
    pairs = [rbgp4_pair()] + [chain_pair(k) for k in CHAINS]
    for jl, tl in pairs:
        assert leaf_block_dims(tl) == j_leaf_block_dims(jl)
        assert quant_storage_bytes(tl) == j_quant_storage_bytes(jl)
    _, tl = rbgp4_pair()
    assert leaf_block_dims(KernelTables.build(tl, "cpu")) == \
        leaf_block_dims(tl)
    _, cl = chain_pair("hier")
    assert leaf_block_dims(chain_tables(cl, "cpu")) == (2, 2)


# -- the plain kernels with scales= against the reference's Pallas kernels ---

def _int8(rng, shape, G, C):
    """The reference's q/scales for numpy-seeded values, as numpy."""
    jq, js = j_quantize_block_values(jnp.asarray(randn(rng, *shape)), G, C)
    return np.asarray(jq), np.asarray(js)


@pytest.mark.parametrize("n", [1, 5, 16])
def test_rbgp4mm_rhs_int8_matches_reference_kernel(n):
    jl, tl = rbgp4_pair()
    rng = np.random.default_rng(10 + n)
    q, s = _int8(rng, tl.data_shape, *leaf_block_dims(tl))
    x = randn(rng, n, tl.k)
    want = JR.rbgp4mm_rhs(JDims.from_layout(jl), jnp.asarray(jl.adj_o),
                          jnp.asarray(x), jnp.asarray(q),
                          scales=jnp.asarray(s), interpret=True, block_n=8)
    got = rbgp4mm_rhs(KernelTables.build(tl, "cpu"), torch.tensor(x),
                      torch.tensor(q), scales=torch.tensor(s))
    assert got.dtype == torch.float32
    assert_close(got.numpy(), want, n)


@pytest.mark.parametrize("n", [1, 5, 16])
def test_rbgp4mm_rhs_stacked_int8_matches_reference_kernel(n):
    jl, tl = rbgp4_pair(seed=5)
    rng = np.random.default_rng(20 + n)
    e = 3
    q, s = _int8(rng, (e, *tl.data_shape), *leaf_block_dims(tl))
    x = randn(rng, e, n, tl.k)
    want = JR.rbgp4mm_rhs_stacked(
        JDims.from_layout(jl), jnp.asarray(jl.adj_o), jnp.asarray(x),
        jnp.asarray(q), scales=jnp.asarray(s), interpret=True, block_n=8)
    got = rbgp4mm_rhs_stacked(KernelTables.build(tl, "cpu"),
                              torch.tensor(x), torch.tensor(q),
                              scales=torch.tensor(s))
    assert_close(got.numpy(), want, n)


@pytest.mark.parametrize("key", list(CHAINS))
@pytest.mark.parametrize("n", [1, 5, 16])
def test_chainmm_rhs_int8_matches_reference_kernel(key, n):
    jl, tl = chain_pair(key)
    rng = np.random.default_rng(30 + n)
    q, s = _int8(rng, tl.data_shape, *leaf_block_dims(tl))
    x = randn(rng, n, tl.k)
    want = JC.chainmm_rhs(JC.chain_dims(jl), jnp.asarray(jl.adjs[0],
                                                         jnp.int32),
                          jnp.asarray(x), jnp.asarray(q),
                          scales=jnp.asarray(s), interpret=True, block_n=8)
    got = chainmm_rhs(chain_tables(tl, "cpu"), torch.tensor(x),
                      torch.tensor(q), scales=torch.tensor(s))
    assert_close(got.numpy(), want, (key, n))


def test_scales_path_checks_its_arguments():
    _, tl = rbgp4_pair()
    tables = KernelTables.build(tl, "cpu")
    q, s = quantize_block_values(torch.randn(tl.data_shape),
                                 *leaf_block_dims(tl))
    x = torch.randn(3, tl.k)
    with pytest.raises(ValueError, match="scales"):
        rbgp4mm_rhs(tables, x, q, scales=s[:, :-1])
    with pytest.raises(TypeError, match="int8"):
        rbgp4mm_rhs(tables, x, q.float(), scales=s)
    with pytest.raises(ValueError, match="epilogue"):
        rbgp4mm_rhs(tables, x, q, scales=s, bias=torch.zeros(tl.m))
    with pytest.raises(ValueError, match="scales"):
        rbgp4mm_rhs_stacked(tables, x[None], q[None], scales=s)
    _, cl = chain_pair("hier")
    ct = chain_tables(cl, "cpu")
    cq, cs = quantize_block_values(torch.randn(cl.data_shape), 2, 2)
    with pytest.raises(ValueError, match="scales"):
        chainmm_rhs(ct, torch.randn(2, cl.k), cq, scales=cs.T.contiguous())


# -- the dispatch: QuantizedWeight against its dequantized container --------

def _compact_weight(rng, bias=True, lead=()):
    _, tl = rbgp4_pair(seed=7)
    tables = KernelTables.build(tl, "cpu")
    w = torch.tensor(randn(rng, *lead, *tl.data_shape))
    b = torch.tensor(randn(rng, *lead, tl.m)) if bias else None
    return CompactWeight(w_data=w, tables=tables, b=b), tl


def _chain_weight(rng, bias=True):
    _, cl = chain_pair("hier")
    w = torch.tensor(randn(rng, *cl.data_shape))
    b = torch.tensor(randn(rng, cl.m)) if bias else None
    return ChainWeight(w_data=w, tables=chain_tables(cl, "cpu"), b=b), cl


@pytest.mark.parametrize("kind", ["compact", "chain"])
def test_sparse_linear_bit_equal_to_dequantized(kind):
    rng = np.random.default_rng(40)
    w, lay = (_compact_weight(rng) if kind == "compact"
              else _chain_weight(rng))
    qw = quantize_weight(w)
    assert isinstance(qw, QuantizedWeight) and qw.kind == kind
    assert quantize_weight(qw) is qw
    ref = qw.dequantize()
    assert type(ref) is type(w) and ref.w_data.dtype == torch.float32
    x = torch.tensor(randn(rng, 2, 5, lay.k))
    r = torch.tensor(randn(rng, 2, 5, lay.m))
    for kw in ({}, {"fuse": "silu", "residual": r}, {"fuse": "gelu"}):
        got = sparse_linear(qw, x, **kw)
        assert torch.equal(got, sparse_linear(ref, x, **kw)), kw
    assert torch.equal(dense_weight(qw), dense_weight(ref))
    xf = torch.tensor(randn(rng, lay.k, 6))
    assert torch.equal(sparse_matmul(qw, xf), sparse_matmul(ref, xf))


def test_sparse_linear_batched_bit_equal_and_chain_refused():
    rng = np.random.default_rng(41)
    w, lay = _compact_weight(rng, lead=(3,))
    qw = quantize_weight(w)
    assert tuple(qw.scales.shape) == (3, lay.m // 4, lay.data_shape[1] // 8)
    x = torch.tensor(randn(rng, 3, 6, lay.k))
    for fuse in (None, "silu"):
        assert torch.equal(sparse_linear_batched(qw, x, fuse=fuse),
                           sparse_linear_batched(qw.dequantize(), x,
                                                 fuse=fuse))
    qc = quantize_weight(_chain_weight(rng)[0])
    with pytest.raises(NotImplementedError, match="compact"):
        sparse_linear_batched(qc, torch.ones(2, 3, qc.tables.k))
    with pytest.raises(TypeError, match="compact/chain"):
        quantize_weight(DenseWeight(w=torch.ones(8, 8)))


def test_dequantize_keeps_orig_dtype():
    rng = np.random.default_rng(42)
    w, _ = _compact_weight(rng, bias=False)
    qw = quantize_weight(dataclasses.replace(
        w, w_data=w.w_data.to(torch.bfloat16)))
    assert qw.orig_dtype == torch.bfloat16
    assert qw.dequantize().w_data.dtype == torch.bfloat16
    assert qw.dequantize(torch.float32).w_data.dtype == torch.float32


def test_gradient_through_quantized_storage_raises():
    rbgp4 = SparsityConfig(pattern="rbgp4", sparsity=0.75, min_dim=1)
    lin = SparseLinear(256, 128, rbgp4, use_bias=True, device="cpu")
    lin.quantize_()
    assert lin.quantized and "w_data" not in dict(lin.named_parameters())
    assert not any(p.requires_grad for p in lin.parameters())
    x = torch.randn(4, 256, requires_grad=True)
    with pytest.raises(RuntimeError, match="inference-only"):
        lin(x)
    with torch.no_grad():
        assert lin(x).shape == (4, 128)
    xb = torch.randn(2, 4, 256, requires_grad=True)
    qw = lin.weight()
    stacked = QuantizedWeight(q_data=qw.q_data[None].expand(2, -1, -1),
                              scales=qw.scales[None].expand(2, -1, -1),
                              tables=qw.tables)
    with pytest.raises(RuntimeError, match="inference-only"):
        sparse_linear_batched(stacked, xb)
    with pytest.raises(RuntimeError, match="inference-only"):
        sparse_matmul(qw, torch.randn(256, 3, requires_grad=True))


# -- the module passes -------------------------------------------------------

def test_quantize_weights_plan_gating_and_inverse():
    rbgp4 = SparsityConfig(pattern="rbgp4", sparsity=0.75, min_dim=64)
    stack = torch.nn.ModuleDict({
        "wq": SparseLinear(256, 128, rbgp4, name="blk.wq", device="cpu"),
        "wo": SparseLinear(128, 256, rbgp4, name="blk.wo", device="cpu"),
        "dense": SparseLinear(32, 32, rbgp4, name="blk.dense",
                              device="cpu"),
    })
    before = {k: v.clone() for k, v in stack.state_dict().items()}
    spec = PatternSpec(pattern="rbgp4", sparsity=0.75, min_dim=64)
    plan = SparsityPlan(rules=(
        PlanRule(match=r".*wq", spec=dataclasses.replace(spec, quant="int8")),
        PlanRule(match=r".*", spec=spec)))
    quantize_weights(stack, plan=plan)
    assert stack["wq"].quantized and not stack["wo"].quantized
    assert stack["dense"].mode == "dense"
    quantize_weights(stack)
    assert stack["wo"].quantized
    names = set(stack.state_dict())
    assert {"wq.q_data", "wq.scales", "wo.q_data", "wo.scales",
            "dense.w"} == names
    assert stack.state_dict()["wq.q_data"].dtype == torch.int8
    dequantize_weights(stack)
    after = stack.state_dict()
    assert set(after) == set(before)
    for name in ("wq", "wo"):
        lin = stack[name]
        G, C = leaf_block_dims(lin.tables)
        q, s = quantize_block_values(before[f"{name}.w_data"], G, C)
        assert after[f"{name}.w_data"].dtype == torch.float32
        assert torch.equal(after[f"{name}.w_data"],
                           dequantize_block_values(q, s, G, C))
    assert torch.equal(after["dense.w"], before["dense.w"])


# -- plans and checkpoints ---------------------------------------------------

def _plan_pairs():
    """The same plans in both packages: a uniform RBGP4 plan, the chain
    plan of the CPU tests, and a mixed plan with a dense and a
    masked-storage rule (neither stamped)."""
    out = []
    for Spec, Rule, Plan in ((JPatternSpec, JPlanRule, JSparsityPlan),
                             (PatternSpec, PlanRule, SparsityPlan)):
        rbgp4 = Spec(pattern="rbgp4", sparsity=0.75, backend="auto",
                     min_dim=64)
        chain = Spec(pattern="rbgp", sparsity=0.875, backend="auto",
                     min_dim=64, factors=HIER_SMALL)
        masked = Spec(pattern="rbgp4", sparsity=0.5, backend="xla_masked")
        out.append([
            Plan.uniform(rbgp4),
            Plan.uniform(chain),
            # the backend named: the two packages' defaults differ, and
            # the JSON (not the fingerprint) carries it
            Plan(rules=(Rule(match=r".*wk", spec=Spec(pattern="dense",
                                                      backend="auto")),
                        Rule(match=r".*wv", spec=masked),
                        Rule(match=r".*mlp.*", spec=chain),
                        Rule(match=r".*", spec=rbgp4))),
        ])
    return list(zip(*out))


@pytest.mark.parametrize("i", range(3))
def test_with_quant_matches_reference(i):
    jplan, tplan = _plan_pairs()[i]
    assert tplan.fingerprint() == jplan.fingerprint()
    jq, tq = jplan.with_quant("int8"), tplan.with_quant("int8")
    assert tq.to_json() == jq.to_json()
    assert tq.fingerprint() == jq.fingerprint() != tplan.fingerprint()
    assert tq.with_quant(None).fingerprint() == tplan.fingerprint()
    for r in tq.rules:
        succinct = r.spec.is_sparse and r.spec.storage() in ("compact",
                                                             "chain")
        assert r.spec.quant == ("int8" if succinct else None)
    assert SparsityPlan.loads(tq.dumps()) == tq


def test_pattern_spec_quant_values():
    assert PatternSpec(pattern="rbgp4", sparsity=0.75,
                       quant="int8").quant == "int8"
    with pytest.raises(ValueError, match="quant"):
        PatternSpec(pattern="rbgp4", sparsity=0.75, quant="fp8")


def test_checkpoint_roundtrip_and_f32_int8_refusal(tmp_path):
    rbgp4 = SparsityConfig(pattern="rbgp4", sparsity=0.75, min_dim=1)
    lin = SparseLinear(256, 128, rbgp4, use_bias=True, device="cpu")
    plan = SparsityPlan.uniform(PatternSpec.from_config(rbgp4))
    qplan = plan.with_quant("int8")
    full = {k: v.clone() for k, v in lin.state_dict().items()}
    lin.quantize_()
    tree = dict(lin.state_dict())
    mgr = CheckpointManager(str(tmp_path / "q"),
                            plan_fingerprint=qplan.fingerprint())
    mgr.save(10, tree)
    flat, meta = mgr.restore(tree)
    assert meta["plan_fingerprint"] == qplan.fingerprint()
    assert flat["q_data"].dtype == np.int8
    np.testing.assert_array_equal(flat["q_data"], tree["q_data"].numpy())
    np.testing.assert_array_equal(flat["scales"], tree["scales"].numpy())
    # an int8 snapshot under the full-precision plan, and a full-precision
    # one under the int8 plan, are refused
    with pytest.raises(RuntimeError, match="plan"):
        CheckpointManager(str(tmp_path / "q"),
                          plan_fingerprint=plan.fingerprint()).restore(tree)
    CheckpointManager(str(tmp_path / "f"),
                      plan_fingerprint=plan.fingerprint()).save(3, full)
    with pytest.raises(RuntimeError, match="plan"):
        CheckpointManager(str(tmp_path / "f"),
                          plan_fingerprint=qplan.fingerprint()).restore(full)
