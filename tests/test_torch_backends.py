"""The port's sparse-backend registry against the reference's
(``repro/sparsity/api.py``, beside ``tests/test_sparse_api.py``).

  * every (backend, container) pair of the reference's parity matrix, on
    the same numpy weights: the port's forward and the gradient of its
    trainable values against the reference's ``sparse_linear`` and
    ``jax.grad``, within 1e-5 * max|ref| in float32 (summation order);
    ``sparse_matmul`` likewise for the compact backends;
  * ``available_backends`` under every filter but ``platform`` equals the
    reference's list (the port's platforms are torch device types);
    ``storage_kind`` equals the reference's for every name, layout and
    chain flag;
  * the ``auto`` table: the reference's, but compact storage resolves to
    ``pallas`` on every device (the reference picks ``xla_compact`` off the
    TPU: a deliberate difference); a named backend that does not accept
    int8 storage reroutes to ``quant``; chains have no stacked experts;
  * the refusals: unknown names (``get_backend`` and ``SparseLinear``),
    duplicates, ``'auto'``;
  * routing: a backend registered under a new name and named by one plan
    rule is called by exactly the layers that rule matches; a reduced
    tinyllama under attention -> ``xla_compact``, MLP -> ``pallas`` gives
    the reference model's logits under the same plan; the reduced
    qwen2-moe's experts under ``xla_compact`` and under ``pallas`` agree.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import apply_sparsity as j_apply_sparsity
from repro.configs import get_config as j_get_config
from repro.configs import reduce_config as j_reduce_config
from repro.models import LMModel as JLMModel
from repro.sparsity import PatternSpec as JPatternSpec
from repro.sparsity import PlanRule as JPlanRule
from repro.sparsity import SparseLinear as JSparseLinear
from repro.sparsity import SparsityConfig as JSparsityConfig
from repro.sparsity import SparsityPlan as JSparsityPlan
from repro.sparsity import api as japi
from repro.sparsity import quantize_weight as j_quantize_weight
from repro_torch.bridge import load_jax_params
from repro_torch.configs import apply_sparsity, get_config, reduce_config
from repro_torch.models import LMModel
from repro_torch.sparsity import (BackendCapabilities, ChainWeight,
                                  CompactWeight, DenseWeight, PatternSpec,
                                  PlanRule, SparseBackend, SparseLinear,
                                  SparsityConfig, SparsityPlan,
                                  available_backends, get_backend,
                                  quantize_weight, register_backend,
                                  resolve_backend, sparse_linear,
                                  sparse_linear_batched, sparse_matmul,
                                  storage_kind)
from repro_torch.sparsity import api as tapi
from repro_torch.sparsity.api import _REGISTRY

from test_torch_model import jax_tree_to_numpy

torch.set_num_threads(1)
RTOL = 1e-5
MODEL_RTOL = 1e-4
NAMES = ["chain", "pallas", "quant", "ref", "xla_compact", "xla_masked"]
CHAIN = dict(pattern="rbgp", sparsity=0.875, backend="auto",
             factors=(("complete", 2, 2, 0.0), ("ramanujan", 0, 0, -1.0),
                      ("ramanujan", 0, 0, -1.0), ("ramanujan", 0, 0, -1.0),
                      ("complete", 2, 2, 0.0)), min_dim=1)


def _cfg(cls, backend, sparsity):
    return cls(pattern="rbgp4", sparsity=sparsity, backend=backend,
               min_dim=1)


def weights(m, k, sp, seed=0):
    """The same effective dense matrix in every container, in both
    packages: {container: (port weight, reference weight)}."""
    lay = SparseLinear(k, m, _cfg(SparsityConfig, "auto", sp),
                       device="cpu").layout
    jlin_m = JSparseLinear(k, m, _cfg(JSparsityConfig, "xla_masked", sp))
    jlin_c = JSparseLinear(k, m, _cfg(JSparsityConfig, "xla_compact", sp))
    mask = lay.mask()
    assert (jlin_c.layout.mask() == mask).all()
    w0 = np.random.default_rng(seed).standard_normal((m, k)).astype(
        np.float32)
    dense = w0 * mask
    t_m = SparseLinear(k, m, _cfg(SparsityConfig, "xla_masked", sp),
                       device="cpu").weight()
    t_c = SparseLinear(k, m, _cfg(SparsityConfig, "auto", sp),
                       device="cpu").weight()
    j_m = jlin_m.init(jax.random.PRNGKey(0))
    j_c = jlin_c.init(jax.random.PRNGKey(0))
    packed = lay.pack(dense)
    return {
        "dense": (DenseWeight(w=torch.tensor(dense)),
                  japi.DenseWeight(w=jnp.asarray(dense))),
        "masked": (dataclasses.replace(t_m, w=torch.tensor(w0)),
                   dataclasses.replace(j_m, w=jnp.asarray(w0))),
        "compact": (dataclasses.replace(t_c, w_data=torch.tensor(packed)),
                    dataclasses.replace(j_c, w_data=jnp.asarray(packed))),
    }


def values_of(container: str) -> str:
    return "w_data" if container == "compact" else "w"


def assert_close(got, want, rtol=RTOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= rtol * np.abs(want).max(), (err, np.abs(want).max())


BACKENDS = [
    ("ref", "dense"), ("ref", "masked"), ("ref", "compact"),
    ("xla_masked", "masked"),
    ("xla_compact", "compact"),
    ("pallas", "compact"),
]


@pytest.mark.parametrize("m,k,sp", [(128, 256, 0.75), (128, 128, 0.5)])
@pytest.mark.parametrize("backend,container", BACKENDS)
def test_backend_parity_forward_and_grad(backend, container, m, k, sp):
    tw, jw = weights(m, k, sp)[container]
    x = np.random.default_rng(1).standard_normal((5, k)).astype(np.float32)
    key = values_of(container)
    want = japi.sparse_linear(jw, jnp.asarray(x), backend=backend)
    jgrad = jax.grad(lambda v: jnp.sum(japi.sparse_linear(
        dataclasses.replace(jw, **{key: v}), jnp.asarray(x),
        backend=backend) ** 2))(getattr(jw, key))
    v = getattr(tw, key).detach().clone().requires_grad_(True)
    y = sparse_linear(dataclasses.replace(tw, **{key: v}), torch.tensor(x),
                      backend=backend)
    assert_close(y.detach(), want)
    (g,) = torch.autograd.grad((y ** 2).sum(), v)
    assert_close(g, jgrad)


@pytest.mark.parametrize("backend", ["ref", "xla_compact", "pallas"])
def test_sparse_matmul_parity(backend):
    tw, jw = weights(128, 256, 0.75)["compact"]
    x = np.random.default_rng(2).standard_normal((256, 9)).astype(np.float32)
    want = japi.sparse_matmul(jw, jnp.asarray(x), backend=backend)
    assert_close(sparse_matmul(tw, torch.tensor(x), backend=backend), want)


def test_batched_backends_agree():
    """Stacked experts (E = 3): every batched backend that accepts compact
    storage gives the reference's ``sparse_linear_batched``."""
    tw, jw = weights(128, 256, 0.75)["compact"]
    rng = np.random.default_rng(3)
    wd = np.stack([rng.standard_normal(tw.w_data.shape).astype(np.float32)
                   for _ in range(3)])
    b = rng.standard_normal((3, 128)).astype(np.float32)
    x = rng.standard_normal((3, 2, 4, 256)).astype(np.float32)
    tw = dataclasses.replace(tw, w_data=torch.tensor(wd), b=torch.tensor(b))
    jw = dataclasses.replace(jw, w_data=jnp.asarray(wd), b=jnp.asarray(b))
    want = japi.sparse_linear_batched(jw, jnp.asarray(x),
                                      backend="xla_compact", fuse="silu")
    for name in available_backends(weight=CompactWeight, batched=True):
        got = sparse_linear_batched(tw, torch.tensor(x), backend=name,
                                    fuse="silu")
        assert_close(got, want)


# -- the registry ------------------------------------------------------------

WEIGHT_TYPES = ["DenseWeight", "MaskedWeight", "CompactWeight",
                "ChainWeight", "QuantizedWeight"]
FLAGS = ["needs_layout", "compact_storage", "chain_storage", "grad_support",
         "epilogue", "batched", "quant"]
FILTERS = ([{}] + [{"weight": t} for t in WEIGHT_TYPES]
           + [{f: v} for f in FLAGS for v in (True, False)])


@pytest.mark.parametrize("kw", FILTERS, ids=lambda kw: "-".join(
    f"{k}={v}" for k, v in kw.items()) or "all")
def test_available_backends_equal_the_reference(kw):
    tkw = {k: (getattr(tapi, v) if k == "weight" else v)
           for k, v in kw.items()}
    jkw = {k: (getattr(japi, v) if k == "weight" else v)
           for k, v in kw.items()}
    assert available_backends(**tkw) == japi.available_backends(**jkw)


def test_available_backends_and_platforms():
    assert available_backends() == NAMES
    for platform in ("cpu", "cuda"):
        assert available_backends(platform=platform) == NAMES
    assert available_backends(platform="tpu") == []
    assert get_backend("pallas").capabilities.platforms == ("cpu", "cuda")
    for name in NAMES:
        assert isinstance(get_backend(name), SparseBackend)
        assert get_backend(name).capabilities == dataclasses.replace(
            BackendCapabilities(**{
                f: getattr(japi.get_backend(name).capabilities, f)
                for f in FLAGS}), platforms=("cpu", "cuda"))


@pytest.mark.parametrize("name", ["auto"] + NAMES)
def test_storage_kind_equals_the_reference(name):
    for has_layout in (True, False):
        for chain in (True, False):
            try:
                want = japi.storage_kind(name, has_layout=has_layout,
                                         chain=chain)
            except ValueError:
                with pytest.raises(ValueError):
                    storage_kind(name, has_layout=has_layout, chain=chain)
                continue
            assert storage_kind(name, has_layout=has_layout,
                                chain=chain) == want


def containers():
    """One port container of each type, and the reference's."""
    w = weights(128, 128, 0.5)
    tc, jc = w["compact"]
    t_chain = SparseLinear(128, 128, SparsityConfig(**CHAIN),
                           device="cpu").weight()
    j_chain = JSparseLinear(128, 128, JSparsityConfig(**CHAIN)).init(
        jax.random.PRNGKey(0))
    assert isinstance(t_chain, ChainWeight)
    assert isinstance(j_chain, japi.ChainWeight)
    return {"dense": w["dense"], "masked": w["masked"], "compact": (tc, jc),
            "chain": (t_chain, j_chain),
            "quant": (quantize_weight(tc), j_quantize_weight(jc))}


def test_auto_table_and_the_pinned_compact_difference():
    got = {k: resolve_backend(t, "auto").name
           for k, (t, _) in containers().items()}
    want = {k: japi.resolve_backend(j, "auto").name
            for k, (_, j) in containers().items()}
    assert got == {"dense": "ref", "masked": "xla_masked",
                   "compact": "pallas", "chain": "chain", "quant": "quant"}
    # the deliberate difference: the reference picks xla_compact off the
    # TPU, the port its kernel wrapper on every device
    assert want == {**got, "compact": "xla_compact"}
    with pytest.raises(TypeError, match="accepts"):
        resolve_backend(containers()["dense"][0], "pallas")


def test_quant_reroute_and_chain_not_batched():
    c = containers()
    q = c["quant"][0]
    for name in ("pallas", "xla_compact", "ref", "chain"):
        assert resolve_backend(q, name).name == "quant"
        assert japi.resolve_backend(c["quant"][1], name).name == "quant"
    x = torch.tensor(np.random.default_rng(4).standard_normal(
        (3, 128)).astype(np.float32))
    assert torch.equal(sparse_linear(q, x, backend="xla_compact"),
                       sparse_linear(q, x))
    chain = c["chain"][0]
    with pytest.raises(NotImplementedError, match="batched"):
        sparse_linear_batched(dataclasses.replace(
            chain, w_data=chain.w_data[None]), torch.ones(1, 2, 128))
    with pytest.raises(NotImplementedError, match="batched"):
        japi.sparse_linear_batched(c["chain"][1], jnp.ones((1, 2, 128)))


def test_unknown_backend_errors():
    with pytest.raises(KeyError, match="unknown sparse backend"):
        get_backend("blocked_csr_not_yet")
    with pytest.raises(KeyError, match="unknown sparse backend"):
        SparseLinear(64, 64, SparsityConfig(pattern="rbgp4", sparsity=0.5,
                                            backend="nope", min_dim=1),
                     device="cpu")
    with pytest.raises(KeyError, match="unknown sparse backend"):
        sparse_linear(DenseWeight(w=torch.ones(2, 2)), torch.ones(1, 2),
                      backend="nope")


class Spy:
    """A compact-storage backend that records the values it runs (by
    storage pointer) and runs them on the plain-torch gather."""

    capabilities = BackendCapabilities(needs_layout=True,
                                       compact_storage=True, batched=True)
    accepts = (CompactWeight,)

    def __init__(self, name):
        self.name = name
        self.seen = []
        self._inner = get_backend("xla_compact")

    def linear(self, weight, x):
        self.seen.append(weight.w_data.untyped_storage().data_ptr())
        return self._inner.linear(weight, x)

    def matmul(self, weight, x):
        return self._inner.matmul(weight, x)

    def linear_batched(self, weight, x):
        return self._inner.linear_batched(weight, x)


def test_register_backend_duplicate_and_reserved():
    spy = Spy("ref")
    with pytest.raises(ValueError, match="already registered"):
        register_backend(spy)
    with pytest.raises(ValueError, match="reserved"):
        register_backend(spy, name="auto")
    spy.name = "test_dummy_backend"
    try:
        register_backend(spy)
        assert "test_dummy_backend" in available_backends(
            weight=CompactWeight, compact_storage=True)
        assert storage_kind("test_dummy_backend", has_layout=True) == \
            "compact"
        with pytest.raises(ValueError, match="rbgp4"):
            storage_kind("test_dummy_backend", has_layout=False)
        assert register_backend(spy, overwrite=True) is spy
    finally:
        _REGISTRY.pop("test_dummy_backend", None)
    assert available_backends() == NAMES


def test_spy_backend_is_called_by_exactly_the_layers_its_rule_matches():
    """A backend registered under a new name, named by the MLP rule of a
    plan: a forward of the reduced tinyllama calls it once for each MLP
    projection and for no other; the attention runs on ``auto``."""
    spy = register_backend(Spy("test_spy_backend"))
    try:
        spec = lambda b: PatternSpec(pattern="rbgp4", sparsity=0.5,  # noqa
                                     backend=b, min_dim=64)
        plan = SparsityPlan(rules=(
            PlanRule(r"l\d+\.mlp\..*", spec("test_spy_backend")),
            PlanRule(".*", spec("auto"))))
        cfg = apply_sparsity(reduce_config(get_config("tinyllama-1.1b")),
                             plan=plan)
        model = LMModel(cfg, device="cpu")
        layers = {m.name: m for m in model.modules()
                  if isinstance(m, SparseLinear)}
        routed = {n for n, m in layers.items()
                  if m.backend_name == "test_spy_backend"}
        assert routed == {f"l{i}.mlp.{p}" for i in range(cfg.n_layers)
                          for p in ("gate", "up", "down")}
        assert all(layers[n].mode == "compact" for n in routed)
        ptr = {layers[n].w_data.untyped_storage().data_ptr(): n
               for n in layers if layers[n].mode == "compact"}
        with torch.no_grad():
            model(np.zeros((2, 5), np.int32))
        assert sorted(ptr[p] for p in spy.seen) == sorted(routed)
    finally:
        _REGISTRY.pop("test_spy_backend", None)


# -- routing through the models ----------------------------------------------

ROUTES = {"attn": "xla_compact", "mlp": "pallas"}


def routed_plan(spec_cls, rule_cls, plan_cls, routes):
    return plan_cls(rules=tuple(
        rule_cls(rf"l\d+\.{part}\..*", spec_cls(
            pattern="rbgp4", sparsity=0.5, backend=b, min_dim=64))
        for part, b in routes.items()))


def test_routed_tinyllama_matches_the_reference():
    """attention -> xla_compact, MLP -> pallas: the reference's model under
    the same plan, its weights through the bridge; prefill logits within
    1e-4 * max|ref|, and the port model's layers name the plan's
    backends."""
    base = j_reduce_config(j_get_config("tinyllama-1.1b")).with_(n_layers=2)
    jcfg = j_apply_sparsity(base, plan=routed_plan(
        JPatternSpec, JPlanRule, JSparsityPlan, ROUTES))
    jm = JLMModel(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    cfg = apply_sparsity(
        reduce_config(get_config("tinyllama-1.1b")).with_(n_layers=2),
        plan=routed_plan(PatternSpec, PlanRule, SparsityPlan, ROUTES))
    tm = LMModel(cfg, device="cpu")
    load_jax_params(tm, jax_tree_to_numpy(jp))
    names = {m.name: m.backend_name for m in tm.modules()
             if isinstance(m, SparseLinear) and m.mode == "compact"}
    assert names == {f"l{i}.{n}": ("xla_compact" if n.startswith("attn")
                                   else "pallas")
                     for i in range(2) for n in ("attn.wq", "attn.wo",
                                                 "mlp.gate", "mlp.up",
                                                 "mlp.down")}
    tokens = np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 7))
    want, _ = jm.forward(jp, {"tokens": jnp.asarray(tokens, jnp.int32)})
    with torch.no_grad():
        got, _ = tm(tokens)
    assert_close(got, want, MODEL_RTOL)


def test_moe_experts_agree_under_xla_compact_and_pallas():
    """The reduced qwen2-moe with every projection (the stacked experts
    included) on ``xla_compact``, and again on ``pallas``, from the same
    weights: logits within 1e-5 * max|ref|."""
    out = {}
    for b in ("xla_compact", "pallas"):
        cfg = apply_sparsity(reduce_config(get_config("qwen2-moe-a2.7b")),
                             pattern="rbgp4", sparsity=0.5, backend=b,
                             min_dim=64)
        model = LMModel(cfg, device="cpu", seed=0)
        experts = [m for m in model.modules() if hasattr(m, "layouts")]
        assert experts and all(e.backend == b and e.compact
                               for e in experts)
        with torch.no_grad():
            out[b], _ = model(np.arange(12).reshape(2, 6) % cfg.vocab_size)
    assert_close(out["xla_compact"], out["pallas"])
