"""The port's vision models (``repro_torch.models.vision``) against the
reference's, on the CPU.

  * building blocks: ``SparseConv2D.patches`` (``F.unfold``) gives
    ``jax.lax.conv_general_dilated_patches``' features in the same order,
    bit for bit, at k 3 and 1, stride 1 and 2; the max pool sends a tied
    window's gradient to the one element the reference's ``reduce_window``
    max sends it to (``Tensor.amax`` would split it); ``BatchNorm`` in
    training, in eval without state (batch statistics still) and in eval
    with state, and its state update;
  * the reference's ``tests/test_models.py:146`` case, VGG19 and WRN-10-1
    with RBGP4 at 0.5 and ``min_dim=64`` under ``xla_masked``, then again
    with compact storage (``auto``) and with the unstructured and block
    patterns, the weights loaded through ``load_jax_vision_params``: the
    logits of 4 images within 1e-4 * max|ref| in float32, then the logits
    and the gradient of every parameter and of the input within 1e-4 *
    max|ref| with both models in float64, on one image (the reference's
    float64 gradient takes seconds an image on the CPU).  The gradients
    are held in float64 because in float32 the two packages' summation
    orders put VGG19's pre-ReLU values up to 1e-4 apart at its last convs
    (their batch norms renormalize the drift), so a value that close to 0
    passes the ReLU in one package and not in the other, and that one kink
    moves a 2 x 2 layer's batch-norm bias gradient by percents;
  * full-width VGG19-CIFAR and WRN-40-4 (``get_config``) at 0.75 build the
    reference's storage kind and layout at every module path, with the
    paper's keep-dense rule (build only, no forward).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.vision import BatchNorm as JBatchNorm
from repro.models.vision import VGG19 as JVGG19
from repro.models.vision import VisionConfig as JVisionConfig
from repro.models.vision import WideResNet as JWideResNet
from repro.sparsity import SparseLinear as JSparseLinear
from repro.sparsity import SparsityConfig as JSparsityConfig
from repro.utils import merge_trees, split_trainable
from repro_torch.bridge import load_jax_vision_params
from repro_torch.configs import get_config
from repro_torch.models.vision import (VGG19, BatchNorm, SparseConv2D,
                                       VisionConfig, WideResNet,
                                       max_pool_2x2, vision_plan)
from repro_torch.sparsity import SparseLinear, SparsityConfig

from test_torch_model import jax_tree_to_numpy

torch.set_num_threads(2)
RTOL = 1e-4


def assert_close(got, want, rtol=RTOL, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = float(np.abs(got - want).max())
    scale = float(np.abs(want).max())
    assert err <= rtol * scale, (what, err, scale)


def randn(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def flatten(tree, prefix=""):
    out = {}
    items = (tree.items() if isinstance(tree, dict) else enumerate(tree))
    for k, v in items:
        name = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, (dict, list, tuple)):
            out.update(flatten(v, name))
        elif v is not None:
            out[name] = np.asarray(v)
    return out


# -- building blocks ----------------------------------------------------------

@pytest.mark.parametrize("k,stride", [(3, 1), (3, 2), (1, 1), (1, 2)])
def test_unfold_feature_order_is_conv_general_dilated_patches(k, stride):
    x = randn(np.random.default_rng(0), 2, 7, 8, 5)
    pad = (k - 1) // 2
    want = jax.lax.conv_general_dilated_patches(
        jnp.asarray(x), (k, k), (stride, stride),
        padding=((pad, pad), (pad, pad)),
        dimension_numbers=("NHWC", "HWIO", "NHWC"))
    conv = SparseConv2D(5, 4, k, stride, device="cpu")
    before = SparseConv2D.layout_copies
    got = conv.patches(torch.tensor(x))
    assert SparseConv2D.layout_copies == before + 2
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_max_pool_sends_a_tied_gradient_where_the_reference_does():
    x = np.zeros((1, 4, 4, 2), np.float32)
    x[0, 0, 0, 0] = x[0, 0, 1, 0] = x[0, 1, 0, 0] = 1.0   # a 3-way tie
    x[0, 2:, 2:, 1] = 3.0                                   # a 4-way tie
    x[0, 0, 2:, 1] = randn(np.random.default_rng(1), 2)
    pool = lambda v: jax.lax.reduce_window(v, -jnp.inf, jax.lax.max,
                                           (1, 2, 2, 1), (1, 2, 2, 1),
                                           "VALID")
    want_y = pool(jnp.asarray(x))
    want_g = jax.grad(lambda v: jnp.sum(pool(v) * jnp.arange(8.0).reshape(
        1, 2, 2, 2)))(jnp.asarray(x))
    tx = torch.tensor(x, requires_grad=True)
    y = max_pool_2x2(tx)
    (y * torch.arange(8.0).reshape(1, 2, 2, 2)).sum().backward()
    np.testing.assert_array_equal(y.detach().numpy(), np.asarray(want_y))
    np.testing.assert_array_equal(tx.grad.numpy(), np.asarray(want_g))
    # each window's gradient lands on one element, never split
    assert set(np.unique(tx.grad.numpy())) <= set(range(8))


@pytest.mark.parametrize("train,with_state", [(True, False), (False, False),
                                              (False, True), (True, True)])
def test_batch_norm_matches_the_reference(train, with_state):
    rng = np.random.default_rng(2)
    x, gy = 3.0 * randn(rng, 4, 5, 5, 6) + 1.0, randn(rng, 4, 5, 5, 6)
    p = {"scale": randn(rng, 6), "bias": randn(rng, 6)}
    state = ({"mean": randn(rng, 6), "var": np.abs(randn(rng, 6)) + 0.5}
             if with_state else None)
    jbn = JBatchNorm(6)

    def jf(p, x):
        jstate = None if state is None else jax.tree_util.tree_map(
            jnp.asarray, state)
        y, new = jbn.apply(p, x, jstate, train=train)
        return jnp.sum(y * gy), (y, new)

    (_, (want, want_state)), (jgp, jgx) = jax.value_and_grad(
        jf, argnums=(0, 1), has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(x))
    bn = BatchNorm(6, device="cpu")
    bn.load_state_dict({k: torch.tensor(v) for k, v in p.items()})
    for t in bn.parameters():
        t.requires_grad_(True)
    tx = torch.tensor(x, requires_grad=True)
    tstate = (None if state is None
              else {k: torch.tensor(v) for k, v in state.items()})
    y, new = bn(tx, tstate, train=train)
    (y * torch.tensor(gy)).sum().backward()
    assert_close(y.detach().numpy(), want, 1e-5)
    assert_close(tx.grad.numpy(), jgx, 1e-5)
    assert_close(bn.scale.grad.numpy(), jgp["scale"], 1e-5)
    assert_close(bn.bias.grad.numpy(), jgp["bias"], 1e-5)
    if want_state is None:
        assert new is None
    else:
        for k in ("mean", "var"):
            assert_close(new[k].detach().numpy(), want_state[k], 1e-5)
    assert bn.scale.dtype == torch.float32
    # bf16 activations normalize in float32 and come back in bf16
    assert bn(tx.detach().bfloat16(), train=True)[0].dtype == torch.bfloat16


# -- the reference's vision-model test, and its storage variants --------------

def model_pair(cls, tcls, pattern, backend, sparsity=0.5):
    sp = dict(pattern=pattern, sparsity=sparsity, backend=backend,
              min_dim=64)
    jm = cls(JVisionConfig(name="v", n_classes=10,
                           sparsity=JSparsityConfig(**sp), depth=10,
                           width=1))
    jp = jm.init(jax.random.PRNGKey(0))
    tm = tcls(VisionConfig(name="v", n_classes=10,
                           sparsity=SparsityConfig(**sp), depth=10, width=1),
              device="cpu")
    load_jax_vision_params(tm, jax_tree_to_numpy(jp))
    return jm, jp, tm


@pytest.mark.parametrize("pattern,backend", [
    ("rbgp4", "xla_masked"), ("rbgp4", "auto"), ("unstructured", "auto"),
    ("block", "xla_masked")])
@pytest.mark.parametrize("cls,tcls", [(JVGG19, VGG19),
                                      (JWideResNet, WideResNet)],
                         ids=["vgg19", "wrn10-1"])
def test_vision_model_logits_and_grads_match_the_reference(cls, tcls,
                                                           pattern, backend):
    jm, jp, tm = model_pair(cls, tcls, pattern, backend)
    modes = {m.mode for m in tm.modules() if isinstance(m, SparseLinear)}
    want_mode = "compact" if (pattern == "rbgp4"
                              and backend == "auto") else "masked"
    assert modes == {"dense", want_mode}
    rng = np.random.default_rng(1)
    x, gy = randn(rng, 4, 32, 32, 3), randn(rng, 4, 10)
    want32 = jax.jit(lambda p, x: jm.apply(p, x, train=True))(
        jp, jnp.asarray(x))
    with torch.no_grad():
        got32 = tm(torch.tensor(x), train=True)
    assert got32.shape == (4, 10) and got32.dtype == torch.float32
    assert_close(got32.numpy(), want32, what="float32 logits")

    train, static = split_trainable(jp)
    wide = lambda a: a.astype(jnp.float64) if jnp.issubdtype(
        a.dtype, jnp.floating) else a
    with jax.enable_x64(True):
        def jf(t, x):
            logits = jm.apply(merge_trees(t, static), x, train=True)
            return jnp.sum(logits * gy[:1]), logits

        (_, want), (jg, jgx) = jax.jit(jax.value_and_grad(
            jf, argnums=(0, 1), has_aux=True))(
            jax.tree_util.tree_map(wide, train),
            jnp.asarray(x[:1], jnp.float64))
        want, jgx = np.asarray(want), np.asarray(jgx)
        jg = jax.tree_util.tree_map(np.asarray, jg)
    tm.double()
    for p in tm.parameters():
        p.requires_grad_(True)
    tx = torch.tensor(x[:1], dtype=torch.float64, requires_grad=True)
    logits = tm(tx, train=True)
    (logits * torch.tensor(gy[:1])).sum().backward()
    assert logits.dtype == torch.float64
    assert_close(logits.detach().numpy(), want, what="logits")
    assert_close(tx.grad.numpy(), jgx, what="dx")
    want_g = flatten(jax_tree_to_numpy(jg))
    got_g = {n: p.grad for n, p in tm.named_parameters()}
    assert set(got_g) == set(want_g)
    for name, g in got_g.items():
        assert_close(g.numpy(), want_g[name], what=name)


# -- full-width construction --------------------------------------------------

def reference_layers(obj, out=None) -> dict:
    """{module path: (storage kind, layout spec)} of every ``SparseLinear``
    a reference model holds."""
    out = {} if out is None else out
    if isinstance(obj, JSparseLinear):
        out[obj.name] = (obj.mode, spec_fields(obj.layout))
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            reference_layers(v, out)
    elif hasattr(obj, "__dict__") and type(obj).__module__.startswith(
            "repro."):
        for v in vars(obj).values():
            reference_layers(v, out)
    return out


def spec_fields(layout):
    return dataclasses.asdict(layout.spec) if layout is not None else None


def port_layers(model) -> dict:
    return {m.name: (m.mode, spec_fields(m.layout))
            for m in model.modules() if isinstance(m, SparseLinear)}


@pytest.mark.parametrize("pattern,backend", [
    ("dense", "auto"), ("unstructured", "auto"), ("block", "auto"),
    ("rbgp4", "auto"), ("rbgp4", "xla_masked")])
@pytest.mark.parametrize("arch", ["vgg19-cifar", "wrn40-4-cifar"])
def test_full_width_models_build_the_references_storage(arch, pattern,
                                                        backend):
    from repro.configs import get_config as j_get_config

    sp = dict(pattern=pattern, sparsity=0.75, backend=backend, min_dim=64)
    jcfg = dataclasses.replace(j_get_config(arch),
                               sparsity=JSparsityConfig(**sp))
    cfg = dataclasses.replace(get_config(arch),
                              sparsity=SparsityConfig(**sp))
    assert isinstance(cfg, VisionConfig) and cfg.name == jcfg.name
    assert (cfg.depth, cfg.width, cfg.n_classes) == \
        (jcfg.depth, jcfg.width, jcfg.n_classes)
    jcls, tcls = ((JVGG19, VGG19) if arch == "vgg19-cifar"
                  else (JWideResNet, WideResNet))
    want = reference_layers(jcls(jcfg))
    got = port_layers(tcls(cfg, device="cpu"))
    assert got == want
    n_sparse = sum(mode != "dense" for mode, _ in got.values())
    assert n_sparse == (0 if pattern == "dense" else
                        15 if arch == "vgg19-cifar" else 36)
    # the paper's keep-dense rule: input conv, classifier, projections
    plan = vision_plan(cfg)
    for path in ("conv0", "stem", "fc", "g1b0.proj"):
        assert not plan.resolve(path).is_sparse


@pytest.mark.parametrize("arch", ["vgg19-cifar", "wrn40-4-cifar"])
def test_conv_layouts_take_the_bodies_the_chip_smoke_requires(arch):
    """At batch 256 the full-width RBGP4 model's sparse convs have the
    (m, k, N) of ``chip_smoke.conv_layers`` (VGG19's are Table 1's
    ``VGG19_SDMM``), and ``rhs_path`` / ``sddmm_path`` send (forward, dX,
    dW) of a bf16 step to the tensor-core bodies as often as
    ``chip_smoke.VISION_MMA`` requires: C 8 (transposed G 8) and C 2
    (transposed G 2) stay on the FMA bodies."""
    import chip_smoke

    model = chip_smoke.vision_model(arch, "rbgp4", "cpu", torch.float32)
    assert chip_smoke.conv_geometry(model, 256) == \
        chip_smoke.conv_layers(arch)
    assert len(chip_smoke.sparse_convs(model)) == \
        chip_smoke.VISION_SPARSE[arch]
    counts = chip_smoke.conv_mma_counts(model, 256)
    assert tuple(counts.values()) == chip_smoke.VISION_MMA[arch]
    assert chip_smoke.conv_mma_counts(model, 256, torch.float32) == \
        {"forward": 0, "dx": 0, "dw": 0}
