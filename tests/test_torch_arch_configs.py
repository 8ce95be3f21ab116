"""The other language models' full configs against the reference's, on
the CPU, host only: the registry (``list_archs``, every field of the
eight configs), and for every full config the recorded projection shapes
and the parameter count (built on ``meta``) and, under rbgp4 at 0.75 with
``min_dim=64`` (the card's sparsity, ``chip_smoke.main_config``), each
distinct projection shape's layout (spec and sampled factors), or dense
storage where the reference keeps it dense.  Then ``reduce_config`` of
all twelve archs under either backend the reference's callers pass,
field for field.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import list_archs as j_list_archs
from repro.configs import reduce_config as j_reduce_config
from repro.models import LMModel as JLMModel
from repro.sparsity import SparsityConfig as JSparsityConfig
from repro.sparsity import make_pattern as j_make_pattern
from repro.sparsity import model_matmul_shapes as j_model_matmul_shapes
from repro_torch.configs import get_config, list_archs, reduce_config
from repro_torch.models import LMModel
from repro_torch.sparsity import SparseLinear, SparsityConfig, make_pattern
from repro_torch.sparsity import model_matmul_shapes

torch.set_num_threads(1)
NEW_ARCHS = ("gemma-7b", "gemma3-4b", "deepseek-7b", "pixtral-12b",
             "deepseek-v2-236b", "rwkv6-7b", "jamba-1.5-large-398b",
             "musicgen-medium")
#: the card's sparsity (chip_smoke.main_config)
CARD_SP = dict(pattern="rbgp4", sparsity=0.75, min_dim=64)


def test_list_archs_gives_ten_and_twelve():
    assert list_archs() == j_list_archs()
    assert len(list_archs()) == 12
    assert list_archs(lm_only=True) == j_list_archs(lm_only=True)
    assert len(list_archs(lm_only=True)) == 10
    for arch in NEW_ARCHS:
        want = dataclasses.asdict(j_get_config(arch))
        got = dataclasses.asdict(get_config(arch))
        want.pop("ssm_unroll")
        for key in ("sparsity", "plan"):   # the port's default backend
            want.pop(key), got.pop(key)
        assert got == want, arch


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_full_config_shapes_and_param_counts(arch):
    """Recorded on ``meta``: every projection's (m, k, count), and the
    stored values of the dense full model, as the reference's."""
    cfg, jcfg = get_config(arch), j_get_config(arch)
    assert model_matmul_shapes(cfg) == j_model_matmul_shapes(jcfg)
    assert LMModel(cfg, device="meta").n_params() == \
        JLMModel(jcfg).n_params()


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_full_width_layouts_match_reference(arch):
    """rbgp4 at 0.75, ``min_dim=64``: every distinct projection shape of
    the full config designs the reference's layout (spec and sampled
    factors), or stays dense where the reference's does."""
    cfg, jcfg = SparsityConfig(**CARD_SP), JSparsityConfig(**CARD_SP)
    dims = {(m, k) for m, k, _ in model_matmul_shapes(get_config(arch))
            .values()}
    assert dims
    for m, k in sorted(dims):
        assert cfg.applies_to(m, k) == jcfg.applies_to(m, k), (m, k)
        if not cfg.applies_to(m, k):
            continue
        got, want = make_pattern(cfg, m, k), j_make_pattern(jcfg, m, k)
        assert dataclasses.asdict(got.layout.spec) == \
            dataclasses.asdict(want.layout.spec), (m, k)
        np.testing.assert_array_equal(got.layout.adj_o, want.layout.adj_o)
        np.testing.assert_array_equal(got.layout.adj_i, want.layout.adj_i)


@pytest.mark.parametrize("backend", ["auto", "xla_masked"])
@pytest.mark.parametrize("arch", j_list_archs())
def test_reduce_config_matches_reference(arch, backend):
    """``reduce_config(cfg, sparsity_backend=...)`` equals the reference's
    field for field (the port has no ``ssm_unroll``); without the keyword
    the port's backend is 'auto', the reference's 'xla_masked', and
    nothing else differs.  The vision configs have no reduced form on
    either side: both raise the same error.  Under 'xla_masked' the
    reduced model builds masked storage, as the reference's does."""
    cfg, jcfg = get_config(arch), j_get_config(arch)
    if arch.endswith("-cifar"):
        with pytest.raises(AttributeError) as want:
            j_reduce_config(jcfg, sparsity_backend=backend)
        with pytest.raises(AttributeError) as got:
            reduce_config(cfg, sparsity_backend=backend)
        assert str(got.value) == str(want.value)
        return
    got = dataclasses.asdict(reduce_config(cfg, sparsity_backend=backend))
    want = dataclasses.asdict(j_reduce_config(jcfg,
                                              sparsity_backend=backend))
    want.pop("ssm_unroll")
    assert got == want
    assert got["sparsity"]["backend"] == backend
    default = dataclasses.asdict(reduce_config(cfg))
    j_default = dataclasses.asdict(j_reduce_config(jcfg))
    j_default.pop("ssm_unroll")
    assert default["sparsity"].pop("backend") == "auto"
    assert j_default["sparsity"].pop("backend") == "xla_masked"
    assert default == j_default
    if backend == "xla_masked":
        model = LMModel(reduce_config(cfg, sparsity_backend=backend),
                        device="cpu")
        modes = {m.mode for m in model.modules()
                 if isinstance(m, SparseLinear)}
        assert "masked" in modes and modes <= {"masked", "dense"}
