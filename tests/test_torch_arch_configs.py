"""The other language models' full configs against the reference's, on
the CPU, host only: the registry (``list_archs``, every field of the
eight configs), and for every full config the recorded projection shapes
and the parameter count (built on ``meta``) and, under rbgp4 at 0.75 with
``min_dim=64`` (the card's sparsity, ``chip_smoke.main_config``), each
distinct projection shape's layout (spec and sampled factors), or dense
storage where the reference keeps it dense.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import list_archs as j_list_archs
from repro.models import LMModel as JLMModel
from repro.sparsity import SparsityConfig as JSparsityConfig
from repro.sparsity import make_pattern as j_make_pattern
from repro.sparsity import model_matmul_shapes as j_model_matmul_shapes
from repro_torch.configs import get_config, list_archs
from repro_torch.models import LMModel
from repro_torch.sparsity import SparsityConfig, make_pattern
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
