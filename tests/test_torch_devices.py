"""Every module of the port puts all of its tensors on one device.

``device=None`` means the card for every module that takes a device:
the norms, the embedding, attention's rotary table, the projections, the
router and the experts.  There is no card here, so a second device stands
in for it: ``resolve_device`` is patched, in every module that calls it,
to give ``meta`` for ``None``, and every parameter and buffer of a bare
``GQAttention``, ``GatedMLP``, ``DecoderLayer``, ``Stack`` and ``MoELayer``
must then lie on ``meta``; so for ``MLAttention``, ``MambaMixer`` and
``RWKVBlock``.  Without the patch, and without CUDA, each bare
constructor raises, naming ``device='cpu'``.
"""
import pytest
import torch

from repro_torch import device as device_mod
from repro_torch.configs import apply_sparsity, get_config, reduce_config
from repro_torch.models import (attention, common, moe, rwkv, ssm,
                                transformer)
from repro_torch.models.attention import GQAttention, MLAttention
from repro_torch.models.mlp import GatedMLP
from repro_torch.models.moe import MoELayer
from repro_torch.models.rwkv import RWKVBlock
from repro_torch.models.ssm import MambaMixer
from repro_torch.models.transformer import DecoderLayer, Stack
from repro_torch.sparsity import layer as layer_mod

torch.set_num_threads(1)

PATCHED = (device_mod, common, attention, transformer, moe, ssm, rwkv,
           layer_mod)
MIXERS = {"MLAttention": (MLAttention, "deepseek-v2-236b"),
          "MambaMixer": (MambaMixer, "jamba-1.5-large-398b"),
          "RWKVBlock": (RWKVBlock, "rwkv6-7b")}


def _config(arch):
    return apply_sparsity(reduce_config(get_config(arch)), pattern="rbgp4",
                          sparsity=0.75, min_dim=64)


def _constructors():
    tiny, qmoe = _config("tinyllama-1.1b"), _config("qwen2-moe-a2.7b")
    moe_idx = next(i for i in range(qmoe.n_layers) if qmoe.is_moe_layer(i))
    return {
        "GQAttention": lambda: GQAttention(tiny),
        "GatedMLP": lambda: GatedMLP(tiny.d_model, tiny.d_ff,
                                     tiny.sparsity_rules, tiny.hidden_act),
        "DecoderLayer": lambda: DecoderLayer(tiny, 0),
        "DecoderLayer-moe": lambda: DecoderLayer(qmoe, moe_idx),
        "Stack": lambda: Stack(tiny),
        "Stack-moe": lambda: Stack(qmoe),
        "MoELayer": lambda: MoELayer(qmoe.d_model, qmoe.moe,
                                     qmoe.sparsity_rules, qmoe.hidden_act),
        **{name: (lambda c=cls, a=arch: c(_config(a)))
           for name, (cls, arch) in MIXERS.items()},
    }


@pytest.fixture
def meta_card(monkeypatch):
    """``resolve_device(None)`` gives ``meta``, standing in for the card."""
    real = device_mod.resolve_device

    def fake(device=None):
        dev = torch.device("meta" if device is None else device)
        return dev if dev.type == "meta" else real(dev)

    for mod in PATCHED:
        monkeypatch.setattr(mod, "resolve_device", fake)


def _devices(module):
    tensors = list(module.parameters()) + list(module.buffers())
    assert tensors
    return {t.device.type for t in tensors}


@pytest.mark.parametrize("name", list(_constructors()))
def test_default_device_is_one_device(name, meta_card):
    assert _devices(_constructors()[name]()) == {"meta"}, name


@pytest.mark.parametrize("name", list(_constructors()))
def test_bare_constructors_raise_without_cuda(name):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device works")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _constructors()[name]()


@pytest.mark.parametrize("name", list(_constructors()))
def test_explicit_cpu_builds_on_cpu(name):
    """``device='cpu'`` reaches every tensor (passed down, not dropped)."""
    tiny, qmoe = _config("tinyllama-1.1b"), _config("qwen2-moe-a2.7b")
    moe_idx = next(i for i in range(qmoe.n_layers) if qmoe.is_moe_layer(i))
    build = {
        "GQAttention": lambda: GQAttention(tiny, device="cpu"),
        "GatedMLP": lambda: GatedMLP(tiny.d_model, tiny.d_ff,
                                     tiny.sparsity_rules, tiny.hidden_act,
                                     device="cpu"),
        "DecoderLayer": lambda: DecoderLayer(tiny, 0, device="cpu"),
        "DecoderLayer-moe": lambda: DecoderLayer(qmoe, moe_idx,
                                                 device="cpu"),
        "Stack": lambda: Stack(tiny, device="cpu"),
        "Stack-moe": lambda: Stack(qmoe, device="cpu"),
        "MoELayer": lambda: MoELayer(qmoe.d_model, qmoe.moe,
                                     qmoe.sparsity_rules, qmoe.hidden_act,
                                     device="cpu"),
        **{n: (lambda c=cls, a=arch: c(_config(a), device="cpu"))
           for n, (cls, arch) in MIXERS.items()},
    }[name]
    assert _devices(build()) == {"cpu"}, name
