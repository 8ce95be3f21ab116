"""The port stands alone: no JAX, nothing of ``repro``, the card by default.
"""
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch import resolve_device
from repro_torch.configs import apply_sparsity, get_config, reduce_config
from repro_torch.kernels import rbgp4mm_rhs

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]

IMPORT_ALL = r"""
import pkgutil, sys, importlib
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "repro" or m.startswith("repro."))
print(len(names), "modules")
print("BAD", bad)
print("NAMES", " ".join(names))
assert not bad, bad
"""


def test_port_imports_no_jax_and_nothing_of_the_reference():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    p = subprocess.run([sys.executable, "-c", IMPORT_ALL], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stdout + p.stderr
    assert int(p.stdout.split()[0]) >= 20
    names = p.stdout.split("NAMES", 1)[1].split()
    for mod in ("repro_torch.models.moe", "repro_torch.kernels.ops",
                "repro_torch.configs.qwen2_moe_a2_7b",
                "repro_torch.kernels.chainmm", "repro_torch.sparsity.plan",
                "repro_torch.sparsity.chain", "repro_torch.sparsity.quant",
                "repro_torch.train.compress", "repro_torch.core.spectral",
                "repro_torch.kernels.perf_model",
                "repro_torch.launch.plan",
                "repro_torch.serve.chunked", "repro_torch.serve.prefix",
                "repro_torch.serve.faults", "repro_torch.serve.snapshot",
                "repro_torch.obs", "repro_torch.obs.metrics",
                "repro_torch.obs.spans", "repro_torch.obs.trace",
                "repro_torch.obs.record", "repro_torch.obs.audit",
                "repro_torch.kernels.autotune",
                "repro_torch.obs.kernelstats",
                "repro_torch.models.ssm", "repro_torch.models.rwkv",
                "repro_torch.parallel", "repro_torch.parallel.sharding",
                "repro_torch.parallel.constrain",
                "repro_torch.parallel.comm", "repro_torch.parallel.tensor",
                "repro_torch.launch.mesh", "repro_torch.serve.distributed",
                *(f"repro_torch.configs.{m}" for m in (
                    "gemma_7b", "gemma3_4b", "deepseek_7b", "pixtral_12b",
                    "deepseek_v2_236b", "rwkv6_7b", "jamba_1_5_large_398b",
                    "musicgen_medium"))):
        assert mod in names, mod


def test_chip_smoke_imports_no_jax():
    src = (ROOT / "chip_smoke.py").read_text()
    for line in src.splitlines():
        words = line.split()
        if words[:1] in (["import"], ["from"]):
            mod = words[1].split(".")[0]
            assert mod not in ("jax", "jaxlib", "repro"), line


def test_chip_smoke_fails_without_cuda_and_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: chip_smoke.py runs for real")
    p = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                       cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert '"ok"' not in p.stdout


def test_default_device_is_cuda_and_never_falls_back():
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32


def test_entry_points_default_to_the_card():
    from repro_torch.models import LMModel

    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device works")
    cfg = reduce_config(get_config("tinyllama-1.1b"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LMModel(cfg)


def test_unported_names_raise():
    """Every architecture and layer kind of the reference is ported: an
    unknown name raises, and so does a mixer kind without its
    sub-config."""
    assert get_config("gemma3-4b").name == "gemma3-4b"
    with pytest.raises(KeyError):
        get_config("no-such-arch")
    from repro_torch.models import LMModel

    cfg = reduce_config(get_config("tinyllama-1.1b"))
    with pytest.raises(ValueError, match="unknown layer kind"):
        LMModel(cfg.with_(layer_pattern=("conv",)), device="cpu")
    for kind in ("mla", "mamba", "rwkv"):
        with pytest.raises(ValueError, match=f"needs cfg.{kind}"):
            LMModel(cfg.with_(layer_pattern=(kind,)), device="cpu")
    # the block pattern and the masked backend are ported: both build
    # masked storage
    from repro_torch.sparsity import SparseLinear

    for model in (LMModel(apply_sparsity(cfg, pattern="block", min_dim=64),
                          device="cpu"),
                  LMModel(apply_sparsity(cfg, backend="xla_masked",
                                         min_dim=64), device="cpu")):
        modes = {m.mode for m in model.modules()
                 if isinstance(m, SparseLinear)}
        assert "masked" in modes


def test_launch_counter_stays_zero_on_cpu_tensors():
    from repro_torch.models import LMModel
    from repro_torch.serve import ContinuousEngine

    rbgp4mm_rhs.launches = 0
    cfg = apply_sparsity(reduce_config(get_config("tinyllama-1.1b")),
                         sparsity=0.75, min_dim=64)
    model = LMModel(cfg, device="cpu")
    eng = ContinuousEngine(model, page_size=4, max_slots=2,
                           max_request_len=16)
    eng.submit([1, 2, 3, 4, 5], 3)
    out = eng.drain()
    assert len(out[0]) == 3
    assert rbgp4mm_rhs.launches == 0


def test_chunked_and_static_engines_launch_nothing_on_cpu_tensors():
    from repro_torch.models import LMModel
    from repro_torch.serve import ContinuousEngine, StaticEngine

    rbgp4mm_rhs.launches = rbgp4mm_rhs.launches_mma = 0
    cfg = apply_sparsity(reduce_config(get_config("tinyllama-1.1b")),
                         sparsity=0.75, min_dim=64)
    model = LMModel(cfg, device="cpu")
    for eng in (ContinuousEngine(model, page_size=4, max_slots=2,
                                 max_request_len=16, prefill_chunk=3,
                                 reserve="prompt", prefix_cache=True),
                StaticEngine(model, batch=2)):
        eng.submit([1, 2, 3, 4, 5], 3)
        eng.submit([1, 2, 3, 4, 5], 2)
        out = eng.drain()
        assert [len(out[r]) for r in (0, 1)] == [3, 2]
    assert rbgp4mm_rhs.launches == rbgp4mm_rhs.launches_mma == 0
