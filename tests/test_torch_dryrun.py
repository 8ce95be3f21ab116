"""The port's dry-run (``repro_torch.launch.dryrun``) on the CPU.

  * the CLI on ``tinyllama-1.1b --shape decode_32k --mesh single``, in a
    subprocess: status ok, mesh 16x16, the peak a device under 80 GB (one
    NVIDIA H100 80GB HBM3), the three roofline terms;
  * a skipped ``long_500k`` cell (the reference's skip text), an rwkv6-7b
    cell traced ``ok`` (its mixers sharded by channel), a deepseek-v2 cell
    at model 3, which does not divide its 128 MLA heads (``shard_module``'s
    refusal as the reason), and a cell whose trace meets an op without a
    ``meta`` kernel, an error;
  * reduced tinyllama and qwen2-moe on a (1, 4) data/model mesh, one small
    cell of each kind (and at (2, 2) and (2, 4), where FSDP cuts the
    weights over "data": the prefill and decode argument bytes equal the
    reference's, and a train cell's keep their (1, 4) ratio to the
    reference's within 1%), against the reference's ``build_cell``,
    ``memory_analysis``, ``analyze_hlo``, ``active_param_count`` and
    ``attention_flops`` on 8 forced host devices (a subprocess each side:
    the reference's device count and the port's fake group are
    process-global).  The model FLOPs a device are equal (relative 1e-9);
    the argument bytes of parameters, inputs and caches are equal for
    prefill and decode (the port's RoPE frequencies, which the reference
    folds into its program, set apart; against the reference's argument
    leaves, of which its compiled program drops the one it never reads);
    the dot FLOPs are within 5% for prefill and decode and 10% for
    train;
  * reduced rwkv6-7b and jamba (cut to 4 layers: three Mamba layers and
    the attention layer) at (1, 4) and (2, 2), the same way: the model
    FLOPs a device equal, the prefill and decode argument bytes equal the
    reference's leaves' (the recurrent caches cut as ``cache_specs``
    cuts them, not as a rank's layer holds them), and a train cell's keep
    their (1, 4) ratio to the reference's at (2, 2) within 1%.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ["tinyllama-1.1b", "qwen2-moe-a2.7b"]
# (name, kind, global batch, seq)
CELLS = [("train_s", "train", 4, 32), ("prefill_s", "prefill", 4, 32),
         ("decode_s", "decode", 4, 32)]
# (data, model): the first is the one every check runs at; the others cut
# the weights over "data" too (FSDP)
MESHES = [(1, 4), (2, 2), (2, 4)]
DOT_TOL = {"train": 0.10, "prefill": 0.05, "decode": 0.05}

# the recurrent archs and their meshes; jamba cut to 4 layers for time
RECURRENT = ["rwkv6-7b", "jamba-1.5-large-398b"]
RECURRENT_MESHES = [(1, 4), (2, 2)]

CONFIG = r"""
FIELDS = {"jamba-1.5-large-398b": {"n_layers": 4}}


def config(arch, reduce_config, get_config, apply_sparsity):
    cfg = reduce_config(get_config(arch))
    cfg = apply_sparsity(cfg, pattern="rbgp4", sparsity=0.5,
                         backend="xla_masked", min_dim=64)
    # the full-width configs' dtypes (reduce_config computes in float32)
    return cfg.with_(param_dtype="bfloat16", compute_dtype="bfloat16",
                     **FIELDS.get(arch, {}))
"""

REF_CHILD = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import json, sys
import jax
import numpy as np
assert len(jax.devices()) == 8
from repro.analysis.hlo import analyze_hlo
from repro.configs import (ShapeConfig, TrainConfig, apply_sparsity,
                           get_config, reduce_config)
from repro.launch import dryrun as D
from repro.launch.mesh import make_serve_mesh
from repro.models import LMModel
from repro.parallel.constrain import activation_mesh
""" + CONFIG + r"""
req = json.loads(sys.argv[1])
tcfg = TrainConfig(optimizer="sgdm", grad_clip=1.0, microbatches=1)
out = {}
for arch, (dp, tp) in [(a, m) for m in req["meshes"] for a in req["archs"]]:
    mesh = make_serve_mesh(dp, tp)
    cfg = config(arch, reduce_config, get_config, apply_sparsity)
    _, active = D.active_param_count(cfg, LMModel(cfg))
    for name, kind, b, s in req["cells"]:
        shape = ShapeConfig(name, s, b, kind)
        with activation_mesh(mesh):
            jitted, args = D.build_cell(cfg, shape, mesh, tcfg)
            compiled = jitted.lower(*args).compile()
        ana = analyze_hlo(compiled.as_text())
        # every argument leaf's per-device bytes: memory_analysis leaves
        # out the ones the compiled program never reads (kept_var_idx),
        # which are replicated masks here, whole on every device
        leaves = jax.tree_util.tree_flatten_with_path(args)[0]
        kept = sorted(compiled._executable._kept_var_idx)
        shs = dict(zip(kept, jax.tree_util.tree_leaves(
            compiled.input_shardings[0])))
        leaf_bytes, dropped = 0, []
        for i, (path, l) in enumerate(leaves):
            dims = shs[i].shard_shape(l.shape) if i in shs else l.shape
            leaf_bytes += int(np.prod(dims)) * l.dtype.itemsize
            if i not in shs:
                dropped.append(jax.tree_util.keystr(path))
        tokens = b * (s if kind != "decode" else 1)
        mult = 6 if kind == "train" else 2
        mf = mult * active * tokens + (mult / 2) * D.attention_flops(
            cfg, shape)
        out[f"{arch}|{name}|{dp}x{tp}"] = {
            "argument_bytes":
                compiled.memory_analysis().argument_size_in_bytes,
            "leaf_bytes": leaf_bytes, "dropped": dropped,
            "dot_flops": ana.dot_flops,
            "dot_breakdown": ana.top_dots(40),
            "model_flops_per_device": mf / (dp * tp)}
print("DRY-JSON", json.dumps(out))
"""

PORT_CHILD = r"""
import json, sys
import torch
from repro_torch.configs import (ShapeConfig, apply_sparsity, get_config,
                                 reduce_config)
from repro_torch.launch import dryrun as D
""" + CONFIG + r"""
req = json.loads(sys.argv[1])
torch.set_num_threads(2)
out = {}
for arch, (dp, tp) in [(a, m) for m in req["meshes"] for a in req["archs"]]:
    D.start_fake_group(dp * tp)
    mesh = D.make_mesh((dp, tp), ("data", "model"))
    cfg = config(arch, reduce_config, get_config, apply_sparsity)
    for name, kind, b, s in req["cells"]:
        rec = D.reckon(cfg, ShapeConfig(name, s, b, kind), mesh)
        mem = rec["memory"]
        out[f"{arch}|{name}|{dp}x{tp}"] = {
            "argument_bytes": round((mem["argument_gb"]
                                     - mem["constants_gb"]) * 1e9),
            "dot_flops": rec["hlo_flops_per_device"],
            "dot_breakdown": rec["top_dots"],
            "model_flops_per_device": rec["model_flops_per_device"]}
print("DRY-JSON", json.dumps(out))
"""


def child(code, args=(), timeout=600):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="2")
    p = subprocess.run([sys.executable, *code, *args], env=env, cwd=ROOT,
                       capture_output=True, text=True, timeout=timeout)
    return p


def parse(p, tag):
    assert p.returncode == 0, p.stdout[-2000:] + p.stderr[-4000:]
    line = next(l for l in p.stdout.splitlines() if l.startswith(tag))
    return json.loads(line.split(" ", 1)[1])


def test_cli_decode_cell_at_16x16(tmp_path):
    out = tmp_path / "cell.jsonl"
    p = child(["-m", "repro_torch.launch.dryrun", "--arch", "tinyllama-1.1b",
               "--shape", "decode_32k", "--mesh", "single", "--out",
               str(out)])
    assert p.returncode == 0, p.stdout[-2000:] + p.stderr[-4000:]
    (rec,) = [json.loads(l) for l in out.read_text().splitlines()]
    assert rec["status"] == "ok" and rec["mesh"] == "16x16"
    assert 0 < rec["memory"]["peak_per_device_gb"] < 80
    assert rec["memory"]["argument_gb"] <= rec["memory"]["peak_per_device_gb"]
    assert set(rec["roofline"]) == {"compute_s", "memory_s", "collective_s"}
    assert rec["bottleneck"] in rec["roofline"]
    assert rec["hlo_unknown_trip_counts"] == 0
    assert rec["collectives"]["counts"]["all-gather"] > 0
    # one decode step of 8 rows a device: the model FLOPs match the
    # matmuls traced within a percent
    assert abs(rec["useful_flop_ratio"] - 1) < 0.01


SKIP_CHILD = r"""
import json
from repro.configs import get_config as j_get_config
from repro.configs import shape_cells as j_shape_cells
from repro_torch.configs import ShapeConfig
from repro_torch.launch import dryrun as D
out = {"long": D.run_cell("tinyllama-1.1b", "long_500k", "single",
                          "rbgp4", 0.75),
       "rwkv": D.run_cell("rwkv6-7b", "decode_32k", "single", "rbgp4",
                          0.75),
       "mla": D.run_cell("deepseek-v2-236b", "decode_3x32", "1x3", "rbgp4",
                         0.75, shape=ShapeConfig("decode_3x32", 32, 3,
                                                 "decode")),
       "want_long": dict((s.name, k) for s, k in
                         j_shape_cells(j_get_config("tinyllama-1.1b")))[
                             "long_500k"]}
print("DRY-JSON", json.dumps(out))
"""


def test_skipped_and_refused_cells():
    """A skip (the reference's text), a recurrent cell traced ``ok`` at
    16 x 16 (its caches read through their spec's cut), and a refusal:
    model 3 does not divide deepseek-v2's 128 MLA heads."""
    out = parse(child(["-c", SKIP_CHILD]), "DRY-JSON")
    assert out["long"]["status"] == "skipped"
    assert out["long"]["reason"] == out["want_long"]
    rwkv = out["rwkv"]
    assert rwkv["status"] == "ok" and rwkv["mesh"] == "16x16", rwkv
    assert 0 < rwkv["memory"]["argument_gb"] \
        <= rwkv["memory"]["peak_per_device_gb"] < 80
    # the RWKV states' spec cut (the key index) is not the layer's (its
    # heads): read through, gathered over "model" a layer
    assert rwkv["collectives"]["counts"]["all-gather"] > 0
    assert out["mla"]["status"] == "skipped", out["mla"]
    assert "128 heads do not split over model=3" in out["mla"]["reason"]


NO_META_CHILD = r"""
import sys
import torch
from repro_torch.launch import dryrun as D
from repro_torch.models import LMModel

# an op with a CPU kernel and none for meta: on meta the dispatcher raises
# NotImplementedError, which must not pass for shard_module's refusal
lib = torch.library.Library("dryrun_no_meta", "DEF")
lib.define("touch(Tensor x) -> Tensor")
lib.impl("touch", lambda x: x.clone(), "CPU")
decode = LMModel.decode_step
LMModel.decode_step = lambda self, tokens, *a, **k: decode(
    self, torch.ops.dryrun_no_meta.touch(tokens), *a, **k)
sys.argv = ["dryrun", "--arch", "tinyllama-1.1b", "--mesh", "1x4",
            "--cell", "decode,4,32", "--out", sys.argv[1]]
D.main()
"""


def test_an_op_without_a_meta_kernel_is_an_error(tmp_path):
    """A ``NotImplementedError`` from the trace (an op with no ``meta``
    kernel) is ``status: "error"`` with exit code 1, not a skip."""
    out = tmp_path / "cell.jsonl"
    p = child(["-c", NO_META_CHILD], [str(out)])
    assert p.returncode == 1, p.stdout[-2000:] + p.stderr[-4000:]
    (rec,) = [json.loads(l) for l in out.read_text().splitlines()]
    assert rec["status"] == "error", rec
    assert rec["error"].startswith("NotImplementedError"), rec["error"]
    assert "dryrun_no_meta" in rec["error"], rec["error"]


@pytest.fixture(scope="module")
def both():
    req = json.dumps({"archs": ARCHS, "cells": CELLS, "meshes": MESHES})
    ref = parse(child(["-c", REF_CHILD], [req], timeout=900), "DRY-JSON")
    port = parse(child(["-c", PORT_CHILD], [req]), "DRY-JSON")
    return ref, port


KEYS = [(a, c) for a in ARCHS for c in CELLS]


@pytest.mark.parametrize("arch,cell", KEYS,
                         ids=[f"{a}-{c[0]}" for a, c in KEYS])
def test_reduced_cells_against_the_reference(both, arch, cell):
    ref, port = both
    key = f"{arch}|{cell[0]}|1x4"
    want, got = ref[key], port[key]
    assert abs(got["model_flops_per_device"]
               - want["model_flops_per_device"]) \
        <= 1e-9 * want["model_flops_per_device"]
    if cell[1] != "train":
        # XLA drops the arguments its program never reads (qwen2-moe's
        # experts' up mask: the expert-parallel path reads gate's for
        # both); the port holds every tensor of the model
        assert got["argument_bytes"] == want["leaf_bytes"], key
        assert all("ba_" in d or "mask" in d for d in want["dropped"]), \
            want["dropped"]
    rel = abs(got["dot_flops"] - want["dot_flops"]) / want["dot_flops"]
    assert rel <= DOT_TOL[cell[1]], (key, got["dot_flops"],
                                     want["dot_flops"],
                                     got["dot_breakdown"][:8],
                                     want["dot_breakdown"][:8])


FSDP_KEYS = [(a, c, m) for a in ARCHS for c in CELLS for m in MESHES[1:]]


@pytest.mark.parametrize("arch,cell,mesh", FSDP_KEYS,
                         ids=[f"{a}-{c[0]}-{m[0]}x{m[1]}"
                              for a, c, m in FSDP_KEYS])
def test_fsdp_argument_bytes_against_the_reference(both, arch, cell, mesh):
    """With the data axes cutting the weights (FSDP), a prefill or decode
    cell's argument bytes are the reference's leaves' per-device bytes;
    a train cell's (bf16 weights beside float32 masters and momentum,
    each cut alike) keep the ratio to the reference's they have at
    (1, 4), within 1%."""
    ref, port = both
    key = f"{arch}|{cell[0]}|{mesh[0]}x{mesh[1]}"
    want, got = ref[key], port[key]
    if cell[1] != "train":
        assert got["argument_bytes"] == want["leaf_bytes"], key
        return
    base = f"{arch}|{cell[0]}|1x4"
    at_1x4 = port[base]["argument_bytes"] / ref[base]["leaf_bytes"]
    ratio = got["argument_bytes"] / want["leaf_bytes"]
    assert abs(ratio / at_1x4 - 1) <= 0.01, (key, ratio, at_1x4)


@pytest.fixture(scope="module")
def recurrent():
    req = json.dumps({"archs": RECURRENT, "cells": CELLS,
                      "meshes": RECURRENT_MESHES})
    ref = parse(child(["-c", REF_CHILD], [req], timeout=900), "DRY-JSON")
    port = parse(child(["-c", PORT_CHILD], [req]), "DRY-JSON")
    return ref, port


REC_KEYS = [(a, c, m) for a in RECURRENT for c in CELLS
            for m in RECURRENT_MESHES]


@pytest.mark.parametrize("arch,cell,mesh", REC_KEYS,
                         ids=[f"{a}-{c[0]}-{m[0]}x{m[1]}"
                              for a, c, m in REC_KEYS])
def test_recurrent_cells_against_the_reference(recurrent, arch, cell,
                                                mesh):
    ref, port = recurrent
    key = f"{arch}|{cell[0]}|{mesh[0]}x{mesh[1]}"
    want, got = ref[key], port[key]
    assert abs(got["model_flops_per_device"]
               - want["model_flops_per_device"]) \
        <= 1e-9 * want["model_flops_per_device"]
    if cell[1] != "train":
        assert got["argument_bytes"] == want["leaf_bytes"], \
            (key, got["argument_bytes"], want["leaf_bytes"])
        # XLA drops the masks, and rwkv6-7b's decode index, which no
        # layer of an all-recurrent model reads
        assert all("ba_" in d or "mask" in d or d == "[3]"
                   for d in want["dropped"]), want["dropped"]
    elif mesh != RECURRENT_MESHES[0]:
        base = f"{arch}|{cell[0]}|1x4"
        at_1x4 = port[base]["argument_bytes"] / ref[base]["leaf_bytes"]
        ratio = got["argument_bytes"] / want["leaf_bytes"]
        assert abs(ratio / at_1x4 - 1) <= 0.01, (key, ratio, at_1x4)
