"""The dry-run's shape cells, ``host_shard`` and the production meshes
against the reference.

  * ``LM_SHAPES``, ``LONG_CONTEXT_ARCHS`` and ``shape_cells`` (names and
    skip texts) equal the reference's for all ten language models;
  * ``input_specs``: every leaf's shape and dtype equals the reference's
    ``ShapeDtypeStruct``, the decode caches leaf by leaf through the
    bridge's path map (the reference's scanned leaves split per layer);
  * ``host_shard`` equals the reference's over a grid of (global batch,
    index, count), its ``ValueError`` included;
  * ``make_production_mesh``'s axis names and sizes, on fake groups of 256
    and 512 ranks (a subprocess: the group is process-global), and its
    refusal of another world size; ``host_shard``'s defaults there, with
    and without a group.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

from repro.configs import LM_SHAPES as J_SHAPES
from repro.configs import LONG_CONTEXT_ARCHS as J_LONG
from repro.configs import get_config as j_get_config
from repro.configs import input_specs as j_input_specs
from repro.configs import list_archs as j_list_archs
from repro.configs import shape_cells as j_shape_cells
from repro.data.synthetic import host_shard as j_host_shard

from repro_torch.bridge import flatten_jax_tree
from repro_torch.configs import (LM_SHAPES, LONG_CONTEXT_ARCHS, get_config,
                                 input_specs, list_archs, shape_cells)
from repro_torch.data import host_shard

ROOT = Path(__file__).resolve().parents[1]
ARCHS = j_list_archs(lm_only=True)


def test_shapes_and_long_context_archs_equal_the_reference():
    assert [tuple(vars(s).values()) for s in LM_SHAPES] == \
        [tuple(vars(s).values()) for s in J_SHAPES]
    assert LONG_CONTEXT_ARCHS == J_LONG
    assert list_archs(lm_only=True) == ARCHS


@pytest.mark.parametrize("arch", ARCHS)
def test_shape_cells_equal_the_reference(arch):
    got = [(s.name, skip) for s, skip in shape_cells(get_config(arch))]
    want = [(s.name, skip) for s, skip in j_shape_cells(j_get_config(arch))]
    assert got == want
    assert sum(skip is not None for _, skip in got) == \
        (0 if arch in J_LONG else 1)


def _dtype(x) -> str:
    return str(x.dtype).split(".")[-1]


def _abstract(tree):
    """ShapeDtypeStructs -> zero-stride numpy arrays of their shape and
    dtype (no storage), which the bridge's path map takes."""
    return jax.tree_util.tree_map(
        lambda s: np.broadcast_to(np.zeros((), s.dtype), s.shape), tree)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape", [s.name for s in J_SHAPES])
def test_input_specs_equal_the_reference(arch, shape):
    jshape = next(s for s in J_SHAPES if s.name == shape)
    pshape = next(s for s in LM_SHAPES if s.name == shape)
    cfg = get_config(arch)
    want = j_input_specs(j_get_config(arch), jshape)
    got = input_specs(cfg, pshape)
    assert set(got) == set(want)
    if "batch" in want:
        assert set(got["batch"]) == set(want["batch"])
        for k, w in want["batch"].items():
            g = got["batch"][k]
            assert g.device.type == "meta"
            assert (tuple(g.shape), _dtype(g)) == (tuple(w.shape), _dtype(w))
        return
    for k in ("tokens_new", "index"):
        g, w = got[k], want[k]
        assert (tuple(g.shape), _dtype(g)) == (tuple(w.shape), _dtype(w))
    flat = flatten_jax_tree(cfg, {"stack": _abstract(want["cache"])})
    leaves = {f"stack.layers.{i}.{name}": t
              for i, layer in enumerate(got["cache"])
              for name, t in layer.items()}
    assert set(leaves) == set(flat)
    for name, t in leaves.items():
        assert t.device.type == "meta"
        assert (tuple(t.shape), _dtype(t)) == \
            (tuple(flat[name].shape), _dtype(flat[name])), name


GRID = [(b, i, n) for b in (1, 6, 8, 12, 256) for n in (1, 2, 3, 4, 16)
        for i in sorted({0, n // 2, n - 1})]


@pytest.mark.parametrize("b,i,n", GRID)
def test_host_shard_equals_the_reference(b, i, n):
    try:
        want = j_host_shard(b, i, n)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            host_shard(b, i, n)
        assert str(got.value) == str(e)
        return
    assert host_shard(b, i, n) == want


CHILD = r"""
import json, sys
import torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.data import host_shard
from repro_torch.launch.mesh import make_production_mesh

out = {"no_group": host_shard(8)}
for world, multi in ((256, False), (512, True)):
    dist.init_process_group("fake", store=FakeStore(), rank=3,
                            world_size=world)
    m = make_production_mesh(multi_pod=multi)
    out[str(world)] = {"names": list(m.mesh_dim_names),
                       "sizes": [m.size(i) for i in range(m.ndim)],
                       "coord": m.get_coordinate(),
                       "host_shard": host_shard(world * 2)}
    try:
        make_production_mesh(multi_pod=not multi)
    except ValueError as e:
        out[str(world)]["refused"] = str(e)
    dist.destroy_process_group()
print("MESH-JSON", json.dumps(out))
"""


def test_production_meshes_and_host_shard_defaults_on_fake_groups():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    p = subprocess.run([sys.executable, "-c", CHILD], env=env, cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode == 0, p.stderr[-3000:]
    line = next(l for l in p.stdout.splitlines() if l.startswith("MESH-JSON"))
    out = json.loads(line.split(" ", 1)[1])
    # the reference's make_production_mesh: names and shape
    assert out["256"]["names"] == ["data", "model"]
    assert out["256"]["sizes"] == [16, 16]
    assert out["512"]["names"] == ["pod", "data", "model"]
    assert out["512"]["sizes"] == [2, 16, 16]
    assert out["256"]["coord"] == [0, 3]
    assert out["512"]["coord"] == [0, 0, 3]
    # host_shard's defaults: index 0 of 1 without a group, else the
    # default group's rank and world size
    assert out["no_group"] == list(j_host_shard(8, 0, 1)) == [0, 8]
    assert out["256"]["host_shard"] == [6, 2]
    assert "needs a world of 512 ranks, have 256" in out["256"]["refused"]
    assert "needs a world of 256 ranks, have 512" in out["512"]["refused"]
