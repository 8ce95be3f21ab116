"""The port's op counter (``repro_torch.analysis``) against the
reference's HLO analyzer (``repro.analysis.hlo.analyze_hlo``).

The programs of ``tests/test_hlo_analysis.py``, written in torch on
``meta`` tensors, against ``analyze_hlo`` of the JAX programs: a plain
matmul and loops of 1, 10 and 22 steps and 3 x 5 nested (dot FLOPs within
1 FLOP); the gradient through a loop (the one matmul the two programs
differ by is named below); the residual case's bytes under 1e9.  And the
collectives that ``test_collectives_counted_with_factors`` skips on one
device: an all-gather and an all-reduce on a fake group of 4 ranks (a
subprocess: the group is process-global) against ``analyze_hlo`` of
``all_gather`` / ``psum`` under ``shard_map`` on 4 forced host devices (a
subprocess: the device count is fixed at jax's first import), bytes and
counts equal.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.analysis.hlo import analyze_hlo

from repro_torch.analysis import count_ops

ROOT = Path(__file__).resolve().parents[1]


def jcost(f, *specs):
    return analyze_hlo(jax.jit(f).lower(*specs).compile().as_text())


def meta(*shape, grad=False):
    return torch.empty(shape, device="meta", requires_grad=grad)


def loop(x, ws):
    c = x
    for w in ws:
        c = torch.tanh(c @ w)
    return c


def jloop(x, ws):
    def body(c, w):
        return jnp.tanh(c @ w), None
    y, _ = jax.lax.scan(body, x, ws)
    return y


def test_plain_matmul_equals_the_reference():
    sd = jax.ShapeDtypeStruct
    want = jcost(lambda x, w: x @ w, sd((128, 256), jnp.float32),
                 sd((256, 512), jnp.float32))
    x, w = meta(128, 256), meta(256, 512)
    _, got = count_ops(lambda: x @ w, arguments=[x, w])
    assert abs(got.dot_flops - want.dot_flops) < 1
    assert abs(got.dot_flops - 2 * 128 * 256 * 512) < 1
    assert got.unknown_trip_counts == 0 and got.loops == []
    assert got.op_result_shapes("mm") == [("float32", (128, 512))]


@pytest.mark.parametrize("n", [1, 10, 22])
def test_loop_counts_every_step(n):
    sd = jax.ShapeDtypeStruct
    want = jcost(jloop, sd((128, 256), jnp.float32),
                 sd((n, 256, 256), jnp.float32))
    x, ws = meta(128, 256), meta(n, 256, 256)
    _, got = count_ops(loop, x, ws, arguments=[x, ws])
    assert abs(got.dot_flops - want.dot_flops) < 1
    assert abs(got.dot_flops - 2 * 128 * 256 * 256 * n) < 1


def test_nested_loops():
    def h(x, ws):
        def outer(c, w):
            def inner(ci, _):
                return jnp.tanh(ci @ w), None
            ci, _ = jax.lax.scan(inner, c, None, length=5)
            return ci, None
        y, _ = jax.lax.scan(outer, x, ws)
        return y

    sd = jax.ShapeDtypeStruct
    want = jcost(h, sd((64, 64), jnp.float32), sd((3, 64, 64), jnp.float32))

    def g(x, ws):
        for w in ws:
            for _ in range(5):
                x = torch.tanh(x @ w)
        return x

    x, ws = meta(64, 64), meta(3, 64, 64)
    _, got = count_ops(g, x, ws, arguments=[x, ws])
    assert abs(got.dot_flops - want.dot_flops) < 1
    assert abs(got.dot_flops - 2 * 64 * 64 * 64 * 15) < 1


def grad_program(x, ws):
    loop(x, ws).sum().backward()


def test_grad_through_a_loop():
    """Per step the forward matmul, dW and dC; XLA computes the first
    step's dC too (a cotangent of x that ``jax.grad(argnums=1)`` then
    drops), autograd does not (x needs no gradient): the port counts one
    (128, 256) x (256, 256) matmul fewer."""
    n = 10

    def g(x, ws):
        return jnp.sum(jloop(x, ws))

    sd = jax.ShapeDtypeStruct
    want = jcost(jax.grad(g, argnums=1), sd((128, 256), jnp.float32),
                 sd((n, 256, 256), jnp.float32))
    x, ws = meta(128, 256), meta(n, 256, 256, grad=True)
    _, got = count_ops(grad_program, x, ws, arguments=[x, ws])
    step = 2 * 128 * 256 * 256
    assert abs(want.dot_flops - step * n * 3) / (step * n * 3) < 0.01
    assert abs(got.dot_flops - (want.dot_flops - step)) < 1


def test_loop_residual_bytes_not_full_stack():
    T, D = 64, 128
    x, ws = meta(8, D), meta(T, D, D, grad=True)
    _, got = count_ops(grad_program, x, ws, arguments=[x, ws])
    assert got.bytes_accessed < 1e9, got.bytes_accessed


def test_live_peak_follows_views_and_frees():
    """A view is not counted twice; a freed temporary leaves the peak."""
    a = meta(1024, 1024)                  # 4 MiB argument

    def prog():
        t = a * 2                         # +4 MiB
        v = t[:512]                       # a view: +0
        del t
        u = v + 1                         # +2 MiB while v (and t) live
        del v, u
        w = a + 1                         # after the frees: 4 MiB again
        return w

    _, got = count_ops(prog, arguments=[a])
    mib = 1 << 20
    assert got.argument_bytes == 4 * mib
    assert got.peak_bytes == (4 + 4 + 2) * mib


def test_remat_lowers_the_peak():
    """``torch.utils.checkpoint`` frees each layer's activations and
    recomputes them in the backward: the live peak shows it."""
    from torch.utils.checkpoint import checkpoint

    x = meta(4096, 1024)
    ws = [meta(1024, 1024, grad=True) for _ in range(8)]

    # sin saves its input (the product) for the backward: without remat
    # every layer keeps two activations, with remat one
    def prog(remat):
        c = x
        for w in ws:
            if remat:
                c = checkpoint(lambda h, w=w: torch.sin(h @ w), c,
                               use_reentrant=False)
            else:
                c = torch.sin(c @ w)
        c.sum().backward()
        for w in ws:
            w.grad = None

    _, plain = count_ops(prog, False, arguments=[x, *ws])
    _, remat = count_ops(prog, True, arguments=[x, *ws])
    assert remat.peak_bytes < plain.peak_bytes
    assert remat.dot_flops > plain.dot_flops   # the recomputed forwards


JAX_CHILD = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import json
import jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.analysis.hlo import analyze_hlo
try:
    from jax import shard_map
    kw = {"check_vma": False}
except ImportError:
    from jax.experimental.shard_map import shard_map
    kw = {"check_rep": False}
mesh = jax.make_mesh((4,), ("i",))
out = {}
progs = {
    "all_gather": lambda x: jax.lax.all_gather(x, "i", tiled=True),
    "psum": lambda x: jax.lax.psum(x, "i"),
}
for name, body in progs.items():
    f = shard_map(body, mesh=mesh, in_specs=P("i"),
                  out_specs=P() if name == "psum" else P(None), **kw)
    text = jax.jit(f).lower(
        jax.ShapeDtypeStruct((32, 16), jnp.float32)).compile().as_text()
    a = analyze_hlo(text)
    out[name] = {"bytes": a.collective_bytes, "counts": a.collective_counts}
print("COLL-JSON", json.dumps(out))
"""

TORCH_CHILD = r"""
import json
import torch
import torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.analysis import count_ops

dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
x = torch.empty(8, 16, device="meta")
out = {}
def gather():
    o = torch.empty(32, 16, device="meta")
    dist.all_gather_into_tensor(o, x)
def reduce():
    dist.all_reduce(x)
for name, f in (("all_gather", gather), ("psum", reduce)):
    _, a = count_ops(f, arguments=[x])
    out[name] = {"bytes": a.collective_bytes, "counts": a.collective_counts}
dist.destroy_process_group()
print("COLL-JSON", json.dumps(out))
"""


def child(code, env):
    p = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-3000:]
    line = next(l for l in p.stdout.splitlines() if l.startswith("COLL-JSON"))
    return json.loads(line.split(" ", 1)[1])


def test_collectives_counted_with_the_references_factors():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    want = child(JAX_CHILD, env)
    got = child(TORCH_CHILD, env)
    # an all-gather counts its result: (32, 16) f32; an all-reduce twice
    # its operand: 2 x (8, 16) f32
    assert want["all_gather"]["bytes"]["all-gather"] == 32 * 16 * 4
    assert want["psum"]["bytes"]["all-reduce"] == 2 * 8 * 16 * 4
    for name in ("all_gather", "psum"):
        for kind, b in want[name]["bytes"].items():
            assert got[name]["bytes"][kind] == b, (name, kind)
            assert got[name]["counts"][kind] == want[name]["counts"][kind]
        assert got[name]["bytes"]["broadcast"] == 0


# a scan of 4 chunks (the last one full) and of 3 and a ragged tail
SCAN_STEPS = (256, 202)


@pytest.mark.parametrize("steps", SCAN_STEPS)
@pytest.mark.parametrize("train", [False, True], ids=["prefill", "train"])
@pytest.mark.parametrize("arch", ["rwkv6-7b", "jamba-1.5-large-398b"])
def test_a_scan_reckoned_by_its_trip_count_equals_every_step_traced(
        arch, train, steps):
    """The dry-run's ``scan_trips``: a recurrent scan over ``meta``
    tensors runs one chunk of ``SCAN_CHUNK`` steps for all but its last,
    which runs as it is (``models.common.run_chunks``).  Against the trace
    of every step of the same program (a reduced model's prefill, or its
    loss and backward under remat): the dot FLOPs equal, the other FLOPs
    and the bytes within 0.1% (a chunk's gradient sums and zero-filled
    slices of the inputs, the ones its neighbours add to, differ by a few
    kB a chunk), the peak within 1%."""
    from repro_torch.configs import apply_sparsity, get_config, reduce_config
    from repro_torch.models import LMModel
    from repro_torch.models.common import SCAN_CHUNK

    assert steps // SCAN_CHUNK >= 3
    # the dry-run's storage (compact storage runs the card's kernels)
    cfg = apply_sparsity(reduce_config(get_config(arch)), pattern="rbgp4",
                         sparsity=0.5, backend="xla_masked", min_dim=64)
    if cfg.mamba is not None:
        cfg = cfg.with_(n_layers=4)
    model = LMModel(cfg, device="meta")
    tokens = torch.zeros((2, steps), dtype=torch.long, device="meta")
    params = list(model.parameters())
    for p in params:
        p.requires_grad_(train)

    def program():
        if train:
            model.loss({"tokens": tokens}, train=True)[0].backward()
            for p in params:
                p.grad = None
        else:
            model.prefill(tokens, model.init_cache(2, steps, torch.float32))

    _, full = count_ops(program, arguments=[tokens, *params])
    _, scaled = count_ops(program, arguments=[tokens, *params],
                          scan_trips=True)
    n_scans = sum(l.kind in ("mamba", "rwkv") for l in model.stack.layers)
    assert not full.loops
    assert len(scaled.loops) == n_scans * (2 if train else 1)
    assert all(n == (steps - 1) // SCAN_CHUNK for _, n in scaled.loops)
    assert scaled.dot_flops == full.dot_flops
    for got, want in ((scaled.flops, full.flops),
                      (scaled.bytes_accessed, full.bytes_accessed)):
        assert abs(got / want - 1) <= 1e-3, (got, want)
    assert abs(scaled.peak_bytes / full.peak_bytes - 1) <= 1e-2, \
        (scaled.peak_bytes, full.peak_bytes)
