"""Int8 gradient compression summed over a process group (gloo, CPU).

``compress_decompress(..., group=)`` is the counterpart of the
reference's ``axis_name`` (``repro/train/compress.py:66-82``): four ranks
each hold one of four seeded gradient trees (with error feedback); the
int8 payload summed over the group as int32 is bit-equal to the
reference's ``psum`` under ``jax.vmap(..., axis_name=)``, and the
dequantized mean within 1e-7 * max|ref| of its result; the residuals are
each rank's own, bit for bit.
"""
import os
import pickle
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.train.compress import compress_decompress as j_compress
from repro.train.compress import quantize_int8 as j_quantize

from test_torch_serve_sharded import run_ranks

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4

CHILD = r'''
import os, pickle, sys
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def rank_main(rank, world, store, work):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=60))
    from repro_torch.parallel import COLLECTIVES, MeshAxis
    from repro_torch.parallel.comm import all_reduce_sum
    from repro_torch.train import compress_decompress
    from repro_torch.train.compress import quantize_int8

    with open(os.path.join(work, "in.pkl"), "rb") as f:
        grads, errors = pickle.load(f)
    t = lambda tree: {k: t(v) if isinstance(v, dict) else torch.tensor(v)
                      for k, v in tree.items()}
    n = lambda tree: {k: n(v) if isinstance(v, dict) else v.numpy()
                      for k, v in tree.items()}
    g, e = t(grads[rank]), t(errors[rank])
    out, new_e = compress_decompress(g, e, group=dist.group.WORLD)
    axis = MeshAxis(None, rank, world)
    q, _ = quantize_int8(g["a"].float() + e["a"])
    q_sum = all_reduce_sum(q.to(torch.int32), axis)
    with open(os.path.join(work, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump({"out": n(out), "err": n(new_e), "q_sum": q_sum.numpy(),
                     "collectives": dict(COLLECTIVES)}, f)
    dist.destroy_process_group()


if __name__ == "__main__":
    work = sys.argv[1]
    mp.spawn(rank_main, args=(4, os.path.join(work, "store"), work),
             nprocs=4)
'''


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {"a": (rng.standard_normal((7, 5)) * 3).astype(np.float32),
            "b": {"c": rng.standard_normal(11).astype(np.float32)}}


def _stack(trees):
    return jax.tree_util.tree_map(lambda *x: jnp.stack(x), *trees)


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    work = tmp_path_factory.mktemp("compress")
    grads = [_tree(i) for i in range(WORLD)]
    errors = [jax.tree_util.tree_map(lambda x: x * 1e-2, _tree(10 + i))
              for i in range(WORLD)]
    with open(work / "in.pkl", "wb") as f:
        pickle.dump((grads, errors), f)
    (work / "child.py").write_text(CHILD)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    out, err, rc = run_ranks([sys.executable, str(work / "child.py"),
                              str(work)], env)
    assert rc == 0, out[-2000:] + err[-4000:]
    ranks = []
    for r in range(WORLD):
        with open(work / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    ref = jax.vmap(lambda g, e: j_compress(g, e, axis_name="i"),
                   axis_name="i")(_stack(grads), _stack(errors))
    q_sum = jax.vmap(lambda g, e: jax.lax.psum(
        j_quantize(g["a"] + e["a"])[0].astype(jnp.int32), "i"),
        axis_name="i")(_stack(grads), _stack(errors))
    return ranks, ref, np.asarray(q_sum)


def test_summed_int8_payload_is_bit_equal_to_the_reference_psum(both):
    ranks, _, q_sum = both
    for r, got in enumerate(ranks):
        np.testing.assert_array_equal(got["q_sum"], q_sum[r])
        assert got["collectives"]["all_reduce"] == 2 + 1


@pytest.mark.parametrize("leaf", ["a", "b.c"])
def test_group_mean_matches_the_reference_axis_name_path(both, leaf):
    ranks, (ref_out, ref_err), _ = both
    get = lambda tree: tree["a"] if leaf == "a" else tree["b"]["c"]
    for r, got in enumerate(ranks):
        want = np.asarray(get(ref_out))[r]
        err = np.abs(get(got["out"]) - want).max()
        assert err <= 1e-7 * np.abs(want).max(), (r, err)
        np.testing.assert_array_equal(get(got["err"]),
                                      np.asarray(get(ref_err))[r])
