"""Serving meshes over ``torch.distributed``, and the process group under
them.

The port of ``repro/launch/mesh.py``.  A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` with dims ``("data",
"model")`` over the ranks of the default process group.  The port runs
SPMD: every rank runs the same program, and every rank builds every mesh
(a mesh's process groups are made by a collective call over the world),
a rank outside a mesh included; ``mesh.get_coordinate()`` is None there.

``init_distributed`` starts the default group: from ``RANK`` /
``WORLD_SIZE`` / ``LOCAL_RANK`` where ``torchrun`` (``python -m
torch.distributed.run``) set them, else at world size 1 on a ``file://``
store in a temporary directory.  NCCL for the card, gloo for
``device="cpu"``; rank r takes ``cuda:LOCAL_RANK``.

``make_production_mesh`` builds the dry-run's meshes, 16 x 16 and
2 x 16 x 16, over a default group of that world size (the dry-run's is a
``fake`` group, ``repro_torch.launch.dryrun``).  A function, not a
module-level constant: importing this module starts nothing.
"""
from __future__ import annotations

import os
import tempfile
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device

__all__ = ["init_distributed", "make_production_mesh", "make_local_mesh",
           "make_serve_mesh"]


def init_distributed(device=None) -> torch.device:
    """Start the default process group (once) and return this rank's
    device: ``cuda:LOCAL_RANK`` on the card, or the CPU."""
    dev = resolve_device(device)
    local = int(os.environ.get("LOCAL_RANK", "0"))
    if dev.type == "cuda":
        dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        backend = "nccl" if dev.type == "cuda" else "gloo"
        if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
            dist.init_process_group(backend, init_method="env://")
        else:
            store = os.path.join(tempfile.mkdtemp(prefix="repro_dist_"),
                                 "store")
            dist.init_process_group(backend, init_method=f"file://{store}",
                                    rank=0, world_size=1)
    return dev


def _device_type() -> str:
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_production_mesh(*, multi_pod: bool = False):
    """``("data", "model")`` 16 x 16, or ``("pod", "data", "model")``
    2 x 16 x 16, over the default group's ranks, which must number
    exactly as many."""
    from torch.distributed.device_mesh import DeviceMesh

    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    need = 1
    for n in shape:
        need *= n
    if not dist.is_initialized():
        raise RuntimeError(f"the production mesh needs a default process "
                           f"group of {need} ranks; none is up")
    have = dist.get_world_size()
    if have != need:
        raise ValueError(f"the {'x'.join(map(str, shape))} production mesh "
                         f"needs a world of {need} ranks, have {have}")
    arr = torch.arange(need, dtype=torch.int64).reshape(shape)
    return DeviceMesh(_device_type(), arr, mesh_dim_names=axes)


def make_local_mesh(model_parallel: int = 1):
    """``(world / model_parallel, model_parallel)`` over every rank."""
    n = dist.get_world_size()
    if n % model_parallel:
        raise ValueError(f"{n} devices not divisible by mp={model_parallel}")
    return make_serve_mesh(n // model_parallel, model_parallel)


def make_serve_mesh(dp: int = 1, tp: int = 1, ep: int = 1, *,
                    ranks: Optional[Sequence[int]] = None):
    """Serving mesh: ``("data", "model")`` with model = tp * ep.

    TP (heads, projection rows and slots) and EP (experts) share the
    "model" axis, as the sharding rules place them.  ``ranks`` selects an
    ordered subset of the world's ranks (the disaggregated engine's two
    roles); default all of them.  Every rank calls this with the same
    arguments."""
    from torch.distributed.device_mesh import DeviceMesh

    ranks = list(range(dist.get_world_size())) if ranks is None \
        else list(ranks)
    need = dp * tp * ep
    if dp < 1 or tp < 1 or ep < 1:
        raise ValueError(f"mesh dims dp={dp}, tp={tp}, ep={ep}")
    if len(ranks) < need:
        raise ValueError(
            f"mesh dp x tp x ep = {need} devices, have {len(ranks)}")
    arr = torch.tensor(ranks[:need], dtype=torch.int64).reshape(dp, tp * ep)
    return DeviceMesh(_device_type(), arr, mesh_dim_names=("data", "model"))
