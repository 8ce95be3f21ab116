"""Activation layouts under a mesh.

The port of ``repro/parallel/constrain.py``.  ``activation_mesh(mesh)``
installs a mesh for the code under it and ``current_mesh()`` reads it
(``MoELayer`` takes its routing groups from it).  Eager torch has no
layout to pin, so ``shard(shape, *spec)`` says where the reference's
``with_sharding_constraint`` would put an activation of ``shape``: one
entry per dim, ``None`` or the axis (or tuple of axes) the logical axis
resolves to: 'dp' the data-parallel axes (pod + data), 'tp' the model
axis.  Axes that do not divide the dim, or that an earlier dim took, are
dropped, as there; with no mesh installed it returns None.
"""
from __future__ import annotations

import contextlib
from typing import Optional

import numpy as np

from .sharding import mesh_axes

__all__ = ["activation_mesh", "current_mesh", "shard"]

_MESH = None


@contextlib.contextmanager
def activation_mesh(mesh):
    global _MESH
    prev = _MESH
    _MESH = mesh
    try:
        yield
    finally:
        _MESH = prev


def current_mesh():
    return _MESH


def _resolve(axis, sizes: dict):
    if axis is None:
        return None
    if axis == "dp":
        axes = tuple(a for a in sizes if a in ("pod", "data"))
        if not axes:
            return None
        return axes if len(axes) > 1 else axes[0]
    if axis == "tp":
        return "model" if "model" in sizes else None
    return axis


def shard(shape, *spec) -> Optional[tuple]:
    """The layout the reference's ``shard(x, *spec)`` pins an activation
    of ``shape`` (a tensor or its shape) to under the installed mesh, or
    None without one."""
    mesh = _MESH
    if mesh is None:
        return None
    shape = tuple(shape.shape) if hasattr(shape, "shape") else tuple(shape)
    sizes = mesh_axes(mesh)
    out: list = []
    used: set = set()
    for dim, ax in zip(shape, spec):
        r = _resolve(ax, sizes)
        if r is None:
            out.append(None)
            continue
        names = r if isinstance(r, tuple) else (r,)
        size = int(np.prod([sizes[n] for n in names]))
        if any(n in used for n in names) or dim % size or dim < size:
            out.append(None)
            continue
        used.update(names)
        out.append(r)
    return tuple(out + [None] * (len(shape) - len(out)))
