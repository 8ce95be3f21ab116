"""Sharding rules over the serving mesh, and ``shard_module``.

The port of ``repro/parallel/sharding.py``.  Mesh axes: ``("data",
"model")`` single-pod, ``("pod", "data", "model")`` multi-pod; the batch
/ FSDP axes are ``("pod", "data")`` and TP / EP is ``"model"``.

``param_spec``, ``batch_specs``, ``cache_specs`` and ``page_pool_specs``
give, per tensor dim, ``None``, an axis name or a tuple of axis names:
the reference's ``PartitionSpec`` entries, from the same rule table, scan
offset and divisibility rule.  They take the reference's ``/`` paths (the
parameter tree's, the cache tree's) and a mesh: a ``DeviceMesh``, or a
dict of axis sizes such as ``{"data": 2, "model": 2}``; the trees' leaves
are tensors or shapes.  ``reference_path`` names a port parameter or
buffer by the reference's path (the map ``bridge.py`` loads by), and
``port_spec`` gives the spec over the port tensor's own dims (a scanned
layer's leading period dim dropped).

``shard_module(model, mesh)`` is the counterpart of
``param_sharding_tree`` + ``device_put`` (``repro/parallel/sharding.py:
107-118``): on every rank of ``mesh`` it keeps, in place, the rank's
share of each parameter along every dim the spec splits, and sets the
modules' descriptors (``parallel/tensor.py``) their forwards read.  Over
"model" that is tensor and expert parallelism; over the data axes (the
spec's ``("pod", "data")`` entries, flattened pod-major as ``data_axis``
orders them) it is FSDP, ZeRO-3 style: each weight, and so its master and
momentum in training, is held as a data rank's share, gathered whole
where it is read (``tensor.on_use``) and its gradient reduce-scattered
in rank order.  A dim is cut only where the axis divides the full dim
(the reference's rule), and the data axes never cut the dim the model
axis cuts, so a gathered weight is the model share the kernels take.
The share follows the spec but for:

  * compact storage: a model share is rows (column-parallel) or compact
    slots (row-parallel) that the kernels take as they are
    (``KernelTables.rank_slice``, in sub-groups and sub-slots where the
    share cuts a row group or a slot); the data axes cut the other dim
    (slots, or rows);
  * chain storage, cut as compact storage is (``ChainTables.rank_slice``:
    rows, or stored chunks);
  * int8 storage, which the reference's rules replicate (no rule names
    ``q_data``): it is cut over "model" as the ``w_data`` it stands for,
    its scales with it, and held whole on the data ranks.

MLA splits by head as the reference's rules do (``wq_b``'s rows, ``wk_b``
and ``wv_b``, ``wo``'s columns), with the latent whole on every rank:
``wq_a``'s and ``wkv_a``'s outputs are gathered (their norms run over the
whole rank dimension) and the compressed pools replicate.  Every
codebook's embedding is vocabulary-parallel, and so is the one head of
``n_codebooks * V`` rows over its flat rows.  The patch frontend has no
parameters of its own.  The recurrent mixers split by channel
(``RecurrentShard``): Mamba's d_inner and RWKV's heads, their
projections cut by the rules (Mamba's ``in`` and ``x`` and RWKV's
``r``, ``k``, ``v``, ``g``, ``o``, ``cmk``, ``cmr`` column-parallel,
``out`` and ``cmv`` row-parallel) and their per-channel tensors held
whole, as the rules replicate them; a model axis that does not divide
d_inner or the heads is refused, as MLA's heads are.  Their caches'
held cut (a rank's channels) is not the cut ``cache_specs`` names
(Mamba's ``h`` on d_state, RWKV's ``state`` on the key index, ``x_tm``
and ``x_cm`` on d_model), which the dry-run reads through.  The sharded
engines, paged only, refuse them with the reference's message.  Sharded
models serve and train (``train.make_train_step``; a compact or chain
share's dX runs on ``RankSlice.transpose``); int8 storage serves only,
as unsharded.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Optional

import numpy as np
import torch
from torch import nn

from .comm import MeshAxis
from .tensor import (DataShard, ExpertShard, HeadShard, LatentShard,
                     LinearShard, RecurrentShard, VocabShard)

__all__ = ["dp_axes", "dp_size", "data_axis", "mesh_axes", "param_spec",
           "batch_specs", "cache_specs", "port_cache_specs", "page_pool_specs",
           "reference_path", "port_spec", "Placement", "shard_module"]


def mesh_axes(mesh) -> dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` or of such a dict."""
    if isinstance(mesh, dict):
        return dict(mesh)
    return {n: mesh.size(i) for i, n in enumerate(mesh.mesh_dim_names)}


def dp_axes(mesh):
    """The data-parallel (batch/FSDP) axes of the mesh."""
    axes = tuple(a for a in mesh_axes(mesh) if a in ("pod", "data"))
    return axes if len(axes) > 1 else (axes[0] if axes else None)


def data_axis(mesh) -> MeshAxis:
    """The data-parallel axes of a ``DeviceMesh`` as one ``MeshAxis``:
    "data", or "pod" and "data" flattened (rank order: pod-major)."""
    names = [a for a in mesh.mesh_dim_names if a in ("pod", "data")]
    if len(names) == 1:
        return MeshAxis.of(mesh, names[0])
    flat = mesh[tuple(names)]._flatten()
    return MeshAxis(flat.get_group(), flat.get_local_rank(), flat.size())


def dp_size(mesh) -> int:
    sizes = mesh_axes(mesh)
    return int(np.prod([sizes[a] for a in sizes if a in ("pod", "data")]))


def _size(ax, sizes: dict) -> int:
    return int(np.prod([sizes[a] for a in (ax if isinstance(ax, tuple)
                                            else (ax,))]))


# (regex on path) -> spec builder, first match wins; 'F' = the fsdp axes,
# 'M' = the model axis, ("R",) replicated (``repro/parallel/sharding.py``)
_PARAM_RULES: list[tuple[str, tuple]] = [
    (r"ba_o|ba_i|_mask|/mask$", ("R",)),
    (r"norm|scale|bias|ln\d|gn_", ("R",)),
    (r"router", ("R",)),
    (r"mu_|mix_w1|mix_w2|decay_w1|decay_w2|/u$|w_base", ("R",)),
    (r"conv_w|conv_b|dt_w|dt_bias|a_log|/d$", ("R",)),
    # embeddings & LM head: (vocab, d_model)
    (r"embedding|head$", ("M", "F")),
    # MoE stacked experts: (E, h, d) / (E, d, h)
    (r"experts/(gate|up)", ("M", None, "F")),
    (r"experts/down", ("M", "F", None)),
    # MLA per-head up-projections (H, r, dn)
    (r"wk_b|wv_b", ("M", None, None)),
    # row-parallel (input on model): output projections back to d_model
    (r"(wo|down|cmv|out)/(w|w_data)", ("F", "M")),
    # column-parallel (output on model): everything else out of d_model
    (r"/(w|w_data|b)$", ("M", "F")),
]
_ROW_PARALLEL = re.compile(r"(wo|down|cmv|out)/(w|w_data)")


def param_spec(path: str, shape: tuple, mesh) -> tuple:
    """The spec of a parameter leaf (the reference's ``/`` path)."""
    sizes = mesh_axes(mesh)
    F = dp_axes(sizes)
    M = "model" if "model" in sizes else None
    stacked = path.startswith("stack/scan/") or "/scan/" in path
    spec: list = []
    for pattern, proto in _PARAM_RULES:
        if re.search(pattern, path):
            if proto != ("R",):
                spec = [{"F": F, "M": M, None: None}[p] for p in proto]
            break
    ndim = len(shape)
    if stacked:
        spec = [None] + spec  # leading period dim of scanned stacks
    spec = spec[:ndim]
    spec += [None] * (ndim - len(spec))
    # never shard a dim that the mesh axis doesn't divide
    return tuple(None if ax is None or dim % _size(ax, sizes) else ax
                 for dim, ax in zip(shape, spec))


def _is_leaf(x) -> bool:
    return hasattr(x, "shape") or (isinstance(x, tuple) and all(
        isinstance(d, (int, np.integer)) for d in x))


def _shape(x) -> tuple:
    return tuple(x.shape) if hasattr(x, "shape") else tuple(x)


def _tree_map(fn, tree, path: str = ""):
    """``fn(path, shape)`` over a nested dict/list tree of tensors or
    shapes, paths joined by ``/`` as the reference's ``path_str``; None
    stays None."""
    if tree is None:
        return None
    if _is_leaf(tree):
        return fn(path, _shape(tree))
    join = (lambda k: f"{path}/{k}") if path else str
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, join(k)) for k, v in tree.items()}
    return type(tree)(_tree_map(fn, v, join(i)) for i, v in enumerate(tree))


def batch_specs(tree, mesh, *, batch_sharded: bool = True):
    """Shard the leading batch dim of every batch leaf over the dp
    axes."""
    sizes = mesh_axes(mesh)
    F = dp_axes(sizes) if batch_sharded else None

    def one(_path, shape):
        spec = [None] * len(shape)
        if F is not None and shape and shape[0] % _size(F, sizes) == 0:
            spec[0] = F
        return tuple(spec)

    return _tree_map(one, tree)


def cache_specs(tree, mesh, *, long_context: bool):
    """Decode-cache specs.  Standard cells: batch over the dp axes,
    kv-heads / state channels over "model".  long_500k (batch 1): SP, the
    cache length over "data", heads/channels over "model".  Scanned
    caches carry a leading (n_periods,) dim: every logical dim shifts by
    one."""
    sizes = mesh_axes(mesh)
    F = dp_axes(sizes)
    f_size = _size(F, sizes)
    d_ax = "data" if "data" in sizes else None
    d_size = sizes.get("data", 1)
    m_size = sizes.get("model", 1)

    def model_dim(spec, shape, off, name, skip_pos):
        for d in (2 + off, 1 + off, 3 + off):
            if d < len(shape) and spec[d] is None and shape[d] % m_size == 0 \
                    and shape[d] >= m_size and not (skip_pos
                                                    and name.endswith("pos")):
                spec[d] = "model"
                break

    def one(name, shape):
        spec = [None] * len(shape)
        off = 1 if name.startswith("scan") else 0
        if not long_context:
            if off < len(shape) and shape[off] % f_size == 0:
                spec[off] = F
            model_dim(spec, shape, off, name, True)
            return tuple(spec)
        if name.endswith("pos") and len(shape) == 2 + off:
            if d_ax and shape[1 + off] % d_size == 0:
                spec[1 + off] = d_ax
            return tuple(spec)
        if len(shape) >= 2 + off and d_ax and shape[1 + off] % d_size == 0 \
                and shape[1 + off] > 4096:
            spec[1 + off] = d_ax
        model_dim(spec, shape, off, name, False)
        return tuple(spec)

    return _tree_map(one, tree)


def page_pool_specs(tree, mesh):
    """Specs of the serving page pools: only the true heads dim of a
    ``(n_blocks, page, H, hd)`` leaf (scanned: a leading T) shards over
    "model", where the axis divides it; the block dim stays replicated
    (any decode row may read any block) and so does everything else."""
    m_size = mesh_axes(mesh).get("model", 1)

    def one(name, shape):
        off = 1 if name.startswith("scan") else 0
        spec = [None] * len(shape)
        hd = 2 + off
        if (not name.endswith("pos") and len(shape) == 4 + off
                and shape[hd] >= m_size and shape[hd] % m_size == 0):
            spec[hd] = "model"
        return tuple(spec)

    return _tree_map(one, tree)


# ---------------------------------------------------------------------------
# the port's names, and shard_module
# ---------------------------------------------------------------------------

def reference_path(cfg, name: str, split: Optional[tuple] = None
                   ) -> tuple[str, bool]:
    """(the reference's ``/`` path, whether it is a scanned stacked leaf)
    of a port ``state_dict`` name, as ``bridge.flatten_jax_tree`` maps
    them; ``split`` is ``jax_stack_split(cfg)`` (computed if not
    given)."""
    parts = name.split(".")
    if parts[:2] != ["stack", "layers"]:
        return "/".join(parts), False
    if split is None:
        from repro_torch.models.transformer import jax_stack_split

        split = jax_stack_split(cfg)
    n_head, period, _n_full, tail_start = split
    i, rest = int(parts[2]), "/".join(parts[3:])
    if i < n_head:
        return f"stack/head/{i}/{rest}", False
    if i >= tail_start:
        return f"stack/tail/{i - tail_start}/{rest}", False
    return f"stack/scan/j{(i - n_head) % period}/{rest}", True


def port_spec(cfg, name: str, shape: tuple, mesh,
              split: Optional[tuple] = None) -> tuple:
    """``param_spec`` over a port tensor's own dims."""
    path, scanned = reference_path(cfg, name, split)
    if scanned:
        return param_spec(path, (1, *shape), mesh)[1:]
    return param_spec(path, tuple(shape), mesh)


def port_cache_specs(cfg, cache: list, mesh, *, long_context: bool) -> list:
    """``cache_specs`` over the port's per-layer cache (a list of dicts,
    ``LMModel.init_cache``): each leaf named by the reference's cache path
    (``head/<i>/k``, ``scan/j<j>/k``, ``tail/<i>/k``), a scanned layer's
    leading period dim dropped from its spec."""
    from repro_torch.models.transformer import jax_stack_split

    split = jax_stack_split(cfg)
    out = []
    for i, layer in enumerate(cache):
        specs = {}
        for name, t in layer.items():
            path, scanned = reference_path(cfg, f"stack.layers.{i}.{name}",
                                           split)
            path = path[len("stack/"):]
            shape = (1, *t.shape) if scanned else tuple(t.shape)
            spec = cache_specs({path: shape}, mesh,
                               long_context=long_context)[path]
            specs[name] = spec[1:] if scanned else spec
        out.append(specs)
    return out


def _names(ax) -> tuple:
    return () if ax is None else (ax if isinstance(ax, tuple) else (ax,))


def _is_data(ax) -> bool:
    return any(a in ("pod", "data") for a in _names(ax))


def _model_only(spec: tuple) -> tuple:
    """``spec`` with its data entries dropped (what a tensor held whole on
    the data ranks follows)."""
    return tuple(None if _is_data(ax) else ax for ax in spec)


@dataclasses.dataclass(frozen=True)
class Placement:
    """Where a rank's share of a tensor lies: ``spec`` (the reference's,
    over the port tensor's dims, that the port follows) and ``cut``, one
    (dim, lo, hi) a mesh axis that splits the tensor -- the range of the
    full tensor this rank's share reads along dim -- or None for the
    whole."""

    spec: tuple
    cut: Optional[tuple[tuple[int, int, int], ...]] = None

    @property
    def model_split(self) -> bool:
        return any("model" in _names(ax) for ax in self.spec)

    @property
    def data_split(self) -> bool:
        return any(_is_data(ax) for ax in self.spec)


def _cut(t: torch.Tensor, dim: int, index) -> torch.Tensor:
    """``t``'s entries ``index`` (a range, or a sequence) along ``dim`` in
    storage of their own (the whole tensor where they are all of it)."""
    if isinstance(index, range) and index.step == 1:
        if (index.start, index.stop) == (0, t.shape[dim]):
            return t
        return t.narrow(dim, index.start, len(index)).clone()
    return t.index_select(dim, torch.as_tensor(index, device=t.device))


class _Sharder:
    """One pass of ``shard_module`` over a model: cuts tensors in place
    and records each one's placement and cut."""

    def __init__(self, model, mesh):
        from repro_torch.models.transformer import jax_stack_split

        self.model = model
        self.mesh = mesh
        self.cfg = model.cfg
        self.split = jax_stack_split(self.cfg)
        self.m_ax = MeshAxis.of(mesh, "model")
        self.d_ax = data_axis(mesh)
        self.placements: dict[str, Placement] = {}
        self.cuts: dict[str, list] = {}

    def spec(self, name: str, shape) -> tuple:
        return port_spec(self.cfg, name, tuple(shape), self.mesh,
                         self.split)

    def keep(self, owner: nn.Module, attr: str, name: str, dim: int,
             index, spec: tuple) -> None:
        """Cut ``owner.<attr>`` (a parameter or buffer named ``name`` in
        the state_dict) to ``index`` (a range, or the full tensor's
        indices) along ``dim`` and record it beside its earlier cuts."""
        t = getattr(owner, attr)
        dim = dim % t.ndim
        new = _cut(t.data if isinstance(t, nn.Parameter) else t, dim, index)
        if isinstance(t, nn.Parameter):
            setattr(owner, attr, nn.Parameter(new,
                                              requires_grad=t.requires_grad))
        else:
            setattr(owner, attr, new)
        self.cuts.setdefault(name, []).append((dim, index))
        had = self.placements.get(name)
        cuts = (had.cut or ()) if had is not None else ()
        self.placements[name] = Placement(
            spec, cuts + ((dim, min(index), max(index) + 1),))

    def whole(self, name: str, spec: tuple) -> None:
        self.placements[name] = Placement(spec)

    # -- modules ---------------------------------------------------------
    def linear(self, name: str, lin) -> None:
        ax, n, r = self.m_ax, self.m_ax.size, self.m_ax.rank
        compact = lin.mode in ("compact", "chain")
        quant = compact and lin.quantized
        wkey = "w_data" if compact else "w"
        path, _ = reference_path(self.cfg, f"{name}.{wkey}", self.split)
        role = "row" if _ROW_PARALLEL.search(path) else "col"
        dim = 0 if role == "col" else 1
        held = lin.q_data if quant else getattr(lin, wkey)
        spec = self.spec(f"{name}.{wkey}", held.shape)
        if quant:
            spec = _model_only(spec)
        full = lin.out_features if role == "col" else lin.in_features
        lo, hi = ax.range(full)
        vkeys = ("q_data",) if quant else (wkey,)
        split = spec[dim] == "model"
        if not split:
            for key in vkeys:
                self.whole(f"{name}.{key}", spec)
            if quant:
                self.whole(f"{name}.scales",
                           self.spec(f"{name}.scales", lin.scales.shape))
        elif compact:
            # the spec split the values' dim, so n divides it (compact or
            # chain tables alike)
            rs = lin.tables.rank_slice("rows" if role == "col" else "slots",
                                       r, n)
            vdim = -2 if role == "col" else -1
            for key in vkeys:
                self.keep(lin, key, f"{name}.{key}", vdim,
                          range(rs.lo, rs.hi), spec)
            if quant:
                # the scales' own spec (the reference replicates them);
                # a part of a row group or slot keeps its block's scale
                self.keep(lin, "scales", f"{name}.scales", rs.scale_dim,
                          rs.scale_index,
                          self.spec(f"{name}.scales", lin.scales.shape))
            lin.tables = rs.tables
            lin.share = rs
            lin._tables_t = None
        else:
            self.keep(lin, "w", f"{name}.w", dim, range(lo, hi), spec)
            if lin.mode == "masked":
                m, k = lin.out_features, lin.in_features
                lin.mask_window = ((lo, hi, 0, k) if role == "col"
                                   else (0, m, lo, hi))
        if lin.b is not None:
            bspec = self.spec(f"{name}.b", lin.b.shape)
            if role == "col" and split:
                self.keep(lin, "b", f"{name}.b", 0, range(lo, hi), bspec)
            else:
                self.whole(f"{name}.b", bspec)
        lin.tp = LinearShard(role, ax, lo, hi, full, split,
                             whole_input=split and compact and role == "row")

    def experts(self, name: str, moe) -> None:
        ex = moe.experts
        lo, hi = self.m_ax.range(moe.moe.n_experts)
        base = f"{name}.experts"
        split = False
        for proj in ("gate", "up", "down"):
            if ex.compact:
                owner = getattr(ex, proj)
                keys = (("q_data", "scales") if ex.quantized
                        else ("w_data",))
                spec_name = f"{base}.{proj}.w_data"
            elif ex.masked:
                owner, keys = getattr(ex, proj), ("w",)
                spec_name = f"{base}.{proj}.w"
            else:
                owner, keys, spec_name = ex, (proj,), f"{base}.{proj}"
            values = getattr(owner, keys[0])
            spec = self.spec(spec_name, values.shape)
            if ex.quantized:
                spec = _model_only(spec)
            split = spec[0] == "model"
            for key in keys:
                leaf = f"{base}.{proj}" + (f".{key}" if owner is not ex
                                            else "")
                if key == "scales":
                    spec = self.spec(leaf, owner.scales.shape)
                if split:
                    self.keep(owner, key, leaf, 0, range(lo, hi), spec)
                else:
                    self.whole(leaf, spec)
        if split:
            moe.tp = ExpertShard(self.m_ax, lo, hi)

    def attention(self, attn) -> None:
        cfg, ax = self.cfg, self.m_ax
        H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
        # the projections' rows are gathered where the axis splits them
        # below a whole head (it divides the rows, not the heads)
        attn.tp = HeadShard(ax, ax.range(H), ax.range(Hkv),
                            kv_gather=Hkv % ax.size != 0
                            and (Hkv * hd) % ax.size == 0,
                            q_gather=H % ax.size != 0
                            and (H * hd) % ax.size == 0)

    def mla(self, name: str, attn) -> None:
        """This rank's heads of ``wk_b`` and ``wv_b`` (the spec splits
        their heads dim, which the axis divides); the projections are cut
        by ``linear`` (wq_b's rows and wo's columns by head)."""
        lo, hi = self._share_of(name, self.cfg.n_heads, "heads")
        for attr in ("wk_b", "wv_b"):
            leaf = f"{name}.{attr}"
            self.keep(attn, attr, leaf, 0, range(lo, hi),
                      self.spec(leaf, getattr(attn, attr).shape))
        attn.tp = LatentShard(self.m_ax, (lo, hi))

    def _share_of(self, name: str, n: int, what: str) -> tuple[int, int]:
        """This rank's contiguous share of ``n`` heads or channels that a
        module splits over "model"; refused where the axis does not
        divide them."""
        ax = self.m_ax
        if n % ax.size:
            raise NotImplementedError(
                f"{name}: {n} {what} do not split over model={ax.size}")
        return ax.range(n)

    def mamba(self, name: str, mixer) -> None:
        """This rank's channels of d_inner; the projections are cut by
        ``linear`` and the per-channel tensors held whole."""
        lo, hi = self._share_of(name, mixer.d_inner, "d_inner channels")
        mixer.tp = RecurrentShard(self.m_ax, lo, hi)

    def rwkv(self, name: str, block) -> None:
        """This rank's heads, as channels of d_model."""
        lo, hi = self._share_of(name, block.h, "heads")
        block.tp = RecurrentShard(self.m_ax, lo * block.hs, hi * block.hs)

    def vocab(self, owner, attr: str, name: str):
        t = getattr(owner, attr)
        spec = self.spec(name, t.shape)
        if spec[0] != "model":
            self.whole(name, spec)
            return None
        lo, hi = self.m_ax.range(t.shape[0])
        self.keep(owner, attr, name, 0, range(lo, hi), spec)
        return VocabShard(self.m_ax, lo, hi)

    def data(self) -> dict:
        """Cut every tensor whose spec has a data entry to this data
        rank's share along that dim (the model pass kept that dim whole)
        and return {module: DataShard} for the reads to gather by."""
        dims: dict = {}
        for name, p in list(self.placements.items()):
            if not p.data_split:
                continue
            (dim,) = [d for d, ax in enumerate(p.spec) if _is_data(ax)]
            owner_name, _, attr = name.rpartition(".")
            owner = self.model.get_submodule(owner_name)
            lo, hi = self.d_ax.range(getattr(owner, attr).shape[dim])
            self.keep(owner, attr, name, dim, range(lo, hi), p.spec)
            dims.setdefault(owner, {})[attr] = dim
        return {owner: DataShard(self.d_ax, d) for owner, d in dims.items()}


def shard_module(model, mesh):
    """Keep this rank's share of ``model`` (an ``LMModel``) over ``mesh``,
    in place, and return it.  ``model.placements`` maps every
    ``state_dict`` name to its ``Placement``; ``model.rank_slices`` the
    cut ones to their cuts, one (dim, index) a mesh axis that splits the
    tensor, each the entries along dim the share holds (the model cut's
    of the full tensor, the data cut's of what the model cut left; the
    two never share a dim), which ``bridge.load_jax_params`` applies to
    the reference's full tree.  Every rank of the mesh calls it on the
    same model (the same seed or the same loaded weights)."""
    from repro_torch.models.attention import GQAttention, MLAttention
    from repro_torch.models.moe import MoELayer
    from repro_torch.models.rwkv import RWKVBlock
    from repro_torch.models.ssm import MambaMixer
    from repro_torch.sparsity import SparseLinear

    if mesh.get_coordinate() is None:
        raise ValueError("this rank is not in the mesh")
    if getattr(model, "mesh", None) is not None:
        raise ValueError("the model is sharded already")
    s = _Sharder(model, mesh)
    for name, mod in model.named_modules():
        if isinstance(mod, SparseLinear):
            s.linear(name, mod)
        elif isinstance(mod, GQAttention):
            s.attention(mod)
        elif isinstance(mod, MLAttention):
            s.mla(name, mod)
        elif isinstance(mod, MoELayer):
            s.experts(name, mod)
        elif isinstance(mod, MambaMixer):
            s.mamba(name, mod)
        elif isinstance(mod, RWKVBlock):
            s.rwkv(name, mod)
    for i, emb in enumerate(model.embed):
        emb.tp = s.vocab(emb, "embedding", f"embed.{i}.embedding")
    if model.head is not None:
        model.head_tp = s.vocab(model, "head", "head")
    for name, t in model.state_dict().items():
        if name not in s.placements:
            s.whole(name, s.spec(name, t.shape))
    for owner, ds in s.data().items():
        owner.fsdp = ds
    for name, p in s.placements.items():
        if (p.model_split or p.data_split) and p.cut is None:
            raise AssertionError(f"{name}: split by the spec, kept whole")
    model.dp = MeshAxis.of(mesh, "data")
    model.data_axis = s.d_ax
    model.mesh = mesh
    model.placements = s.placements
    model.rank_slices = s.cuts
    return model
