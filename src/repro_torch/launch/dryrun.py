"""Multi-pod dry-run: trace every (arch x shape x mesh) cell on ``meta``.

The port of ``repro/launch/dryrun.py``.  For each cell this shows, with
no device:

  * that the distribution is coherent: ``shard_module`` cuts the model
    over the production mesh (``make_production_mesh``, 16 x 16 or
    2 x 16 x 16) and rank 0's program runs through it, every collective
    included;
  * the per-device memory: the program's arguments (its rank's
    parameters, training state, inputs and caches) and the peak of live
    bytes over the run (``repro_torch.analysis``);
  * the roofline terms from the op counts: dot FLOPs, bytes, and the
    collectives' bytes by kind.

The reference lowers and compiles on 512 placeholder CPU devices; the
port starts a ``fake`` process group of 256 or 512 ranks (in ``main()``,
never at import) and traces rank 0's eager program on ``meta`` tensors,
which have shapes and no storage: nothing touches CUDA.  That is the
dry-run's nature, not a fallback.  The cell's programs: ``model.loss``
forward and backward (with remat) and the sgdm update with clip 1.0
(``make_train_step``) for ``train``; ``model.prefill`` for ``prefill``;
``model.decode_step`` for ``decode``.  Batches are cut by
``batch_specs`` and caches by ``port_cache_specs`` (``long_context``
where ``seq_len > 100_000``).  Where the cache spec cuts a leaf otherwise
than the port's layer holds it (the cache length over "model" where the
kv heads do not divide it, as tinyllama's 4 over 16, which attention
holds whole; Mamba's ``h`` over d_state, or in a long-context cell its
d_inner over "data", and RWKV's ``state`` over the key index, where the
layer holds its channels or heads; RWKV's ``x_tm`` and ``x_cm`` over
d_model, which it holds whole), the program reads that leaf as its layer
holds it (gathered along the spec's cut dims, then narrowed to the
layer's own cut) and keeps the spec's share of what the layer writes
(the reverse): the arguments are the spec's, the gathers show in the
collectives and one layer's whole leaves in the peak.  The weights, and
a train cell's float32 masters and momentum, are cut over the data axes
where the spec says (FSDP, as the reference's ``param_sharding_tree``
places them), so ``argument_gb`` is the spec's bytes a device; each
weight is gathered whole where it is read (an all-gather, in the forward
and again in remat's recompute) and its gradient reduce-scattered in
rank order (the port's ``reduce_scatter_ordered``: an all-to-all, which
the op counter records as one).

The roofline constants are the NVIDIA H100 80GB HBM3's at 700.00 W
(``kernels.perf_model``: bf16 dense tensor-core peak and HBM3 rate, data
sheet) and one link rate, ``LINK_BW``.  A cell ``shard_module`` refuses
(a model axis that does not divide MLA's heads or a recurrent mixer's
channels) is written ``status: "skipped"`` with its reason (``Refused``,
raised around that call alone); any other exception, a
``NotImplementedError`` from an op without a ``meta`` kernel included,
is ``status: "error"`` and the exit code is 1.

Usage:
  python -m repro_torch.launch.dryrun --arch gemma-7b --shape train_4k --mesh single
  python -m repro_torch.launch.dryrun --all --mesh both --out results/dryrun.jsonl

``--mesh DxM`` (for example ``1x1``), ``--cell KIND,BATCH,SEQ`` and
``--layers N`` trace one program at another mesh, shape and depth (the
card's check of the reckoning, ``chip_smoke.py``); ``--save-hlo PATH``
writes the op records (JSON lines) in place of the reference's HLO text.
A recurrent scan is reckoned by one chunk of ``SCAN_CHUNK`` steps and its
trip count (``analysis.count_ops``'s ``scan_trips``), which keeps a
prefill_32k or train_4k cell of rwkv6-7b or jamba to about a minute on
the CPU.
"""
import argparse
import json
import os
import sys
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import (LM_SHAPES, ShapeConfig, TrainConfig,
                                 apply_sparsity, get_config, list_archs,
                                 shape_cells)
from repro_torch.kernels.perf_model import HBM_BW, PEAK_FLOPS

#: bytes/s of one link: NDR InfiniBand, 400 Gb/s a GPU (a model axis of 16
#: spans two 8-GPU NVLink nodes, so its collectives cross the network)
LINK_BW = 50e9
#: the storage backends the reference's dry-run traces (dense patterns
#: have no sparse layer)
BACKENDS = ("xla_masked",)

# ---------------------------------------------------------------------------


def _tree_leaves(obj) -> list:
    from torch.utils._pytree import tree_flatten

    return [t for t in tree_flatten(obj)[0] if isinstance(t, torch.Tensor)]


def active_param_count(cfg, model) -> tuple[int, int]:
    """(total_params, active_matmul_params) over the model's tensors by
    the reference's paths (the same rule as the reference's).

    Active = params participating in per-token matmuls: embedding tables
    excluded (gather), MoE expert stacks scaled by top_k / n_experts.
    """
    from repro_torch.parallel.sharding import reference_path
    from repro_torch.models.transformer import jax_stack_split

    split = jax_stack_split(cfg)
    total = active = 0
    for name, t in model.state_dict().items():
        n = t.numel()
        total += n
        path, _ = reference_path(cfg, name, split)
        if "embed" in path or "ba_o" in path or "ba_i" in path \
                or path.endswith("/mask") or "_mask" in path:
            continue
        if "experts/" in path:
            frac = cfg.moe.top_k / cfg.moe.n_experts
            active += int(n * frac)
        else:
            active += n
    return total, active


def attention_flops(cfg, shape) -> float:
    """Analytic *useful* attention FLOPs per forward pass (global).

    Causal-halved score+value matmuls per mixer kind; linear mixers (mamba,
    rwkv) count their state recurrences.  Combined with 2*N_active*D this is
    the MODEL_FLOPS denominator convention (PaLM-style MFU + attention).
    """
    B = shape.global_batch
    if shape.kind in ("train", "prefill"):
        S, L = shape.seq_len, shape.seq_len
    else:
        S, L = 1, shape.seq_len
    H, hd = cfg.n_heads, cfg.head_dim_
    total = 0.0
    for i in range(cfg.n_layers):
        kind = cfg.layer_kind(i)
        if kind == "attn":
            l_eff = L / 2 if S > 1 else L
            total += 4 * B * S * l_eff * H * hd
        elif kind == "swa":
            l_eff = min(cfg.sliding_window, L)
            total += 4 * B * S * l_eff * H * hd
        elif kind == "mla":
            m = cfg.mla
            l_eff = L / 2 if S > 1 else L
            # decompression + scores(dn+dr) + values(dv)
            total += 2 * B * L * H * m.kv_lora_rank * (
                m.nope_head_dim + m.v_head_dim)
            total += 2 * B * S * l_eff * H * (
                m.nope_head_dim + m.rope_head_dim + m.v_head_dim)
        elif kind == "mamba":
            mc = cfg.mamba
            di = mc.expand * cfg.d_model
            total += 6 * B * S * di * mc.d_state
        elif kind == "rwkv":
            hs = cfg.rwkv.head_size
            total += 4 * B * S * (cfg.d_model // hs) * hs * hs
    return total


def _mask_overhead_note(cfg) -> str:
    return (f"pattern={cfg.sparsity.pattern}@{cfg.sparsity.sparsity} "
            f"backend={cfg.sparsity.backend}")


def start_fake_group(world: int) -> None:
    """A ``fake`` default group of ``world`` ranks, this process rank 0
    (a fake group of another size is replaced); refuses where a real
    group is up."""
    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError(
                "a real process group is up: the dry-run traces on a fake "
                "group in a process of its own")
        if dist.get_world_size() == world:
            return
        dist.destroy_process_group()
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def make_mesh(shape: tuple, names: tuple):
    """A ``DeviceMesh`` of ``shape`` over the default group's ranks (the
    production meshes through ``make_production_mesh``)."""
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.launch.mesh import make_production_mesh

    if tuple(shape) in ((16, 16), (2, 16, 16)):
        return make_production_mesh(multi_pod=len(shape) == 3)
    arr = torch.arange(int(np.prod(shape))).reshape(shape)
    return DeviceMesh("cpu", arr, mesh_dim_names=names)


def _check_backend(cfg, model) -> None:
    from repro_torch.models.moe import StackedExperts
    from repro_torch.sparsity import SparseLinear

    for mod in model.modules():
        kernel = ((isinstance(mod, SparseLinear)
                   and mod.mode in ("compact", "chain"))
                  or (isinstance(mod, StackedExperts) and mod.compact))
        if kernel:
            raise ValueError(
                f"the dry-run traces the reference's backends {BACKENDS} "
                f"(and dense patterns); got backend "
                f"{cfg.sparsity.backend!r}, whose layers run the card's "
                f"kernels")


def _axis(mesh, ax):
    """The ``MeshAxis`` of a spec entry (None for None)."""
    from repro_torch.parallel.comm import MeshAxis
    from repro_torch.parallel.sharding import data_axis

    if ax is None:
        return None
    if isinstance(ax, tuple):
        return data_axis(mesh)
    return MeshAxis.of(mesh, ax)


def _cut_shape(shape, spec, sizes) -> tuple:
    out = []
    for d, ax in zip(shape, spec):
        n = int(np.prod([sizes[a] for a in ax])) if isinstance(ax, tuple) \
            else (sizes[ax] if ax is not None else 1)
        out.append(d // n)
    return tuple(out)


class Refused(Exception):
    """``shard_module`` refused the cell's model; the text is its reason."""


def build_program(cfg, shape: ShapeConfig, mesh, device="meta"):
    """(program, arguments, model): this rank's program of the cell, the
    tensors live before it (parameters, buffers, training state, inputs,
    caches) and the sharded model; on ``meta`` (the dry-run), or on a
    device, where the card runs the same program
    (``chip_smoke.py``'s check of the reckoning: zero caches, random
    tokens, weights from seed 0)."""
    from repro_torch.models import LMModel
    from repro_torch.parallel import batch_specs, shard_module
    from repro_torch.parallel.sharding import mesh_axes, port_cache_specs
    from repro_torch.train import init_train_state, make_train_step

    def _meta(shp, dtype):
        if dtype == torch.int32 and device != "meta":
            return torch.randint(0, cfg.vocab_size, shp, dtype=dtype,
                                 device=device)
        return torch.zeros(shp, dtype=dtype, device=device)

    model = LMModel(cfg, device=device, seed=0)
    _check_backend(cfg, model)
    try:
        shard_module(model, mesh)
    except NotImplementedError as e:   # heads or channels the axis splits
        raise Refused(str(e)) from e
    sizes = mesh_axes(mesh)
    B, S = shape.global_batch, shape.seq_len
    long_ctx = shape.kind == "decode" and S > 100_000
    tail = (cfg.n_codebooks,) if cfg.n_codebooks > 1 else ()
    own = [t for t in model.state_dict().values()]
    own += [b for b in model.buffers()]

    def inputs(seq, sharded=True):
        glob = {"tokens": (B, seq) + tail}
        if cfg.frontend == "vision" and shape.kind != "decode":
            glob["patch_embeds"] = (B, cfg.n_patches, cfg.d_model)
        specs = batch_specs(glob, mesh, batch_sharded=sharded)
        out = {}
        for k, shp in glob.items():
            dtype = torch.int32 if k == "tokens" else torch.bfloat16
            out[k] = _meta(_cut_shape(shp, specs[k], sizes), dtype)
        return out

    if shape.kind == "train":
        tcfg = TrainConfig(optimizer="sgdm", grad_clip=1.0, microbatches=1)
        state = init_train_state(model, tcfg)
        step = make_train_step(model, tcfg)
        batch = inputs(S)
        args = own + _tree_leaves(state.params) + _tree_leaves(
            state.opt_state) + list(batch.values())
        return (lambda: step(state, batch)), args, model

    # the cache: the spec's share of the global cache's leaves (a leaf
    # the spec cuts otherwise than its layer holds it is read through,
    # _SpecCache)
    whole = LMModel(cfg, device="meta").init_cache(B, S, torch.bfloat16)
    specs = port_cache_specs(cfg, whole, mesh, long_context=long_ctx)
    rows_ax = batch_specs({"t": (B,)}, mesh,
                          batch_sharded=not long_ctx)["t"][0]
    held = model.stack.init_cache(_cut_shape((B,), (rows_ax,), sizes)[0], S,
                                  torch.bfloat16, device="meta")
    shares, through = [], {}
    for i, (layer, lspec) in enumerate(zip(whole, specs)):
        leaves = {}
        for name, t in layer.items():
            spec = lspec[name]
            shp = _cut_shape(t.shape, spec, sizes)
            leaves[name] = (torch.full(shp, -1, dtype=t.dtype, device=device)
                            if name == "pos" else
                            torch.zeros(shp, dtype=t.dtype, device=device))
            # the layer's own cut: the rows on the batch axes, a dim it
            # holds a share of on "model"
            cut = tuple((rows_ax if d == 0 else "model") if h < w else None
                        for d, (h, w) in enumerate(zip(held[i][name].shape,
                                                       t.shape)))
            if cut != spec:
                through.setdefault(i, []).append((name, [
                    (d, _axis(mesh, a), _axis(mesh, b))
                    for d, (a, b) in enumerate(zip(spec, cut)) if a != b]))
        shares.append(leaves)
    del whole, held
    cache = _SpecCache(shares, through)

    args = own + _tree_leaves(shares)
    if shape.kind == "prefill":
        batch = inputs(S)
        args += list(batch.values())
        return (lambda: model.prefill(
            batch["tokens"], cache, patch_embeds=batch.get("patch_embeds"))), \
            args, model
    tok = inputs(1, sharded=not long_ctx)["tokens"]
    # the cell's 0-d index (the port's decode step reads it as a host int)
    args += [tok, torch.zeros((), dtype=torch.int32, device=device)]
    return (lambda: model.decode_step(tok, cache, S - 1)), args, model


def _recut(t: torch.Tensor, dims: list, src: int, dst: int):
    """``t`` cut as ``dims``' axes at ``src`` (0 or 1 of each (dim,
    axis, axis)) recut as those at ``dst``: gathered whole along every
    dim its cut names an axis, then narrowed to this rank's share along
    every dim the new cut names one."""
    from repro_torch.parallel.comm import gather_cat

    for d, *axes in dims:
        if axes[src] is not None:
            t = gather_cat(t, axes[src], d)
    for d, *axes in dims:
        if axes[dst] is not None:
            lo, hi = axes[dst].range(t.shape[d])
            t = t.narrow(d, lo, hi - lo)
    return t


class _SpecCache(list):
    """A cache held as the spec cuts it: the stack reads layer ``i``'s
    dict (``cache[i]``) with its ``through[i]`` leaves recut to what the
    layer holds (``(name, [(dim, spec's axis, layer's axis)])``, an axis
    None where that side keeps the dim whole), and writes it back
    (``cache[i] = c``) as this rank's share of the spec's cut, so one
    layer's whole leaves live at a time."""

    def __init__(self, shares: list, through: dict):
        super().__init__(shares)
        self.through = through

    def __getitem__(self, i):
        layer = super().__getitem__(i)
        if i not in self.through:
            return layer
        out = dict(layer)
        for name, dims in self.through[i]:
            out[name] = _recut(out[name], dims, 0, 1)
        return out

    def __setitem__(self, i, c):
        if i not in self.through:
            return super().__setitem__(i, c)
        share = super().__getitem__(i)
        for name, dims in self.through[i]:
            share[name].copy_(_recut(c[name], dims, 1, 0))


def reckon(cfg, shape: ShapeConfig, mesh, save_hlo: str = "") -> dict:
    """The record fields of one traced cell: trace_s, memory, op counts,
    collectives, model FLOPs and the roofline.  A recurrent scan is
    reckoned by one chunk of ``SCAN_CHUNK`` steps and its trip count
    (``analysis.OpCounter.repeated``)."""
    from repro_torch.analysis import count_ops, storage_bytes
    from repro_torch.models import LMModel
    from repro_torch.parallel import reset_collectives

    rec = {}
    t0 = time.time()
    program, args, model = build_program(cfg, shape, mesh)
    reset_collectives()
    _, ana = count_ops(program, arguments=args, module=model,
                       keep_records=bool(save_hlo), scan_trips=True)
    rec["trace_s"] = round(time.time() - t0, 1)
    rec["memory"] = {
        "argument_gb": ana.argument_bytes / 1e9,
        "temp_gb": ana.temp_bytes / 1e9,
        "peak_per_device_gb": ana.peak_bytes / 1e9,
        # of the arguments: the tensors the model derives and the
        # reference folds into its program (the RoPE frequencies)
        "constants_gb": storage_bytes(
            b for n, b in model.named_buffers()
            if n not in model.state_dict()) / 1e9,
    }
    flops_dev = ana.dot_flops  # matmul FLOPs (MFU convention)
    bytes_dev = ana.bytes_accessed
    rec["hlo_flops_per_device"] = flops_dev
    rec["hlo_all_flops_per_device"] = ana.flops
    rec["hlo_bytes_per_device"] = bytes_dev
    rec["hlo_unknown_trip_counts"] = ana.unknown_trip_counts
    coll = {
        "bytes": {k: float(v) for k, v in ana.collective_bytes.items()},
        "counts": dict(ana.collective_counts),
        "total_bytes": ana.total_collective_bytes,
    }
    rec["collectives"] = coll
    rec["top_dots"] = ana.top_dots(5)
    if save_hlo:
        with open(save_hlo, "w") as f:
            for r in ana.records:
                f.write(json.dumps(r) + "\n")

    total_p, active_p = active_param_count(cfg, LMModel(cfg, device="meta"))
    tokens = shape.global_batch * (shape.seq_len if shape.kind in
                                   ("train", "prefill") else 1)
    mult = 6 if shape.kind == "train" else 2
    model_flops_global = (
        mult * active_p * tokens
        + (mult / 2) * attention_flops(cfg, shape)
    )
    n_dev = dist.get_world_size()
    rec["model_flops_per_device"] = model_flops_global / n_dev
    rec["useful_flop_ratio"] = (
        model_flops_global / n_dev / flops_dev if flops_dev else None
    )
    terms = {
        "compute_s": flops_dev / PEAK_FLOPS,
        "memory_s": bytes_dev / HBM_BW,
        "collective_s": coll["total_bytes"] / LINK_BW,
    }
    rec["roofline"] = terms
    rec["bottleneck"] = max(terms, key=terms.get)
    return rec


def cell_config(arch: str, pattern: str, sparsity: float,
                layers: int = None):
    """The dry-run's config of ``arch`` (``layers`` cuts its depth)."""
    cfg = get_config(arch)
    if pattern != "dense":
        cfg = apply_sparsity(cfg, pattern=pattern, sparsity=sparsity,
                             backend="xla_masked", min_dim=1024)
    if layers:
        cfg = cfg.with_(n_layers=layers)
    return cfg.with_(param_dtype="bfloat16")


MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}


def mesh_of(name: str):
    """(shape, axis names) of ``single``, ``multi`` or ``DxM``."""
    if name in MESHES:
        return MESHES[name]
    return tuple(int(n) for n in name.split("x")), ("data", "model")


def run_cell(arch: str, shape_name: str, mesh_name: str, pattern: str,
             sparsity: float, save_hlo: str = "",
             shape: ShapeConfig = None, layers: int = None) -> dict:
    mshape, names = mesh_of(mesh_name)
    rec = {
        "arch": arch, "shape": shape_name,
        "mesh": "x".join(map(str, mshape)),
        "pattern": pattern, "sparsity": sparsity,
    }
    if layers:
        rec["layers"] = layers
    cfg = get_config(arch)
    cells = {s.name: (s, skip) for s, skip in shape_cells(cfg)}
    if shape is None:
        shape, skip = cells[shape_name]
        if skip:
            rec.update(status="skipped", reason=skip)
            return rec
    cfg = cell_config(arch, pattern, sparsity, layers)
    rec["note"] = _mask_overhead_note(cfg)
    start_fake_group(int(np.prod(mshape)))
    mesh = make_mesh(mshape, names)
    try:
        rec.update(reckon(cfg, shape, mesh, save_hlo))
    except Refused as e:
        rec.update(status="skipped", reason=str(e))
        return rec
    rec["status"] = "ok"
    return rec


def _parse_cell(text: str) -> ShapeConfig:
    kind, b, s = text.split(",")
    return ShapeConfig(f"{kind}_{b}x{s}", int(s), int(b), kind)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", type=str, default=None)
    ap.add_argument("--shape", type=str, default=None,
                    choices=[s.name for s in LM_SHAPES] + [None])
    ap.add_argument("--mesh", type=str, default="single",
                    help="single | multi | both | DxM")
    ap.add_argument("--cell", type=str, action="append", default=None,
                    help="KIND,BATCH,SEQ: a program of another shape "
                         "(repeatable)")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut each arch to this many layers")
    ap.add_argument("--pattern", type=str, default="rbgp4")
    ap.add_argument("--sparsity", type=float, default=0.75)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", type=str, default="results/dryrun.jsonl")
    ap.add_argument("--save-hlo", type=str, default="")
    ap.add_argument("--skip-done", action="store_true",
                    help="skip cells already recorded in --out (resume)")
    args = ap.parse_args()

    done = set()
    if args.skip_done and os.path.exists(args.out):
        for line in open(args.out):
            try:
                r = json.loads(line)
                if r.get("status") in ("ok", "skipped"):
                    done.add((r["arch"], r["shape"], r["mesh"]))
            except json.JSONDecodeError:
                pass

    archs = list_archs(lm_only=True) if args.all or not args.arch \
        else [args.arch]
    cells = {c.name: c for c in map(_parse_cell, args.cell or ())}
    if cells:
        shapes = list(cells)
    else:
        shapes = [s.name for s in LM_SHAPES] if args.all or not args.shape \
            else [args.shape]
    meshes = {"both": ["single", "multi"]}.get(args.mesh, [args.mesh])

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    n_fail = 0
    # one fake group a mesh size: the meshes outermost
    for mesh in meshes:
        tag = "x".join(map(str, mesh_of(mesh)[0]))
        for arch in archs:
            for shape in shapes:
                if (arch, shape, tag) in done:
                    continue
                t0 = time.time()
                try:
                    rec = run_cell(arch, shape, mesh, args.pattern,
                                   args.sparsity, args.save_hlo,
                                   cells.get(shape), args.layers)
                except Exception as e:  # a cell failure is a bug — record it
                    rec = {
                        "arch": arch, "shape": shape, "mesh": tag,
                        "status": "error",
                        "error": f"{type(e).__name__}: {e}",
                        "traceback": traceback.format_exc()[-2000:],
                    }
                    n_fail += 1
                rec["wall_s"] = round(time.time() - t0, 1)
                with open(args.out, "a") as f:
                    f.write(json.dumps(rec) + "\n")
                status = rec.get("status")
                extra = ""
                if status == "ok":
                    r = rec["roofline"]
                    extra = (f"bottleneck={rec['bottleneck']} "
                             f"c={r['compute_s']:.3f}s m={r['memory_s']:.3f}s "
                             f"coll={r['collective_s']:.3f}s "
                             f"mem/dev={rec['memory']['peak_per_device_gb']:.2f}GB")
                elif status == "error":
                    extra = rec["error"][:160]
                print(f"[{rec['wall_s']:7.1f}s] {arch:22s} {shape:12s} "
                      f"{rec['mesh']:8s} {status:8s} {extra}", flush=True)
    if dist.is_initialized():
        dist.destroy_process_group()
    sys.exit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
