"""Measured kernel time against the port's roofline model.

The port of ``repro/obs/kernelstats.py``.  Two feeds fill one table of
records keyed by ``(kind, dims, n, dtype, value_dtype, platform)``:

  * the **autotuner hook**: :func:`enable` installs
    ``kernels.autotune.set_obs_hook``, and every resolution of a launch
    lands here with its ``TuneResult``.  The tuner memoizes a resolution
    on the tables object, so the hook fires once per (tables, N, dtype) a
    process, where the reference's fires once per trace.  In measured mode
    (``REPRO_AUTOTUNE_MODE=measure``) the result's ``us_estimate`` is the
    median of CUDA-event timings of the chosen tile, so every such row has
    a measured time; rule-mode rows (the card's default) and the CPU's
    model-search rows carry the tile and the model's estimate only.  A
    row's ``n`` is the N the result describes (the N it was timed at in
    measured mode, the launch's N in rule mode, the N bucket of a model
    search), and its ``model_us`` the model at that N;
  * **direct measurement**: :func:`measure_op` times one product of an
    ``RBGP4Op`` or ``ChainOp`` (CUDA events on the card, ``perf_counter``
    on the CPU; warm-up excluded, median of reps) and prices the same
    shape through ``kernels.perf_model``, giving the roofline efficiency
    ``model_us / measured_us`` (1.0: at the model's bound).

:func:`device_kernels` reads the kernels a ``torch.profiler`` window
recorded on the card, for the drivers' and the card check's profiles.

``model_us`` is ``kernels.autotune.model_us``: the data-sheet roofline of
``kernels/perf_model.py`` (``estimate_chainmm`` for chain kinds), times
the expert count for stacked ones.

Layering: this module imports the kernels only inside functions, and the
autotuner never imports obs (the hook is a plain callable handed over at
:func:`enable`), so there is no import cycle and no cost when disabled.
"""
from __future__ import annotations

import dataclasses
import statistics
import threading
import time
from typing import Optional

from .metrics import SCHEMA_VERSION

__all__ = ["enable", "disable", "enabled", "reset",
           "records", "efficiency_table", "report",
           "measure_op", "format_table", "device_kernels", "KernelRecord",
           "MEASURE_KINDS"]

_lock = threading.Lock()
_enabled = False
_records: dict[tuple, "KernelRecord"] = {}


@dataclasses.dataclass
class KernelRecord:
    """One (kernel, shape, dtype, platform) entry in the roofline table."""

    kind: str
    dims: str
    n: int
    dtype: str
    value_dtype: str
    platform: str
    block_n: int = 0
    grid_order: str = ""
    source: str = ""   # "model" | "rule" | "measured" | "direct"
    tile: Optional[tuple] = None
    model_us: Optional[float] = None
    measured_us: Optional[float] = None
    resolutions: int = 0
    cache_hits: int = 0

    @property
    def efficiency(self) -> Optional[float]:
        if self.measured_us and self.model_us:
            return self.model_us / self.measured_us
        return None

    def to_row(self) -> dict:
        row = dataclasses.asdict(self)
        row["efficiency"] = self.efficiency
        return row


def _dims_sig(dims) -> str:
    try:
        return (f"m{dims.m}k{dims.k}tm{dims.tile_m}tk{dims.tile_k}"
                f"G{dims.group_rows}C{dims.chunk_cols}"
                f"do{dims.d_o}di{dims.d_i}")
    except AttributeError:
        return repr(dims)


def _model_us(dims, n: int, dtype: str, value_dtype: str, block_n: int,
              kind: str, experts: int = 1) -> Optional[float]:
    from repro_torch.kernels import autotune

    return autotune.model_us(kind, dims, n, dtype, value_dtype, block_n,
                             experts)


def _on_resolve(*, kind, dims, n, dtype, value_dtype=None, platform="",
                result=None, cached=False) -> None:
    vd = value_dtype or dtype
    n = int(result.n) if result is not None and result.n else int(n)
    key = (kind, _dims_sig(dims), n, dtype, vd, platform)
    with _lock:
        rec = _records.get(key)
        if rec is None:
            rec = _records[key] = KernelRecord(
                kind=kind, dims=key[1], n=n, dtype=dtype, value_dtype=vd,
                platform=platform)
        rec.resolutions += 1
        rec.cache_hits += int(bool(cached))
        if result is not None:
            rec.block_n = result.block_n
            rec.grid_order = result.grid_order
            rec.source = result.source
            rec.tile = result.tile
            if result.source == "measured" and result.us_estimate > 0:
                rec.measured_us = result.us_estimate
            rec.model_us = _model_us(dims, n, dtype, vd, result.block_n,
                                     kind, result.experts)


def enable() -> None:
    """Install the autotune hook; idempotent."""
    global _enabled
    from repro_torch.kernels import autotune

    with _lock:
        _enabled = True
    autotune.set_obs_hook(_on_resolve)


def disable() -> None:
    global _enabled
    from repro_torch.kernels import autotune

    autotune.set_obs_hook(None)
    with _lock:
        _enabled = False


def enabled() -> bool:
    return _enabled


def reset() -> None:
    with _lock:
        _records.clear()


def records() -> list:
    with _lock:
        return [_records[k] for k in sorted(_records)]


#: the products ``measure_op`` times, by autotuner kind: the token-major
#: forward (``rhs``, the reference's ``linear``) and dW, their stacked
#: forms, the feature-major O and dW (``RBGP4Op``), and the chain forward
#: and dW (``ChainOp``)
MEASURE_KINDS = ("rhs", "sddmm", "rhs_stacked", "sddmm_stacked", "lhs",
                 "sddmm_lhs", "chain_rhs", "chain_sddmm")


def _product(op, kind: str, n: int, dtype, n_experts: int, gen):
    """(launch closure, tables, value dtype) of one product of ``op`` on
    seeded operands."""
    import torch

    from repro_torch.kernels import (chain_sddmm_rhs, rbgp4_sddmm,
                                     rbgp4_sddmm_rhs, rbgp4_sddmm_rhs_stacked)

    dev, tables = op.device, op.tables
    d = op.dims

    def randn(*shape):
        return torch.randn(shape, generator=gen, dtype=torch.float32,
                           device=dev).to(dtype)

    if kind in ("rhs", "chain_rhs"):
        w, x = op.init_data(generator=gen, dtype=dtype), randn(n, d.k)
        return (lambda: op.linear(x, w)), tables, w.dtype
    if kind == "sddmm":
        g, x = randn(n, d.m), randn(n, d.k)
        return (lambda: rbgp4_sddmm_rhs(tables, g, x)), tables, dtype
    if kind == "chain_sddmm":
        g, x = randn(n, d.m), randn(n, d.k)
        return (lambda: chain_sddmm_rhs(tables, g, x)), tables, dtype
    if kind == "rhs_stacked":
        w = torch.stack([op.init_data(generator=gen, dtype=dtype)
                         for _ in range(n_experts)])
        x = randn(n_experts, n, d.k)
        return (lambda: op.linear_stacked(x, w)), tables, dtype
    if kind == "sddmm_stacked":
        g, x = randn(n_experts, n, d.m), randn(n_experts, n, d.k)
        return ((lambda: rbgp4_sddmm_rhs_stacked(tables, g, x)), tables,
                dtype)
    if kind == "lhs":
        w, x = op.init_data(generator=gen, dtype=dtype), randn(d.k, n)
        return (lambda: op.matmul(w, x)), tables, dtype
    if kind == "sddmm_lhs":
        g, x = randn(d.m, n), randn(d.k, n)
        return (lambda: rbgp4_sddmm(tables, g, x)), tables, dtype
    raise ValueError(f"kind {kind!r} not in {MEASURE_KINDS}")


def _time_us(fn, device, reps: int) -> float:
    """Median µs of ``reps`` calls of ``fn`` after one warm-up: CUDA
    events on the current stream on the card (the card spun first, so the
    events time its work and not the host's launch rate), ``perf_counter``
    on the CPU."""
    import torch

    fn()
    if device.type != "cuda":
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            ts.append(time.perf_counter() - t0)
        return statistics.median(ts) * 1e6
    from repro_torch.kernels import autotune

    stream = torch.cuda.current_stream(device)
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    torch.cuda.synchronize(device)
    with torch.cuda.device(device):
        torch.cuda._sleep(autotune.HOLD_CYCLES * 4)
    for start, end in ev:
        start.record(stream)
        fn()
        end.record(stream)
    torch.cuda.synchronize(device)
    return statistics.median(s.elapsed_time(e) for s, e in ev) * 1e3


def measure_op(op, n: int = 512, *, dtype=None, reps: int = 3,
               seed: int = 0, kind: Optional[str] = None,
               n_experts: int = 4) -> dict:
    """Fenced time of one product of ``op`` against the roofline model.

    ``kind`` (``MEASURE_KINDS``; by default ``rhs``, the reference's
    ``op.linear``, or ``chain_rhs`` for a ``ChainOp``) picks the product,
    run on seeded operands of N = ``n`` (rows an expert, ``n_experts``
    experts, for the stacked kinds) through the op's kernel wrappers: one
    warm-up, then the median of ``reps`` timings (CUDA events on the card,
    ``perf_counter`` on the CPU).  Records a ``source="direct"`` entry
    (kind ``direct_linear`` for ``rhs``, ``direct_<kind>`` otherwise) and
    returns its row.  Works whether or not :func:`enable` was called:
    calling it is the opt-in.
    """
    import torch

    from repro_torch.kernels import autotune

    if dtype is None:
        dtype = torch.float32
    if kind is None:
        kind = "chain_rhs" if getattr(op, "chain", False) else "rhs"
    gen = torch.Generator(device=op.device)
    gen.manual_seed(seed)
    with torch.no_grad():
        fn, tables, value_dtype = _product(op, kind, n, dtype, n_experts, gen)
        measured_us = _time_us(fn, op.device, reps)
    stacked = kind.endswith("_stacked")
    e = n_experts if stacked else 1
    tune = autotune.launch_tile(
        tables, kind, n, dtype,
        value_dtype if value_dtype != dtype else None, e)
    dtype_name = str(dtype).rpartition(".")[2]
    vd = str(value_dtype).rpartition(".")[2]
    model_us = _model_us(op.dims, n, dtype_name, vd, tune.block_n, kind, e)
    name = "direct_linear" if kind == "rhs" else f"direct_{kind}"
    key = (name, _dims_sig(op.dims), n, dtype_name, vd,
           autotune.platform_of(op.device))
    with _lock:
        rec = _records.get(key)
        if rec is None:
            rec = _records[key] = KernelRecord(
                kind=name, dims=key[1], n=n, dtype=dtype_name,
                value_dtype=vd, platform=key[5])
        rec.block_n = tune.block_n
        rec.tile = tune.tile
        rec.source = "direct"
        rec.measured_us = measured_us
        rec.model_us = model_us
        rec.resolutions += 1
    return rec.to_row()


def efficiency_table() -> list[dict]:
    """All records as rows; ``efficiency`` filled where measurements exist."""
    return [r.to_row() for r in records()]


def report() -> dict:
    """The JSON artifact a run embeds next to its timing rows."""
    rows = efficiency_table()
    measured = [r for r in rows if r["efficiency"] is not None]
    return {
        "schema_version": SCHEMA_VERSION,
        "enabled": _enabled,
        "n_records": len(rows),
        "n_measured": len(measured),
        "records": rows,
    }


def format_table(rows: Optional[list] = None) -> list[str]:
    """The drivers' roofline table, one line a row (the reference serve
    driver's format, with the tile)."""
    rows = efficiency_table() if rows is None else rows
    out = []
    for row in rows:
        model = (f"{row['model_us']:.1f}" if row["model_us"] is not None
                 else "-")
        meas = (f"{row['measured_us']:.1f}"
                if row["measured_us"] is not None else "-")
        eff = (f"{row['efficiency']:.2f}" if row["efficiency"] is not None
               else "-")
        tile = "x".join(str(t) for t in row["tile"]) if row["tile"] else "-"
        out.append(f"  {row['kind']:<16s} {row['dims']:<40s} n={row['n']:<6d}"
                   f" tile={tile:<9s} model={model}us measured={meas}us "
                   f"eff={eff} ({row['source']})")
    return out


def device_kernels(prof) -> list:
    """The kernels a ``torch.profiler.profile`` window recorded on the
    card, as (start ns, ms, name) in start order, read from the
    profiler's raw records.  Its event tree (``prof.events()``) holds the
    same kernels, but first parses every record, the CPU operators' too,
    into Python objects: minutes for a window of hundreds of thousands of
    launches, as an RWKV training step is."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    return sorted((e.start_ns(), e.duration_ns() * 1e-6, e.name())
                  for e in prof.profiler.kineto_results.events()
                  if e.device_type() == cuda)
