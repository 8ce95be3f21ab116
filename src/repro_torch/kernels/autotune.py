"""Launch-configuration autotuner of the port's hand-written kernels.

The port of ``repro/kernels/autotune.py`` for the H100.  Every kernel
wrapper of ``kernels/rbgp4mm.py`` and ``kernels/chainmm.py`` resolves its
launch here (``launch_tile``) before it launches, and takes the ``tile``
of the ``TuneResult``: the built tile that the body of that kind launches.
The tuner keys a launch on ``(kind, KernelDims, N bucket, dtype,
value_dtype, platform)``, with the body (``mma``, ``fma`` or the int8
``q``), a ``.t`` mark on the kind for transposed tables and the expert
count of a stacked launch, and keeps the winner in

  * an in-process dict, and before it a memo on the tables object keyed
    by (kind, N, dtype, value dtype, experts), so a launch that was
    resolved once costs one dict lookup (a generation counter, bumped by
    ``set_cache_path``, ``clear_memory_cache`` and
    ``set_plan_fingerprint``, invalidates the memo);
  * a persistent JSON cache on disk (``{"schema": CACHE_SCHEMA,
    "entries": {key: TuneResult}}``, written by atomic replace).

The cache path is ``$REPRO_AUTOTUNE_CACHE`` when set (the drivers'
``--autotune-cache``), else ``~/.cache/repro-rbgp4-torch/autotune.json``,
so the port never reads the reference's file; ``set_cache_path``
overrides both.  An unwritable path degrades to the in-process cache.

Kinds, each with its own entries (the reference resolves its stacked
kernels under ``rhs`` and ``sddmm``; here the stacked and unstacked bodies
build different tiles, so a shared entry could hand a body a tile it does
not build):

  ``rhs``            ``rbgp4mm_rhs``, forward and dX (``rhs.t``): 128 tokens
                     a block (the one tile of its tensor-core body);
  ``rhs_stacked``    ``rbgp4mm_rhs_stacked``: 64 or 128 tokens a block;
  ``sddmm``          ``rbgp4_sddmm_rhs``: (block_cols, 128) for the
                     block_cols in (128, 64, 32, 16) that divide C;
  ``sddmm_stacked``  ``rbgp4_sddmm_rhs_stacked``: ``STACKED_SDDMM_TILES``;
  ``lhs``            ``rbgp4mm``, O and dI (``lhs.t``): ``FM_MMA_TILES``;
  ``sddmm_lhs``      ``rbgp4_sddmm``: (block_cols, 64), block_cols in
                     ``FM_SDDMM_TILES``;
  ``chain_rhs``      ``chainmm_rhs``, forward and dX: 32 or 64 class rows;
  ``chain_sddmm``    ``chain_sddmm_rhs``: (64, waves), the token slices
                     that bring the grid to 1, 2 or 4 waves.

A launch on an FMA body (float32, decode under ``MMA_MIN_TOKENS``, the
small leaves) or an int8 path has one candidate, the empty tile ``()``:
those bodies size their blocks themselves.

Modes:

  * **model** (the default).  On the card it returns the fixed rule's
    tile at the launch's real N (``source="rule"``; nothing is searched or
    stored), so no launch changes unless measurement is asked for; its
    ``us_estimate`` is the ``perf_model`` estimate.  On the CPU, where the
    plain versions take no tile, it runs the reference's model search
    (``_search_model``) over the port's ``perf_model``, pruned by the
    Hopper shared-memory bound in place of the reference's VMEM bound,
    and stores the result, as the reference does.
  * **measure** (``REPRO_AUTOTUNE_MODE=measure``, on ``cuda`` only; on
    the CPU it raises).  Every candidate tile is launched on the real
    tables of the launch (its ``col0``/class tables, its expert count,
    forward or transposed), on operands drawn from a seeded
    ``torch.Generator``: one warm-up launch, then the median of
    ``MEASURE_REPS`` launches timed by CUDA events on the current stream.
    The fastest is stored under the N bucket with the N it was timed at.
    A candidate whose launch fails is dropped; if none launches, the
    resolution raises (there is no fallback to a plain version).  The
    mode is read when a launch is first resolved: call
    ``clear_memory_cache()`` after changing it inside a process.

One entry always gives one tile, and a dW tile fixes the order of its
slice sums, so one entry gives the same bits on every launch at one N on
one card (the slice plan also depends on the card's SM count).  Entries
are validated on a hit against the candidates of the launch, so a corrupt
entry triggers a search and never a bad launch.

The obs hook (``set_obs_hook``, installed by ``obs.kernelstats``) fires
once per resolution: with the memo, once per (tables, N, dtype) a process.
"""
from __future__ import annotations

import dataclasses
import json
import os
import statistics
import threading
from typing import Callable, Optional

import torch

from .perf_model import estimate_chainmm, estimate_rbgp4mm_dims

__all__ = [
    "TuneResult",
    "KindSpec",
    "register_kind",
    "resolve",
    "autotune",
    "launch_tile",
    "cache_path",
    "set_cache_path",
    "set_plan_fingerprint",
    "plan_fingerprint",
    "clear_memory_cache",
    "candidate_block_ns",
    "candidate_tiles",
    "rule_tile",
    "set_obs_hook",
    "platform_of",
    "smem_budget_bytes",
    "model_us",
    "mode",
]

# Token-tile widths the CPU's model search considers (clipped by n and
# the shared-memory bound), the reference's.
BLOCK_N_CANDIDATES = (128, 256, 512, 1024, 2048)
GRID_ORDERS = ("nm", "mn")
#: shared memory a block may opt into on an H100 (227 KB), the bound that
#: takes the place of the reference's VMEM budget; on the card
#: ``smem_budget_bytes`` reads it from the device
SMEM_BUDGET_BYTES = 227 * 1024
MEASURE_REPS = 5
MEASURE_SEED = 0
#: cycles the card spins before a candidate's timed launches, so that the
#: events time the card's work and not the host's launch rate (about 1 ms)
HOLD_CYCLES = 2_000_000
#: the tile of an FMA body or an int8 path, which size their blocks
#: themselves
FMA_TILE: tuple = ()

_DTYPE_BYTES = {"float32": 4, "bfloat16": 2, "float16": 2, "float64": 8,
                "int8": 1, "uint8": 1}
_TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                 "float16": torch.float16, "float64": torch.float64,
                 "int8": torch.int8}
_DTYPE_NAMES = {v: k for k, v in _TORCH_DTYPES.items()}

# Persistent-cache layout version: bump whenever the key format or the
# entry semantics change, so stale files re-search instead of mis-hitting
# (the reference's v2 has no tile; v3 entries carry the built tile, the N
# they were timed at and the expert count).
CACHE_SCHEMA = 3


@dataclasses.dataclass(frozen=True)
class TuneResult:
    """One resolved launch configuration.  ``tile`` is the built tile the
    body launches (``()`` for an FMA body or an int8 path; None for the
    CPU's model search, whose plain versions take none); ``block_n`` the
    tokens a block covers (the model's N-tile); ``n`` the N the result was
    resolved or timed at, ``experts`` the stacked launch's expert count."""

    block_n: int
    grid_order: str = "nm"
    us_estimate: float = 0.0
    source: str = "model"  # "model" | "rule" | "measured"
    tile: Optional[tuple] = None
    n: int = 0
    experts: int = 1

    def to_json(self) -> dict:
        d = dataclasses.asdict(self)
        if self.tile is not None:
            d["tile"] = list(self.tile)
        return d

    @classmethod
    def from_json(cls, d: dict) -> "TuneResult":
        kw = {f.name: d[f.name] for f in dataclasses.fields(cls)
              if f.name in d}
        if kw.get("tile") is not None:
            kw["tile"] = tuple(int(t) for t in kw["tile"])
        return cls(**kw)


@dataclasses.dataclass(frozen=True)
class KindSpec:
    """What the tuner needs of one kernel kind, registered by the module
    that launches it (``rbgp4mm.py``, ``chainmm.py``), so this module
    imports no kernel:

    ``path(dims, n, dtype)``   the body, "mma" or "fma";
    ``rule(tables, n)``        today's fixed rule's tile of the mma body;
    ``tiles(tables)``          the mma tiles the launcher builds;
    ``block_n(tables, tile, n, experts)``  tokens a block covers;
    ``operands(tables, n, experts, dtype, value_dtype, generator)``
                               seeded operands of one launch;
    ``launch(tables, body, tile, operands)``  one launch of body
                               ("mma", "fma" or "q") with ``tile``,
                               counted nowhere."""

    name: str
    path: Callable
    rule: Callable
    tiles: Callable
    block_n: Callable
    operands: Callable
    launch: Callable


_KINDS: dict[str, KindSpec] = {}
#: every measured search of this process, in order: its kind (``.t`` on
#: transposed tables), dims, N, experts, body, each candidate's median µs
#: (``timings``, tile -> µs) and the tile kept
measured_searches: list[dict] = []


def register_kind(spec: KindSpec) -> None:
    _KINDS[spec.name] = spec


# ---------------------------------------------------------------------------
# cache
# ---------------------------------------------------------------------------

_mem_cache: dict[str, TuneResult] = {}
_disk_loaded = False
_cache_path_override: Optional[str] = None
_lock = threading.Lock()
# bumped whenever a memoized resolution may have gone stale
_generation = 0


def _invalidate_locked() -> None:
    global _disk_loaded, _generation
    _mem_cache.clear()
    _disk_loaded = False
    _generation += 1


def cache_path() -> str:
    if _cache_path_override is not None:
        return _cache_path_override
    env = os.environ.get("REPRO_AUTOTUNE_CACHE")
    if env:
        return env
    return os.path.join(os.path.expanduser("~"), ".cache",
                        "repro-rbgp4-torch", "autotune.json")


def set_cache_path(path: Optional[str]) -> None:
    """Point the persistent cache at ``path`` (None restores the default).

    Clears the in-memory cache and the memos, so the next resolve re-reads
    from disk."""
    global _cache_path_override
    with _lock:
        _cache_path_override = path
        _invalidate_locked()


def clear_memory_cache() -> None:
    """Drop the in-process cache and the memos (the disk cache is
    untouched)."""
    with _lock:
        _invalidate_locked()


# Observability hook: a callable invoked on every resolution (cache hit,
# rule or fresh search) with keyword args (kind, dims, n, dtype,
# value_dtype, platform, result, cached).  Installed by
# repro_torch.obs.kernelstats.enable(); a plain callable so that this
# module never imports obs.
_obs_hook: Optional[Callable[..., None]] = None


def set_obs_hook(fn: Optional[Callable[..., None]]) -> None:
    global _obs_hook
    _obs_hook = fn


def _notify(kind, dims, nb, dtype, value_dtype, platform, result,
            cached: bool) -> None:
    hook = _obs_hook
    if hook is None:
        return
    try:
        hook(kind=kind, dims=dims, n=nb, dtype=dtype,
             value_dtype=value_dtype, platform=platform, result=result,
             cached=cached)
    except Exception:
        pass   # observability must never break a kernel launch


_plan_fingerprint: Optional[str] = None


def set_plan_fingerprint(fp: Optional[str]) -> None:
    """Scope subsequent cache entries to one ``SparsityPlan.fingerprint()``
    (the drivers call it under ``--plan``): two plans with equal dims but
    other adjacency time differently, and each keeps its own measured
    entries.  ``None`` restores the unscoped namespace."""
    global _plan_fingerprint
    with _lock:
        _plan_fingerprint = fp
        _invalidate_locked()


def plan_fingerprint() -> Optional[str]:
    return _plan_fingerprint


def _load_disk_locked() -> None:
    global _disk_loaded
    if _disk_loaded:
        return
    _disk_loaded = True
    try:
        with open(cache_path()) as f:
            data = json.load(f)
    except (OSError, ValueError):
        return  # missing / unreadable cache degrades to a fresh search
    if not isinstance(data, dict) or data.get("schema") != CACHE_SCHEMA:
        return  # stale layout: re-search everything
    entries = data.get("entries")
    if not isinstance(entries, dict):
        return
    for key, entry in entries.items():
        try:
            _mem_cache.setdefault(key, TuneResult.from_json(entry))
        except (KeyError, TypeError, ValueError, AttributeError):
            continue  # a corrupt entry is searched again


def _store(key: str, result: TuneResult) -> None:
    with _lock:
        _mem_cache[key] = result
        path = cache_path()
        try:
            try:
                with open(path) as f:
                    data = json.load(f)
            except (OSError, ValueError):
                data = {}
            if (not isinstance(data, dict)
                    or data.get("schema") != CACHE_SCHEMA
                    or not isinstance(data.get("entries"), dict)):
                data = {"schema": CACHE_SCHEMA, "entries": {}}
            data["entries"][key] = result.to_json()
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            tmp = f"{path}.tmp.{os.getpid()}"
            with open(tmp, "w") as f:
                json.dump(data, f, indent=0, sort_keys=True)
            os.replace(tmp, path)
        except OSError:
            pass  # read-only file system: the in-memory cache still works


# ---------------------------------------------------------------------------
# platform, bounds, candidates
# ---------------------------------------------------------------------------

def mode() -> str:
    """``"measure"`` under ``REPRO_AUTOTUNE_MODE=measure``, else
    ``"model"``."""
    return ("measure" if os.environ.get("REPRO_AUTOTUNE_MODE") == "measure"
            else "model")


def platform_of(device=None) -> str:
    """``cuda-sm<major><minor>`` for a CUDA device (``cuda-sm90`` on an
    H100), else the device's type (``cpu``); with no device, the card if
    there is one."""
    if device is None:
        device = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    device = torch.device(device)
    if device.type == "cuda":
        major, minor = torch.cuda.get_device_capability(device)
        return f"cuda-sm{major}{minor}"
    return device.type


_smem_budget: Optional[int] = None


def smem_budget_bytes() -> int:
    """Shared memory one block may use: the card's opt-in maximum where
    CUDA is present, else ``SMEM_BUDGET_BYTES``."""
    global _smem_budget
    if _smem_budget is None:
        budget = SMEM_BUDGET_BYTES
        if torch.cuda.is_available():
            props = torch.cuda.get_device_properties(0)
            budget = int(getattr(props, "shared_memory_per_block_optin",
                                 budget) or budget)
        _smem_budget = budget
    return _smem_budget


def _n_bucket(n: int) -> int:
    """Round n up to a power of two so cache keys stay bounded."""
    b = 16
    while b < n:
        b *= 2
    return b


def _body(kind: str, dims, n: int, dtype: str,
          value_dtype: Optional[str]) -> str:
    """The body a launch takes: "q" (an int8 path), else its kind's
    ``path`` ("mma" or "fma"); "" for a kind nothing registered."""
    if value_dtype == "int8" and dtype != "int8":
        return "q"
    spec = _KINDS.get(kind)
    dt = _TORCH_DTYPES.get(dtype)
    if spec is None or dt is None:
        return ""
    return spec.path(dims, n, dt)


def _key(kind: str, dims, n_bucket: int, dtype: str, platform: str,
         value_dtype: Optional[str] = None, *, transposed: bool = False,
         body: str = "", n_experts: int = 1) -> str:
    plan = f"plan{_plan_fingerprint}|" if _plan_fingerprint else ""
    mark = ".t" if transposed else ""
    tail = f"|{body}" if body else ""
    if n_experts != 1:
        tail += f"|e{n_experts}"
    return (
        f"{plan}{kind}{mark}|{platform}|{dtype}|w{value_dtype or dtype}"
        f"|m{dims.m}k{dims.k}"
        f"tm{dims.tile_m}tk{dims.tile_k}G{dims.group_rows}C{dims.chunk_cols}"
        f"do{dims.d_o}di{dims.d_i}|n{n_bucket}{tail}"
    )


def candidate_block_ns(dims, n: int, dtype: str,
                       value_dtype: Optional[str] = None) -> list[int]:
    """Feasible block_n values of the model search: <= padded n, and a
    working set (f32 accumulator, double-buffered input, W strip and
    output blocks) within the shared-memory bound."""
    el = _DTYPE_BYTES.get(dtype, 4)
    w_el = _DTYPE_BYTES.get(value_dtype or dtype, 4)
    dcols = dims.d_i * dims.chunk_cols
    budget = smem_budget_bytes()
    out = []
    for bn in BLOCK_N_CANDIDATES:
        if bn > max(_n_bucket(n), BLOCK_N_CANDIDATES[0]):
            break
        working_set = (
            bn * dims.tile_m * 4                      # f32 accumulator
            + 2 * bn * dims.tile_k * el               # x block, double-buffered
            + 2 * dims.tile_m * dims.d_o * dcols * w_el  # w row strip
            + 2 * bn * dims.tile_m * el               # out block
        )
        if working_set <= budget:
            out.append(bn)
    if not out:
        out = [BLOCK_N_CANDIDATES[0]]
    return out


def rule_tile(kind: str, tables, n: int, dtype: torch.dtype,
              value_dtype: Optional[torch.dtype] = None) -> tuple:
    """Today's fixed rule's tile for a launch: the mma body's rule, or
    ``FMA_TILE`` for an FMA body or an int8 path."""
    spec = _KINDS[kind]
    if value_dtype == torch.int8 or spec.path(tables.dims, n,
                                              dtype) != "mma":
        return FMA_TILE
    return tuple(spec.rule(tables, n))


def candidate_tiles(kind: str, tables, n: int, dtype: torch.dtype,
                    value_dtype: Optional[torch.dtype] = None
                    ) -> tuple[tuple, ...]:
    """The tiles the launcher of ``kind`` accepts for this launch, the
    rule's first (so a tie keeps it): every built tile of the mma body, or
    ``FMA_TILE`` alone."""
    rule = rule_tile(kind, tables, n, dtype, value_dtype)
    if rule == FMA_TILE:
        return (FMA_TILE,)
    rest = tuple(tuple(t) for t in _KINDS[kind].tiles(tables)
                 if tuple(t) != rule)
    return (rule,) + rest


def model_us(kind: str, dims, n: int, dtype: str, value_dtype: str,
             block_n: int, experts: int = 1) -> Optional[float]:
    """The ``perf_model`` time of one launch, in µs: the chain model for
    chain kinds, ``experts`` times one expert's for stacked ones."""
    est_fn = (estimate_chainmm if kind.startswith("chain")
              else estimate_rbgp4mm_dims)
    el = _DTYPE_BYTES.get(dtype, 4)
    w_el = _DTYPE_BYTES.get(value_dtype, el)
    try:
        est = est_fn(dims, max(int(n), 1), bytes_per_el=el,
                     block_n=max(int(block_n), 1),
                     w_bytes_per_el=w_el if w_el != el else None)
    except (AttributeError, ZeroDivisionError, ValueError):
        return None
    return est.t_total_s * 1e6 * max(int(experts), 1)


# ---------------------------------------------------------------------------
# search
# ---------------------------------------------------------------------------

def _search_model(dims, n: int, dtype: str, kind: str,
                  value_dtype: Optional[str] = None) -> TuneResult:
    """The reference's model search: block_n by the roofline model over
    ``candidate_block_ns``; dW kinds take the largest feasible tile (their
    traffic does not depend on it), and the grid order stays "nm"."""
    el = _DTYPE_BYTES.get(dtype, 4)
    w_el = _DTYPE_BYTES.get(value_dtype or dtype, 4)
    cands = candidate_block_ns(dims, n, dtype, value_dtype)
    if "sddmm" in kind:
        bn = cands[-1]
        est = estimate_rbgp4mm_dims(dims, n, bytes_per_el=el, block_n=bn,
                                    w_bytes_per_el=w_el)
        return TuneResult(bn, "nm", est.t_total_s * 1e6, "model")
    best = None
    for bn in cands:
        est = estimate_rbgp4mm_dims(dims, n, bytes_per_el=el, block_n=bn,
                                    w_bytes_per_el=w_el)
        if best is None or est.t_total_s < best[0]:
            best = (est.t_total_s, bn)
    return TuneResult(best[1], "nm", best[0] * 1e6, "model")


def _rule_result(kind: str, tables, n: int, dtype: str, value_dtype: str,
                 n_experts: int) -> TuneResult:
    """Rule mode on the card: the fixed rule's tile at the real N, with the
    ``perf_model`` estimate."""
    spec = _KINDS[kind]
    dt, vdt = _TORCH_DTYPES[dtype], _TORCH_DTYPES[value_dtype]
    tile = rule_tile(kind, tables, n, dt, vdt)
    bn = spec.block_n(tables, tile, n, n_experts)
    est = model_us(kind, tables.dims, n, dtype, value_dtype, bn, n_experts)
    return TuneResult(bn, "nm", est or 0.0, "rule", tile, n, n_experts)


def _search_measured(kind: str, tables, n: int, dtype: str,
                     value_dtype: str, n_experts: int) -> TuneResult:
    """Time every candidate tile on the launch's own tables and pick the
    fastest (CUDA events on the current stream, warm-up excluded, median
    of ``MEASURE_REPS``).  Raises when no candidate launches."""
    spec = _KINDS[kind]
    dt, vdt = _TORCH_DTYPES[dtype], _TORCH_DTYPES[value_dtype]
    body = _body(kind, tables.dims, n, dtype, value_dtype)
    device = tables.col0.device
    gen = torch.Generator(device=device)
    gen.manual_seed(MEASURE_SEED)
    ops = spec.operands(tables, n, n_experts, dt, vdt, gen)
    stream = torch.cuda.current_stream(device)
    best, errors, timings = None, [], {}
    for tile in candidate_tiles(kind, tables, n, dt, vdt):
        try:
            spec.launch(tables, body, tile, ops)  # warm-up, not timed
            ev = [(torch.cuda.Event(enable_timing=True),
                   torch.cuda.Event(enable_timing=True))
                  for _ in range(MEASURE_REPS)]
            with torch.cuda.device(device):
                torch.cuda._sleep(HOLD_CYCLES)
            for start, end in ev:
                start.record(stream)
                spec.launch(tables, body, tile, ops)
                end.record(stream)
            torch.cuda.synchronize(device)
            us = statistics.median(s.elapsed_time(e) for s, e in ev) * 1e3
        except (RuntimeError, ValueError) as err:
            errors.append(f"{tile}: {err}")
            continue
        timings[tile] = us
        if best is None or us < best.us_estimate:
            best = TuneResult(spec.block_n(tables, tile, n, n_experts), "nm",
                              us, "measured", tile, n, n_experts)
    if best is None:
        raise RuntimeError(f"autotune: no candidate tile of {kind} launched "
                           f"at N={n} ({dtype}): {'; '.join(errors)}")
    measured_searches.append(dict(
        kind=kind + (".t" if tables.transposed else ""), dims=tables.dims,
        n=n, experts=n_experts, body=body, timings=timings, tile=best.tile))
    return best


def _valid(hit: TuneResult, kind: str, dims, nb: int, dtype: str,
           value_dtype: Optional[str], tables, n: int) -> bool:
    """Whether a cached entry may launch: a known grid order, and its tile
    among the launch's candidates (a model-search entry: its block_n among
    ``candidate_block_ns``)."""
    if hit.grid_order not in GRID_ORDERS or not isinstance(hit.block_n, int):
        return False
    if hit.tile is None:
        return hit.block_n in candidate_block_ns(dims, nb, dtype, value_dtype)
    if tables is None or kind not in _KINDS or dtype not in _TORCH_DTYPES:
        return False
    vdt = _TORCH_DTYPES.get(value_dtype or dtype)
    return tuple(hit.tile) in candidate_tiles(kind, tables, n,
                                              _TORCH_DTYPES[dtype], vdt)


def autotune(dims, n: int, *, dtype: str = "float32", kind: str = "rhs",
             platform: Optional[str] = None, tables=None,
             value_dtype: Optional[str] = None, n_experts: int = 1,
             search_fn: Optional[Callable[..., TuneResult]] = None
             ) -> TuneResult:
    """Resolve the launch configuration for one kernel shape.

    Args:
      dims: ``KernelDims`` or ``ChainDims`` (any object with their fields).
      n: tokens (rows an expert for the stacked kinds); bucketed to the
        next power of two for the cache key.
      dtype: operand dtype name.
      kind: one of the kinds of the module docstring.
      platform: ``cuda-sm90``, ``cpu``, ...; default: that of ``tables``
        (else the card if there is one).
      tables: the launch's ``KernelTables`` / ``ChainTables`` (the
        reference's ``adj_o``): needed for rule and measured mode, whose
        tiles depend on its classes and which time on its tables.
      value_dtype: stored-value dtype when it differs from ``dtype`` (int8
        storage), part of the key and of the model's W traffic.
      n_experts: the stacked launch's expert count, part of the key.
      search_fn: test hook replacing the search (signature of
        ``_search_model`` minus ``value_dtype``); its results are cached
        on every platform.
    """
    if platform is None:
        platform = platform_of(tables.col0.device if tables is not None
                               else None)
    vd = value_dtype or dtype
    on_card = platform.startswith("cuda")
    measure = mode() == "measure"
    if search_fn is None and on_card and not measure:
        result = _rule_result(kind, tables, n, dtype, vd, n_experts)
        _notify(kind, dims, n, dtype, value_dtype, platform, result,
                cached=False)
        return result
    if search_fn is None and measure and platform == "cpu":
        raise RuntimeError("REPRO_AUTOTUNE_MODE=measure times kernels on the "
                           "card; the CPU's plain versions have nothing to "
                           "measure (unset it, or run on cuda)")
    nb = _n_bucket(n)
    transposed = bool(getattr(tables, "transposed", False))
    key = _key(kind, dims, nb, dtype, platform, value_dtype,
               transposed=transposed,
               body=_body(kind, dims, n, dtype, vd), n_experts=n_experts)
    with _lock:
        hit = _mem_cache.get(key)
        if hit is None:
            _load_disk_locked()
            hit = _mem_cache.get(key)
    if hit is not None:
        if _valid(hit, kind, dims, nb, dtype, value_dtype, tables, n):
            _notify(kind, dims, nb, dtype, value_dtype, platform, hit,
                    cached=True)
            return hit
        with _lock:
            _mem_cache.pop(key, None)
    if search_fn is not None:
        result = search_fn(dims, nb, dtype, kind)
    elif on_card:
        result = _search_measured(kind, tables, n, dtype, vd, n_experts)
    else:
        result = _search_model(dims, nb, dtype, kind, value_dtype)
    _store(key, result)
    _notify(kind, dims, nb, dtype, value_dtype, platform, result,
            cached=False)
    return result


def resolve(dims, n: int, *, dtype: str = "float32", kind: str = "rhs",
            platform: Optional[str] = None, tables=None,
            value_dtype: Optional[str] = None,
            n_experts: int = 1) -> TuneResult:
    """The resolution a kernel wrapper asks for (``launch_tile`` memoizes
    it on the tables).  The port has no interpret mode: a CPU launch keys
    under ``cpu``, a card launch under ``cuda-sm<cc>``."""
    return autotune(dims, n, dtype=dtype, kind=kind, platform=platform,
                    tables=tables, value_dtype=value_dtype,
                    n_experts=n_experts)


def launch_tile(tables, kind: str, n: int, dtype: torch.dtype,
                value_dtype: Optional[torch.dtype] = None,
                n_experts: int = 1) -> TuneResult:
    """``resolve`` for one launch of ``kind`` on ``tables``, memoized on the
    tables object by (kind, N, dtype, value dtype, experts): a launch
    resolved before costs one dict lookup until the generation moves."""
    memo = tables.__dict__.get("_tune")
    if memo is None:
        memo = tables.__dict__.setdefault("_tune", {})
    mkey = (kind, n, dtype, value_dtype, n_experts)
    hit = memo.get(mkey)
    if hit is not None and hit[0] == _generation:
        return hit[1]
    gen = _generation
    dt = _DTYPE_NAMES.get(dtype, str(dtype).rpartition(".")[2])
    vd = (None if value_dtype is None
          else _DTYPE_NAMES.get(value_dtype,
                                str(value_dtype).rpartition(".")[2]))
    result = resolve(tables.dims, n, dtype=dt, kind=kind,
                     platform=platform_of(tables.col0.device), tables=tables,
                     value_dtype=vd, n_experts=n_experts)
    memo[mkey] = (gen, result)
    return result
