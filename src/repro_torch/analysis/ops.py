"""Op counts of an eager program: the counterpart of ``repro/analysis/hlo.py``.

The reference parses a compiled XLA module's text; the port's program is
eager torch, so ``count_ops`` runs it under a ``TorchDispatchMode`` that
sees every aten op as it executes, backward and recomputation (remat)
included.  Loops are counted as they run, with one exception: under
``scan_trips`` (the dry-run's) a recurrent scan over ``meta`` tensors
(``models.common.run_chunks``, whose ``scan_runner`` the counter sets
while it runs) runs its first full chunk once inside
``OpCounter.repeated`` and it counts for every full chunk, as
``hlo.py`` multiplies a scan's ``while`` body by its trip count: its
counts, the live bytes of what it leaves alive and, in the backward, the
ops of the autograd nodes it made, each times the trip count (``loops``
lists each such body).  ``unknown_trip_counts`` is always 0.  It runs on
any device; the dry-run runs it on ``meta`` tensors, which have shapes
and no values.  Per op:

  * dot FLOPs: exact for ``mm``, ``bmm``, ``addmm``, ``baddbmm`` and
    convolution (``torch.utils.flop_counter``'s formulas, which also
    cover the fused attention ops);
  * all FLOPs: the dot FLOPs, plus one per result element of elementwise
    math (ops tagged pointwise, copies and casts excluded);
  * bytes: operands plus result.  A view moves nothing; a gather, index
    or index_select reads only the region it selects (2x its result, as
    ``hlo.py:332-357`` counts a slice or gather); an in-place scatter,
    index_put or index_add moves 2x its update; ``empty`` writes nothing;
  * collectives by kind, from the c10d ops the mode sees (so code that
    calls ``torch.distributed`` directly is counted too), with the
    reference's factors (``hlo.py:359-370``): an all-gather counts its
    result bytes, an all-reduce twice its operand bytes, the rest their
    operand bytes;
  * the peak of live bytes: every storage the program creates is live
    from its first op until its last reference dies (a view shares its
    base's storage and is not counted again; an activation that
    ``torch.utils.checkpoint`` frees and recomputes is freed and created
    again), plus the argument storages, which are live throughout.

Per-device numbers, as the reference's: each process traces its own
rank's program.
"""
from __future__ import annotations

import contextlib
import dataclasses
import weakref
from collections import defaultdict
from typing import Callable, Iterable, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

__all__ = ["OpAnalysis", "OpCounter", "count_ops", "storage_bytes",
           "COLLECTIVES"]


@dataclasses.dataclass
class _Loop:
    carry: object = None


#: the reference's collective kinds, and the broadcast the port's serving
#: issues
COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute", "broadcast")

# the c10d ops the torch.distributed calls dispatch -> kind
_COLL_OPS = {
    "_allgather_base_": "all-gather", "allgather_": "all-gather",
    "allreduce_": "all-reduce", "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter", "alltoall_": "all-to-all",
    "alltoall_base_": "all-to-all", "send": "collective-permute",
    "recv_": "collective-permute", "broadcast_": "broadcast",
}
# ops that read only the region they select
_GATHERS = {"index", "index_select", "gather", "embedding", "take",
            "take_along_dim"}
# in-place updates of a region: 2x the update
_SCATTERS = {"index_put_", "index_add_", "scatter_", "scatter_add_",
             "scatter_reduce_", "index_copy_", "masked_scatter_"}
# pointwise-tagged ops that move values without math
_NOT_MATH = {"copy", "copy_", "_to_copy", "clone", "fill", "fill_", "zero_",
             "lift_fresh", "detach", "alias", "_unsafe_view",
             "masked_fill", "masked_fill_", "where"}


def _tensors(obj) -> list:
    return [t for t in tree_flatten(obj)[0] if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def storage_bytes(tensors: Iterable[torch.Tensor]) -> int:
    """The bytes of the distinct storages under ``tensors`` (a view and its
    base count once)."""
    seen, total = set(), 0
    for t in tensors:
        if t is None:
            continue
        s = t.untyped_storage()
        key = (t.device, s.data_ptr() if t.device.type != "meta" else id(s))
        if key not in seen:
            seen.add(key)
            total += s.nbytes()
    return total


@dataclasses.dataclass
class OpAnalysis:
    """The reference's ``HLOAnalysis`` fields, per device, and the live
    bytes: ``argument_bytes`` (the storages given as arguments) and
    ``peak_bytes`` (arguments plus the most the program's own storages
    held at once).  ``records`` holds (op, scope, dtype, shape, dot
    FLOPs, bytes) of every op, in order."""

    flops: float
    dot_flops: float
    bytes_accessed: float
    collective_bytes: dict
    collective_counts: dict
    total_collective_bytes: float
    loops: list
    unknown_trip_counts: int
    dot_breakdown: dict = dataclasses.field(default_factory=dict)
    bytes_breakdown: dict = dataclasses.field(default_factory=dict)
    coll_breakdown: dict = dataclasses.field(default_factory=dict)
    argument_bytes: int = 0
    peak_bytes: int = 0
    records: list = dataclasses.field(default_factory=list)

    @property
    def temp_bytes(self) -> int:
        return self.peak_bytes - self.argument_bytes

    def top_colls(self, n=15):
        return sorted(self.coll_breakdown.items(), key=lambda kv: -kv[1])[:n]

    def top_dots(self, n=15):
        return sorted(self.dot_breakdown.items(), key=lambda kv: -kv[1])[:n]

    def top_bytes(self, n=15):
        return sorted(self.bytes_breakdown.items(), key=lambda kv: -kv[1])[:n]

    def summary(self) -> dict:
        return {
            "flops": self.flops,
            "dot_flops": self.dot_flops,
            "bytes_accessed": self.bytes_accessed,
            "collective_bytes": dict(self.collective_bytes),
            "collective_counts": dict(self.collective_counts),
            "total_collective_bytes": self.total_collective_bytes,
            "n_loops": len(self.loops),
            "unknown_trip_counts": self.unknown_trip_counts,
        }

    def op_result_shapes(self, kind: str) -> list[tuple[str, tuple]]:
        """(dtype, shape) of the first result of every op named ``kind``
        (``"mm"``, or ``"aten.mm.default"``), in order."""
        return [(r[2], r[3]) for r in self.records
                if r[0] == kind or r[0].split(".")[1:2] == [kind]]


class _Scopes:
    """The innermost module whose forward runs (the tag of an op in the
    breakdowns), through the global module hooks; ops the autograd engine
    runs outside any forward are tagged ``backward``."""

    def __init__(self, root: Optional[torch.nn.Module]):
        self.names = ({id(m): n or "model"
                       for n, m in root.named_modules()} if root is not None
                      else {})
        self.stack: list[str] = []
        self.handles = []

    def __enter__(self):
        from torch.nn.modules import module as mod

        def pre(m, _args):
            self.stack.append(self.names.get(id(m), type(m).__name__))

        def post(m, _args, _out):
            if self.stack:
                self.stack.pop()

        self.handles = [mod.register_module_forward_pre_hook(pre),
                        mod.register_module_forward_hook(post)]
        return self

    def __exit__(self, *exc):
        for h in self.handles:
            h.remove()

    def scope(self) -> str:
        if torch._C._current_graph_task_id() != -1:
            return "backward"
        return self.stack[-1] if self.stack else "program"


class OpCounter(TorchDispatchMode):
    """Counts every op dispatched under it (see the module docstring);
    ``arguments`` are live throughout and counted once."""

    def __init__(self, arguments: Iterable[torch.Tensor] = (),
                 module: Optional[torch.nn.Module] = None,
                 keep_records: bool = True, scan_trips: bool = False):
        super().__init__()
        self.scan_trips = scan_trips
        # ops dispatched while it is above 0 are run and not counted
        self._quiet = 0
        self._outer_runner = None
        # (first, end) sequence numbers of a repeated body's autograd
        # nodes, and its trip count; the extra live bytes a storage the
        # body left alive stands for
        self._ranges: list = []
        self._phantom: dict = {}
        self.loops: list = []
        args = [t for t in arguments if t is not None]
        self.argument_bytes = storage_bytes(args)
        self._known: dict = {}
        for t in args:
            self._known[self._key(t)] = None
        self.live = 0
        self.peak_live = 0
        self.flops = self.dot_flops = self.bytes = 0.0
        self.coll_bytes = dict.fromkeys(COLLECTIVES, 0.0)
        self.coll_counts = dict.fromkeys(COLLECTIVES, 0)
        self.dot_bd: dict = defaultdict(float)
        self.bytes_bd: dict = defaultdict(float)
        self.coll_bd: dict = defaultdict(float)
        self.records: list = []
        self.keep_records = keep_records
        self.scopes = _Scopes(module)

    @staticmethod
    def _key(t: torch.Tensor):
        s = t.untyped_storage()
        return (t.device.type, s.data_ptr() if t.device.type != "meta"
                else id(s))

    def _track(self, t: torch.Tensor) -> None:
        """A storage the program made: live until its last reference
        dies."""
        s = t.untyped_storage()
        key = self._key(t)
        if key in self._known:
            return
        n = s.nbytes()
        self._known[key] = n
        self.live += n
        self.peak_live = max(self.peak_live, self.live)
        weakref.finalize(s, self._free, key)

    def _free(self, key) -> None:
        n = self._known.pop(key, None)
        if n:
            self.live -= n
        self.live -= self._phantom.pop(key, 0)

    def __enter__(self):
        from repro_torch.models import common

        self.scopes.__enter__()
        self._outer_runner = common.scan_runner
        common.scan_runner = self._run_scan if self.scan_trips else None
        return super().__enter__()

    def __exit__(self, *exc):
        from repro_torch.models import common

        common.scan_runner = self._outer_runner
        self.scopes.__exit__(*exc)
        return super().__exit__(*exc)

    @contextlib.contextmanager
    def _unseen(self):
        """Runs what is dispatched inside without counting or tracking it."""
        self._quiet += 1
        try:
            yield
        finally:
            self._quiet -= 1

    def _sequence_nr(self) -> int:
        """The sequence number the next autograd node of this thread gets
        (a probe's, which the counter does not see)."""
        with self._unseen(), torch.enable_grad():
            probe = torch.zeros((), requires_grad=True).view(())
            return probe.grad_fn._sequence_nr() + 1

    def _run_scan(self, body, n_steps: int, chunk: int, state):
        """``models.common.scan_runner`` under ``scan_trips``: a scan over
        ``meta`` tensors of at least 2 full chunks before its last runs its
        first chunk once, counted for each of them (``repeated``), and its
        last as it is; the other chunks' ys are a placeholder the counter
        does not see.  Each chunk's backward is the first one's, so the
        counts are the full scan's.  None (the plain loop) elsewhere."""
        last = (n_steps - 1) // chunk * chunk      # the last chunk's start
        trips = last // chunk
        if state.device.type != "meta" or trips < 2:
            return None
        with self.repeated(trips) as loop:
            ys, state = body(0, chunk, state)
            loop.carry = state
        with self._unseen():
            rest = torch.empty((ys.shape[0], last - chunk, *ys.shape[2:]),
                               dtype=ys.dtype, device=ys.device)
        tail, state = body(last, n_steps - last, state)
        return torch.cat([ys, rest, tail], 1), state

    def _totals(self) -> tuple:
        return (self.flops, self.dot_flops, self.bytes, dict(self.dot_bd),
                dict(self.bytes_bd), dict(self.coll_bd),
                dict(self.coll_bytes), dict(self.coll_counts))

    @contextlib.contextmanager
    def repeated(self, n: int, what: str = "scan"):
        """Count what runs inside as ``n`` runs of it (a loop body of trip
        count ``n`` run once): its counts; the live bytes of the storages
        it made and left alive (each stands for ``n`` until it dies), but
        the loop's carried state, which the body sets as ``carry`` on what
        this yields (one alive at a time), and its peak as the last
        trip's, beside what the earlier trips left; and in the backward
        the ops of the autograd nodes it made (outside a remat recompute,
        which runs forward code)."""
        before, known = self._totals(), set(self._known)
        seq0 = self._sequence_nr() if torch.is_grad_enabled() else None
        outer_peak, self.peak_live = self.peak_live, self.live
        loop = _Loop()
        yield loop
        k = n - 1
        known |= {self._key(t) for t in _tensors(loop.carry)}
        (f, d, b, dbd, bbd, cbd, cby, ccn) = before
        self.flops += k * (self.flops - f)
        self.dot_flops += k * (self.dot_flops - d)
        self.bytes += k * (self.bytes - b)
        for now, was in ((self.dot_bd, dbd), (self.bytes_bd, bbd),
                         (self.coll_bd, cbd), (self.coll_bytes, cby),
                         (self.coll_counts, ccn)):
            for key in list(now):
                now[key] += k * (now[key] - was.get(key, 0))
        # the last trip's peak stands beside the earlier trips' leavings
        left = sum(nbytes for key, nbytes in self._known.items()
                   if key not in known)
        for key, nbytes in self._known.items():
            if key not in known and nbytes:
                self._phantom[key] = self._phantom.get(key, 0) + k * nbytes
        self.live += k * left
        self.peak_live = max(outer_peak, self.peak_live + k * left)
        if seq0 is not None:
            self._ranges.append((seq0, self._sequence_nr(), n))
        self.loops.append((what, n))

    def _trip_count(self) -> int:
        """The trip count of the repeated body whose autograd node runs
        this op in the backward (1 elsewhere)."""
        if not self._ranges or torch.is_grad_enabled():
            return 1
        # the node the autograd engine runs on this thread (None outside
        # a backward)
        node = torch._C._current_autograd_node()
        if node is None:
            return 1
        seq = node._sequence_nr()
        for lo, hi, n in self._ranges:
            if lo <= seq < hi:
                return n
        return 1

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self._quiet:
            return out
        name = func._schema.name.split("::")[-1]
        ns = func.namespace
        ins = _tensors((args, kwargs))
        outs = _tensors(out)
        scope = self.scopes.scope()
        tag = f"{scope}|{func._overloadpacket.__name__}"
        dot = b = 0.0
        trips = self._trip_count()
        if ns == "c10d":
            kind = _COLL_OPS.get(name)
            if kind is not None:
                self._collective(kind, name, args, tag)
        else:
            packet = func._overloadpacket
            from torch.utils.flop_counter import flop_registry

            if packet in flop_registry:
                dot = trips * float(flop_registry[packet](*args, **kwargs,
                                                          out_val=out))
                self.dot_flops += dot
                self.flops += dot
                self.dot_bd[tag] += dot
            elif torch.Tag.pointwise in func.tags and name not in _NOT_MATH:
                self.flops += trips * sum(t.numel() for t in outs[:1])
            b = trips * self._bytes(func, name, ins, outs)
            self.bytes += b
            self.bytes_bd[tag] += b
        for t in outs:
            self._track(t)
        if self.keep_records and outs:
            o = outs[0]
            self.records.append((str(func), scope,
                                 str(o.dtype).split(".")[-1],
                                 tuple(o.shape), dot, b))
        return out

    def _bytes(self, func, name: str, ins: list, outs: list) -> float:
        schema = func._schema
        rets = schema.returns
        if rets and all(r.alias_info is not None
                        and not r.alias_info.is_write for r in rets):
            return 0.0   # a view
        if name.startswith("empty") or name in ("detach", "lift_fresh"):
            return 0.0
        base = name.split(".")[0]
        if base in _GATHERS:
            return 2.0 * sum(_nbytes(t) for t in outs)
        if base in _SCATTERS:
            upd = ins[-1] if ins else None
            return 2.0 * (_nbytes(upd) if upd is not None else 0)
        if base == "copy_" and len(ins) >= 2:
            return 2.0 * _nbytes(ins[1])
        seen, total = set(), 0
        for t in ins + outs:
            if id(t) not in seen:
                seen.add(id(t))
                total += _nbytes(t)
        return float(total)

    def _collective(self, kind: str, name: str, args, tag: str) -> None:
        first = _tensors(args[:1])
        if kind == "all-gather":
            b = sum(_nbytes(t) for t in first)   # the result buffers
        elif kind == "all-reduce":
            b = 2 * sum(_nbytes(t) for t in first)
        else:
            src = _tensors(args[1:2]) if kind in ("reduce-scatter",
                                                   "all-to-all") else first
            b = sum(_nbytes(t) for t in src)
        self.coll_bytes[kind] += b
        self.coll_counts[kind] += 1
        self.coll_bd[f"{kind}|{tag}"] += b

    def result(self) -> OpAnalysis:
        return OpAnalysis(
            flops=self.flops, dot_flops=self.dot_flops,
            bytes_accessed=self.bytes,
            collective_bytes=dict(self.coll_bytes),
            collective_counts=dict(self.coll_counts),
            total_collective_bytes=float(sum(self.coll_bytes.values())),
            loops=list(self.loops), unknown_trip_counts=0,
            dot_breakdown=dict(self.dot_bd),
            bytes_breakdown=dict(self.bytes_bd),
            coll_breakdown=dict(self.coll_bd),
            argument_bytes=self.argument_bytes,
            peak_bytes=self.argument_bytes + self.peak_live,
            records=self.records)


def count_ops(fn: Callable, *args, arguments: Iterable = (),
              module: Optional[torch.nn.Module] = None,
              keep_records: bool = True, scan_trips: bool = False,
              **kwargs):
    """(fn(*args, **kwargs), OpAnalysis) of one run of ``fn`` under the
    counter; ``arguments`` are the tensors live before and after it (the
    program's parameters, state and inputs), ``module`` names the scopes
    of the breakdowns; ``scan_trips`` reckons a scan over ``meta``
    tensors by one chunk and its trip count (``records`` then hold that
    chunk's ops once)."""
    counter = OpCounter(arguments, module, keep_records, scan_trips)
    with counter:
        out = fn(*args, **kwargs)
    return out, counter.result()

