"""SparsityPlan: declarative per-layer sparsity for a whole model.

The port of ``repro/sparsity/plan.py``, the plan compiler:

  * :class:`PatternSpec` — what ``SparsityConfig`` says about one matrix
    (the same fields), with the plan-side helpers: storage kind, JSON;
  * :class:`SparsityPlan` — ordered ``(path-regex, PatternSpec)`` rules.
    Every ``SparseLinear`` resolves its pattern by *module path* against
    the first rule whose regex full-matches it; no match is dense.  Plans
    are frozen, hashable, JSON round-trippable and content-fingerprinted:
    ``fingerprint()`` gives the reference's digest for the same plan, so
    a checkpoint stamped by either refuses a restore under another plan.
  * :func:`lower_config` — the one-rule plan a ``SparsityConfig`` means;
    a lowered uniform plan builds exactly the layouts of the config.
  * :func:`model_matmul_shapes` — every projection's ``path -> (m, k,
    count)``, recorded by building the model on ``meta`` under
    :func:`recording_shapes` (no pattern, storage or weight is made);
  * :func:`solve_budget` — per-layer power-of-two sparsity steps that
    meet a global weight-memory or FLOP budget, largest matmul first;
  * :func:`plan_density` and :func:`certify` — the achieved density, and
    every sampled factor's second singular value against the Ramanujan
    bound ``sqrt(d_l-1) + sqrt(d_r-1)``.

Same arguments give the reference's plans, fingerprints and reports,
field for field; ``solve_budget(cost_model="perf_model")`` weighs the
port's own data-sheet model of the H100 (``kernels/perf_model.py``).
"""
from __future__ import annotations

import dataclasses
import functools
import hashlib
import json
import re
import warnings
from typing import Callable, Optional, Union

from repro_torch.core import canonicalize_factors, design_rbgp, design_rbgp4
from repro_torch.core.graphs import ramanujan_bound, second_singular_value

from .patterns import PatternInstance, SparsityConfig, make_pattern

__all__ = ["PatternSpec", "PlanRule", "SparsityPlan", "DENSE",
           "lower_config", "storage_kind", "solve_budget", "plan_density",
           "certify", "model_matmul_shapes", "recording_shapes",
           "record_shape", "recording_active"]

# storage capability of every backend name of the reference's registry
# (``repro/sparsity/api.py``): what a spec naming it stores.  None is
# masked storage (dense values under a fixed mask, one dense product).
# The port runs compact and chain storage on its kernels whatever the
# name.
_BACKEND_STORAGE = {
    "ref": None,
    "xla_masked": None,
    "xla_compact": "compact",
    "pallas": "compact",
    "chain": "chain",
    "quant": None,
}


def storage_kind(backend: str, *, has_layout: bool,
                 chain: bool = False) -> str:
    """'compact', 'chain' or 'masked' storage for a sparsified layer given
    the backend name (the reference's ``api.storage_kind``).

    ``auto`` prefers compact storage whenever the pattern has an RBGP4
    layout, then chain storage for a deeper product chain, then masked.
    A backend declaring compact or chain storage requires the matching
    pattern and raises ValueError otherwise.
    """
    if backend == "auto":
        if has_layout:
            return "compact"
        return "chain" if chain else "masked"
    if backend not in _BACKEND_STORAGE:
        raise KeyError(f"unknown sparse backend {backend!r}; available: "
                       f"{sorted(_BACKEND_STORAGE)}")
    kind = _BACKEND_STORAGE[backend]
    if kind == "chain":
        if not chain:
            raise ValueError(
                f"backend {backend!r} requires a >2-sparse-factor rbgp "
                f"chain (RBGP4-expressible patterns use compact storage)")
        return "chain"
    if kind == "compact":
        if not has_layout:
            raise ValueError(f"backend {backend!r} requires pattern=rbgp4 "
                             f"(compact storage is an RBGP property)")
        return "compact"
    return "masked"


def _config_kwargs(cfg: SparsityConfig) -> dict:
    return {f.name: getattr(cfg, f.name)
            for f in dataclasses.fields(SparsityConfig)}


@dataclasses.dataclass(frozen=True)
class PatternSpec(SparsityConfig):
    """Declarative pattern for the layers one plan rule matches: the
    fields of :class:`SparsityConfig`, nothing more, so ``to_config``
    rebuilds the exact config and masks come from the one
    ``make_pattern`` path."""

    @classmethod
    def from_config(cls, cfg: SparsityConfig) -> "PatternSpec":
        return cls(**_config_kwargs(cfg))

    def to_config(self) -> SparsityConfig:
        return SparsityConfig(**_config_kwargs(self))

    @property
    def is_sparse(self) -> bool:
        return self.pattern != "dense" and self.sparsity > 0.0

    def may_have_layout(self) -> bool:
        """Whether this spec resolves to an RBGP4 layout: rbgp4, or an
        rbgp template with at most two Ramanujan factors (template-level,
        knowable without shapes)."""
        if self.pattern == "rbgp4":
            return True
        if self.pattern != "rbgp":
            return False
        if self.factors is None:
            return True
        n_ram = sum(1 for t in canonicalize_factors(self.factors)
                    if t[0] == "ramanujan")
        return n_ram <= 2

    def is_chain(self) -> bool:
        """Whether this spec resolves to a product chain with more than
        two Ramanujan factors (``ChainLayout`` storage)."""
        return self.pattern == "rbgp" and not self.may_have_layout()

    def storage(self) -> str:
        """'dense' | 'masked' | 'compact' | 'chain': what this spec
        stores, assuming it applies."""
        if not self.is_sparse:
            return "dense"
        try:
            return storage_kind(self.backend,
                                has_layout=self.may_have_layout(),
                                chain=self.is_chain())
        except ValueError:
            return "masked"

    def to_json(self) -> dict:
        d = dataclasses.asdict(self)
        d["block"] = list(self.block)
        if self.factors is not None:
            d["factors"] = [list(f) if not isinstance(f, str) else f
                            for f in self.factors]
        return d

    @classmethod
    def from_json(cls, d: dict) -> "PatternSpec":
        factors = d.get("factors")
        if factors is not None:
            factors = tuple(
                f if isinstance(f, str) else tuple(
                    tuple(x) if isinstance(x, list) else x for x in f)
                for f in factors
            )
        return cls(
            pattern=d.get("pattern", "dense"),
            sparsity=float(d.get("sparsity", 0.0)),
            backend=d.get("backend", "xla_masked"),
            block=tuple(d.get("block", (4, 4))),
            seed=int(d.get("seed", 0)),
            min_dim=int(d.get("min_dim", 256)),
            factors=factors,
            quant=d.get("quant"),
        )


#: the spec of a path no rule matches, and of a solved plan's keep-dense
#: rule: the reference's ``PatternSpec()``, backend included, so a plan
#: written here has the reference's JSON (the port's own default backend
#: is ``auto``; a dense spec stores the same either way)
DENSE = PatternSpec(backend="xla_masked")


@functools.lru_cache(maxsize=4096)
def _compile(pattern: str) -> re.Pattern:
    return re.compile(pattern)


@dataclasses.dataclass(frozen=True)
class PlanRule:
    """One ordered rule: full-match ``match`` regex over the module path."""

    match: str
    spec: PatternSpec
    note: str = ""


@dataclasses.dataclass(frozen=True)
class SparsityPlan:
    """Ordered (path-regex, PatternSpec) rules; the first full match wins,
    and a path that matches no rule is dense."""

    rules: tuple[PlanRule, ...] = ()
    version: int = 1

    # -- resolution ---------------------------------------------------------
    def resolve(self, path: str, m: Optional[int] = None,
                k: Optional[int] = None) -> PatternSpec:
        """The spec of the first rule whose regex full-matches ``path``
        (shape-agnostic: ``min_dim`` is the consumer's ``applies_to``)."""
        for r in self.rules:
            if _compile(r.match).fullmatch(path):
                return r.spec
        return DENSE

    def pattern_for(self, path: str, m: int, k: int) -> PatternInstance:
        """The realized pattern a ``SparseLinear`` at ``path`` builds."""
        spec = self.resolve(path, m, k)
        if not spec.applies_to(m, k):
            return make_pattern(SparsityConfig(), m, k)
        return make_pattern(spec.to_config(), m, k)

    def materialize(self, shapes: dict) -> dict:
        """``{path: PatternInstance}`` over a ``{path: (m, k[, count])}``
        shape table (see :func:`model_matmul_shapes`)."""
        return {path: self.pattern_for(path, *shp[:2])
                for path, shp in shapes.items()}

    # -- per-layer seeds ------------------------------------------------------
    def offset_masked_seeds(self, offset: int) -> "SparsityPlan":
        """Masked-storage rules get ``seed + offset`` so every layer
        samples its own graphs; compact- and chain-storage rules keep their
        seed, so every layer of a shape shares one layout (the reference's
        per-layer rule, bit for bit)."""
        if offset == 0:
            return self
        new = []
        for r in self.rules:
            if r.spec.is_sparse and r.spec.storage() in ("compact", "chain"):
                new.append(r)
            else:
                new.append(dataclasses.replace(
                    r, spec=dataclasses.replace(
                        r.spec, seed=r.spec.seed + offset)))
        return dataclasses.replace(self, rules=tuple(new))

    def signature(self, paths_shapes) -> tuple:
        """Resolution signature over (path, m, k) triples: the reference's
        ``Stack`` scans two layers together only when their signatures are
        equal.  Masked-storage specs are seed-normalized; compact and chain
        specs keep their seed (it fixes the layout)."""
        out = []
        for path, m, k in paths_shapes:
            spec = self.resolve(path, m, k)
            if not spec.applies_to(m, k):
                spec = DENSE
            if not (spec.is_sparse
                    and spec.storage() in ("compact", "chain")):
                spec = dataclasses.replace(spec, seed=0)
            out.append(spec)
        return tuple(out)

    # -- serialization ------------------------------------------------------
    def to_json(self) -> dict:
        return {
            "kind": "sparsity-plan",
            "version": self.version,
            "rules": [
                {"match": r.match, "note": r.note, "spec": r.spec.to_json()}
                for r in self.rules
            ],
        }

    def dumps(self) -> str:
        return json.dumps(self.to_json(), sort_keys=True, indent=1)

    @classmethod
    def from_json(cls, d: dict) -> "SparsityPlan":
        if d.get("kind") != "sparsity-plan":
            raise ValueError(
                f"not a sparsity plan (kind={d.get('kind')!r}); expected a "
                f"JSON object written by SparsityPlan.dumps/save")
        return cls(
            rules=tuple(
                PlanRule(match=r["match"], note=r.get("note", ""),
                         spec=PatternSpec.from_json(r["spec"]))
                for r in d.get("rules", ())
            ),
            version=int(d.get("version", 1)),
        )

    @classmethod
    def loads(cls, s: str) -> "SparsityPlan":
        return cls.from_json(json.loads(s))

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.dumps())

    @classmethod
    def load(cls, path: str) -> "SparsityPlan":
        with open(path) as f:
            return cls.loads(f.read())

    def fingerprint(self) -> str:
        """Content hash of what fixes the masks and the storage: rule
        order, regexes, and each spec's fields with its *storage kind* in
        place of its backend name; ``note`` and ``quant=None`` are left
        out.  The reference's digest, byte for byte."""
        canon = json.dumps(
            {
                "version": self.version,
                "rules": [
                    {"match": r.match,
                     "spec": dict(
                         {k: v for k, v in r.spec.to_json().items()
                          if k != "backend"
                          and not (k == "quant" and v is None)},
                         storage=r.spec.storage())}
                    for r in self.rules
                ],
            },
            sort_keys=True, separators=(",", ":"),
        )
        return hashlib.sha256(canon.encode()).hexdigest()[:16]

    def with_quant(self, quant: Optional[str]) -> "SparsityPlan":
        """A copy whose compact- and chain-storage rules store values as
        ``quant``; dense and masked-storage rules are left as they are (a
        masked layer's dense array has no leaf blocks to scale).  This is
        what ``--quant int8`` applies, and since ``quant`` enters the
        fingerprint, a quantized stack refuses full-precision checkpoints
        and the other way round."""
        new = []
        for r in self.rules:
            if r.spec.is_sparse and r.spec.storage() in ("compact", "chain"):
                new.append(dataclasses.replace(
                    r, spec=dataclasses.replace(r.spec, quant=quant)))
            else:
                new.append(r)
        return dataclasses.replace(self, rules=tuple(new))

    @classmethod
    def uniform(cls, spec: Union[PatternSpec, SparsityConfig],
                note: str = "uniform") -> "SparsityPlan":
        if not isinstance(spec, PatternSpec):
            spec = PatternSpec.from_config(spec)
        return cls(rules=(PlanRule(".*", spec, note=note),))


@functools.lru_cache(maxsize=512)
def lower_config(cfg: SparsityConfig) -> SparsityPlan:
    """The uniform plan a SparsityConfig means."""
    return SparsityPlan.uniform(
        PatternSpec.from_config(cfg), note="uniform (lowered SparsityConfig)")


# ---------------------------------------------------------------------------
# Shape recording: path -> (m, k, count) without materializing anything
# ---------------------------------------------------------------------------

_RECORDING: Optional[dict] = None


class _Recording:
    def __init__(self):
        self.shapes: dict[str, tuple[int, int, int]] = {}

    def __enter__(self):
        global _RECORDING
        if _RECORDING is not None:
            raise RuntimeError("shape recording is not reentrant")
        _RECORDING = self.shapes
        return self.shapes

    def __exit__(self, *exc):
        global _RECORDING
        _RECORDING = None
        return False


def recording_shapes() -> _Recording:
    """Context manager: while active, ``SparseLinear`` and
    ``StackedExperts`` record ``path -> (m, k, count)`` and return before
    any pattern, storage or weight is made."""
    return _Recording()


def recording_active() -> bool:
    return _RECORDING is not None


def record_shape(path: str, m: int, k: int, count: int = 1) -> None:
    if _RECORDING is None:
        return
    if path in _RECORDING:
        pm, pk, pc = _RECORDING[path]
        if (pm, pk) != (m, k):
            raise ValueError(
                f"path {path!r} recorded with two shapes: "
                f"{(pm, pk)} vs {(m, k)} — module paths must be unique")
        _RECORDING[path] = (m, k, pc + count)
    else:
        _RECORDING[path] = (m, k, count)


def model_matmul_shapes(cfg) -> dict[str, tuple[int, int, int]]:
    """Every projection's ``path -> (m, k, count)`` for a model config.

    Builds the model on ``meta`` under :func:`recording_shapes`, so nothing
    is allocated and no card is touched: one ``DecoderLayer`` for each
    layer of a language model, the model itself for a ``VisionConfig``.
    Embeddings and heads are not ``SparseLinear`` sites and are left out,
    as the paper keeps them dense."""
    from repro_torch.models.vision import VGG19, VisionConfig, WideResNet

    with recording_shapes() as shapes:
        if isinstance(cfg, VisionConfig):
            if "vgg" in cfg.name:
                VGG19(cfg, device="meta")
            else:
                WideResNet(cfg, device="meta")
        else:
            from repro_torch.models.transformer import DecoderLayer

            for i in range(cfg.n_layers):
                DecoderLayer(cfg, i, device="meta")
    return dict(shapes)


# ---------------------------------------------------------------------------
# Budget solver
# ---------------------------------------------------------------------------

def _norm_shapes(shapes: dict) -> dict[str, tuple[int, int, int]]:
    out = {}
    for path, shp in shapes.items():
        m, k = int(shp[0]), int(shp[1])
        c = int(shp[2]) if len(shp) > 2 else 1
        out[path] = (m, k, c)
    return out


def _max_feasible_steps(m: int, k: int, spec: PatternSpec,
                        max_steps: int) -> int:
    """Largest s such that the pattern realizes sparsity 1 - 2^-s at
    (m, k).  Feasibility is monotone in s for every registered pattern."""
    cap = 0
    for s in range(1, max_steps + 1):
        sp = 1.0 - 2.0 ** (-s)
        try:
            if spec.pattern == "rbgp4":
                design_rbgp4(m, k, sp, seed=0)
            elif spec.pattern == "rbgp":
                design_rbgp(m, k, sp, factors=spec.factors, seed=0)
            elif spec.pattern == "block":
                bh, bw = spec.block
                if m % bh or k % bw or round((1 - sp) * (k // bw)) < 1:
                    break
            elif spec.pattern == "unstructured":
                if round((1 - sp) * k) < 1:
                    break
            else:
                break
        except ValueError:
            break
        cap = s
    return cap


def solve_budget(
    shapes: dict,
    *,
    target_density: Optional[float] = None,
    target_flops: Optional[float] = None,
    pattern: str = "rbgp4",
    backend: Union[str, dict, Callable[[str], str]] = "auto",
    factors: Optional[tuple] = None,
    block: tuple[int, int] = (4, 4),
    min_dim: int = 256,
    max_steps: int = 8,
    seed: int = 0,
    group: Optional[Callable[[str], str]] = None,
    cost_model: str = "bytes",
    n_tokens: int = 2048,
) -> SparsityPlan:
    """Allocate per-layer pow-2 sparsity steps to hit a global budget.

    ``shapes`` maps module path -> ``(m, k)`` or ``(m, k, count)`` (see
    :func:`model_matmul_shapes`).  ``target_density`` is the requested
    ratio of remaining weight memory to dense, ``target_flops`` the same
    ratio of matmul FLOPs; both are ``count * m * k * density`` for these
    layers, so one greedy serves both: repeatedly halve the density of the
    layer contributing the most (largest matmul first) until the global
    ratio reaches the target.  Layers below ``min_dim`` or at their
    pattern's feasibility cap stay put.

    ``cost_model``: ``"bytes"`` (default) weighs ``count * m * k *
    density``; ``"perf_model"`` weighs the modeled kernel time of
    :mod:`repro_torch.kernels.perf_model` at ``n_tokens`` tokens (the dense
    estimate at density 1, the rbgp4 / chain estimate at each step), and
    then skips steps that buy no modeled time.  It needs ``target_flops``
    and the compact patterns (``rbgp4`` / ``rbgp``).

    Deterministic: ties break on sorted path (group) order, so the same
    arguments give the same plan JSON and fingerprint.  ``group``
    coalesces paths that move in lockstep.  A ``StackedExperts``' two
    sides (``….experts.in`` / ``….experts.out``) are always one group: the
    stacked storage has one spec for both.  Patterns other than ``rbgp4``
    have no stacked storage, so their expert paths stay dense, with a
    warning.

    ``backend`` routes execution per layer: a ``str`` for every rule; an
    ordered ``dict`` ``{path-regex: backend}`` (first ``re.search`` match
    wins, ``"auto"`` otherwise); or a callable ``path -> backend``.  It is
    resolved on the coupled path, and rules are emitted per ``(steps,
    backend)`` bucket; the fingerprint hashes storage kinds, not backend
    names.
    """
    if (target_density is None) == (target_flops is None):
        raise ValueError("pass exactly one of target_density / target_flops")
    target = target_density if target_density is not None else target_flops
    if not (0.0 < target <= 1.0):
        raise ValueError(f"target must be in (0, 1], got {target}")
    if cost_model not in ("bytes", "perf_model"):
        raise ValueError(f"cost_model must be 'bytes' or 'perf_model', "
                         f"got {cost_model!r}")
    if cost_model == "perf_model":
        if target_flops is None:
            raise ValueError(
                "cost_model='perf_model' weighs modeled wall-clock, which "
                "is a FLOP/runtime target — pass target_flops")
        if pattern not in ("rbgp4", "rbgp"):
            raise ValueError(
                f"cost_model='perf_model' models the compact executors "
                f"(patterns 'rbgp4'/'rbgp'); pattern {pattern!r} runs "
                f"masked emulation at dense speed")
    shapes = _norm_shapes(shapes)

    def backend_for(path: str) -> str:
        if callable(backend):
            return backend(path)
        if isinstance(backend, dict):
            for pat, b in backend.items():
                if re.search(pat, path):
                    return b
            return "auto"
        return backend

    base = PatternSpec(pattern=pattern, sparsity=0.5, backend="auto",
                       block=tuple(block), seed=seed, min_dim=min_dim,
                       factors=factors)
    # stacked expert weights take only the rbgp4 pattern: keep the expert
    # paths of any other pattern dense, loudly
    experts_re = re.compile(r"\.experts\.(in|out)$")
    expert_stackable = pattern == "rbgp4"
    skipped_experts = []

    # group entries; each group moves as one unit
    groups: dict[str, dict] = {}
    total_w = 0.0
    for path in sorted(shapes):
        m, k, c = shapes[path]
        w = float(m) * k * c
        total_w += w
        # expert in/out sides move together (one spec per StackedExperts)
        coupled = experts_re.sub(".experts", path)
        gkey = group(coupled) if group is not None else coupled
        g = groups.setdefault(gkey, {"paths": [], "w": 0.0, "cap": None,
                                     "steps": 0})
        g["paths"].append(path)
        g["w"] += w
        cap = 0
        if experts_re.search(path) and not expert_stackable:
            skipped_experts.append(path)
        elif min(m, k) >= min_dim:
            cap = _max_feasible_steps(m, k, base, max_steps)
        g["cap"] = cap if g["cap"] is None else min(g["cap"], cap)
    if skipped_experts:
        warnings.warn(
            f"solve_budget: pattern {pattern!r} has no stacked expert "
            f"storage (StackedExperts supports 'rbgp4' only); keeping "
            f"{len(skipped_experts)} expert path(s) dense: "
            f"{skipped_experts[:4]}...")
    if total_w <= 0:
        raise ValueError("empty shape table")

    if cost_model == "perf_model":
        from repro_torch.kernels import perf_model as _pm

        def _path_cost(m: int, k: int, c: int, s: int) -> float:
            if s == 0:
                return _pm.estimate_dense(m, k, n_tokens).t_total_s * c
            sp = 1.0 - 2.0 ** (-s)
            if pattern == "rbgp4":
                est = _pm.estimate_rbgp4mm(
                    design_rbgp4(m, k, sp, seed=0), n_tokens)
            else:
                est = _pm.estimate_chain_spec(
                    design_rbgp(m, k, sp, factors=factors, seed=0), n_tokens)
            return est.t_total_s * c

        # per-group modeled time at every feasible step (designs are
        # cached, the tables cheap)
        for g in groups.values():
            g["cost"] = [sum(_path_cost(*shapes[p], s) for p in g["paths"])
                         for s in range(g["cap"] + 1)]

    def weight_at(g: dict, s: int) -> float:
        if cost_model == "perf_model":
            return g["cost"][min(s, len(g["cost"]) - 1)]
        return g["w"] * 2.0 ** (-s)

    total0 = sum(weight_at(g, 0) for g in groups.values())

    def achieved() -> float:
        return sum(weight_at(g, g["steps"]) for g in groups.values()) / total0

    order = sorted(groups)
    while achieved() > target:
        best_key, best_w = None, -1.0
        for gkey in order:
            g = groups[gkey]
            if g["steps"] >= g["cap"]:
                continue
            cur = weight_at(g, g["steps"])
            # under the perf model a further step may buy no modeled time
            # (the roofline's floor): skip it, it only costs accuracy
            if cost_model == "perf_model" \
                    and not weight_at(g, g["steps"] + 1) < cur:
                continue
            if cur > best_w:
                best_key, best_w = gkey, cur
        if best_key is None:
            raise ValueError(
                f"budget unreachable: achieved ratio {achieved():.4f} > "
                f"target {target} with every layer at its feasibility cap "
                f"(min_dim={min_dim}, max_steps={max_steps}, "
                f"cost_model={cost_model!r})")
        groups[best_key]["steps"] += 1

    # one rule per (steps, backend) bucket (path regexes are disjoint full
    # matches, so bucket order does not matter); the backend is resolved
    # on the coupled path so both expert sides agree
    by_bucket: dict[tuple[int, str], list[str]] = {}
    for gkey in order:
        g = groups[gkey]
        if g["steps"] > 0:
            for p in g["paths"]:
                b = backend_for(experts_re.sub(".experts", p))
                by_bucket.setdefault((g["steps"], b), []).append(p)
    rules = []
    for s, b in sorted(by_bucket, key=lambda t: (-t[0], t[1])):
        paths = sorted(by_bucket[(s, b)])
        spec = dataclasses.replace(base, sparsity=1.0 - 2.0 ** (-s),
                                   backend=b)
        rules.append(PlanRule(
            match="|".join(re.escape(p) for p in paths), spec=spec,
            note=f"budget: {s} pow-2 steps (density 2^-{s}), backend {b}",
        ))
    rules.append(PlanRule(".*", DENSE, note="budget: keep dense"))
    return SparsityPlan(rules=tuple(rules))


def plan_density(plan: SparsityPlan, shapes: dict) -> float:
    """Achieved global weight-memory ratio (nnz / dense) of a plan over a
    shape table: what :func:`solve_budget` drives to its target."""
    shapes = _norm_shapes(shapes)
    num = den = 0.0
    for path, (m, k, c) in shapes.items():
        inst = plan.pattern_for(path, m, k)
        num += float(inst.nnz) * c
        den += float(m) * k * c
    return num / den


# ---------------------------------------------------------------------------
# Spectral certification
# ---------------------------------------------------------------------------

def _factor_graphs(inst: PatternInstance):
    """Named factor graphs of a pattern instance (empty for non-product
    patterns)."""
    if inst.layout is not None:
        lay = inst.layout
        return [("G_o", lay.graph_o), ("G_r", lay.graph_r),
                ("G_i", lay.graph_i), ("G_b", lay.graph_b)]
    if inst.chain_layout is not None:
        # the chain layout holds the realized samples: certify the graphs
        # the kernels index with
        return [(f"G_{i}", g)
                for i, g in enumerate(inst.chain_layout.graphs)]
    if inst.chain is not None:
        ps = inst.chain.sample()
        return [(f"G_{i}", g) for i, g in enumerate(ps.factors)]
    return []


_LAYER_PREFIX_RE = re.compile(r"^l(\d+)\.")


def certify(plan: SparsityPlan, shapes: dict) -> dict:
    """Spectral report: per layer, each sampled factor's second singular
    value against the Ramanujan bound ``sqrt(d_l-1) + sqrt(d_r-1)``.

    A factor is *proper* when it is sparse with both degrees >= 2; only
    proper factors are Ramanujan candidates (degree-1 factors are unions
    of matchings, complete ones have lambda_2 = 0).  ``summary.all_ok`` is
    True iff every proper factor meets its bound.  The report is JSON.

    The certified samples are the ones the model builds: a path with a
    decoder-layer prefix (``l{idx}.``) is materialized under that layer's
    seed offset (``offset_masked_seeds(1000 * (idx + 1))``, as
    ``models/transformer.py``), so masked-storage plans are certified on
    each layer's own graphs; vision paths carry no offset.
    """
    shapes = _norm_shapes(shapes)
    # the memo keyed on id(g) must pin the graph object: a freshly sampled
    # chain graph is otherwise collected between paths, and a recycled
    # address would return another graph's sigma
    sigma_cache: dict[int, tuple] = {}

    def sigma2(g) -> float:
        key = id(g)
        if key not in sigma_cache:
            sigma_cache[key] = (g, second_singular_value(g))
        return sigma_cache[key][1]

    layers = {}
    n_factors = n_proper = n_ok = 0
    all_ok = True
    for path in sorted(shapes):
        m, k, c = shapes[path]
        lm = _LAYER_PREFIX_RE.match(path)
        realized = plan
        if lm is not None:
            realized = plan.offset_masked_seeds(1000 * (int(lm.group(1)) + 1))
        spec = realized.resolve(path, m, k)
        inst = realized.pattern_for(path, m, k)
        entry = {
            "pattern": inst.name, "m": m, "k": k, "count": c,
            "sparsity": round(float(inst.sparsity), 6),
            "nnz": int(inst.nnz),
            "seed": spec.seed if spec.applies_to(m, k) else 0,
            "factors": [],
        }
        for name, g in _factor_graphs(inst):
            proper = (not g.is_complete) and g.is_biregular \
                and min(g.d_left, g.d_right) >= 2
            s2 = sigma2(g)
            bound = ramanujan_bound(g) if g.is_biregular else float("nan")
            ok = (not proper) or s2 <= bound + 1e-9
            entry["factors"].append({
                "factor": name,
                "shape": [g.n_left, g.n_right],
                "degrees": [int(g.d_left), int(g.d_right)]
                if g.is_biregular else None,
                "sigma2": round(s2, 6),
                "bound": round(bound, 6),
                "proper_ramanujan": proper,
                "within_bound": bool(ok),
            })
            n_factors += 1
            n_proper += int(proper)
            n_ok += int(ok)
            all_ok = all_ok and ok
        layers[path] = entry
    return {
        "summary": {
            "plan_fingerprint": plan.fingerprint(),
            "n_layers": len(layers),
            "n_factors": n_factors,
            "n_proper_ramanujan": n_proper,
            "n_within_bound": n_ok,
            "all_ok": bool(all_ok),
            "density": plan_density(plan, shapes),
        },
        "layers": layers,
    }
