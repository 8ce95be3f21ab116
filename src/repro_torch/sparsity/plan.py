"""SparsityPlan: declarative per-layer sparsity for a whole model.

The port of the plan core of ``repro/sparsity/plan.py``:

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

The reference's ``solve_budget``, ``certify`` and shape recording are not
yet ported.
"""
from __future__ import annotations

import dataclasses
import functools
import hashlib
import json
import re
from typing import Optional, Union

from repro_torch.core import canonicalize_factors

from .patterns import PatternInstance, SparsityConfig, make_pattern

__all__ = ["PatternSpec", "PlanRule", "SparsityPlan", "DENSE",
           "lower_config", "storage_kind"]

# storage capability of every backend name of the reference's registry
# (``repro/sparsity/api.py``): what a spec naming it stores.  None is
# masked storage.  The port runs compact and chain storage on its kernels
# whatever the name; masked storage is not yet ported.
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


DENSE = PatternSpec()


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
