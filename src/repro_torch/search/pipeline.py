"""Tier pipeline: the declarative vocabulary of the lower-bound cascade
(port of ``repro.search.pipeline``).

  * ``BoundTier``: one bound stage, with a cost class, a scope and the
    bound function.  ``all_pairs`` tiers map ``(q, index, cfg)`` to a
    ``(Q, N)`` bound matrix; ``pairwise`` tiers map packed survivor rows
    ``(qrows, crows, urows, lrows, cfg)`` to ``(P,)`` bounds.
  * ``Compaction``: the single gather point between the two scopes: the
    ``B`` best-bounded candidates per query are packed into rows.
  * ``VerificationPlan``: the ordered tiers, the compaction and the
    verification schedule (``"bound"`` sorts each round's pairs by bound
    before packing them into DTW launches, ``"index"`` keeps stripe
    order; neither changes results or ``n_dtw``).

Every tier returns a valid lower bound on ``DTW_w``; the executor
(``cascade.run_plan``) keeps their running elementwise maximum, so a loose
tier can cost work but never correctness.
"""

from __future__ import annotations

import dataclasses
import weakref
from typing import Callable


@dataclasses.dataclass(frozen=True)
class BoundTier:
    """One composable bound stage (see the module docstring)."""

    name: str
    cost: str
    scope: str
    fn: Callable

    def __post_init__(self):
        if self.scope not in ("all_pairs", "pairwise"):
            raise ValueError(f"unknown tier scope: {self.scope!r}")


@dataclasses.dataclass(frozen=True)
class Compaction:
    """Gather-compaction policy between all-pairs and pairwise tiers:
    ``budget`` overrides the per-query packed width (``None`` defers to
    ``CascadeConfig.budget``).  The JAX package's per-query refine limits
    (``limit_fn``) serve its distributed search, which is not ported."""

    budget: int | None = None


@dataclasses.dataclass(frozen=True)
class VerificationPlan:
    """Ordered tiers, compaction and verification schedule.  An
    ``all_pairs`` tier after a ``pairwise`` one is rejected: the pipeline
    has one compaction point.  (The JAX plan's ``verify_tile_p`` sizes
    Pallas pair tiles; the port's DTW kernel runs one block per pair.)
    """

    tiers: tuple[BoundTier, ...]
    compaction: Compaction = Compaction()
    schedule: str = "bound"

    def __post_init__(self):
        if self.schedule not in ("bound", "index"):
            raise ValueError(f"unknown schedule: {self.schedule!r}")
        seen_pairwise = False
        for t in self.tiers:
            if t.scope == "pairwise":
                seen_pairwise = True
            elif seen_pairwise:
                raise ValueError(
                    "all_pairs tier after a pairwise tier: the pipeline "
                    f"has one compaction point (tier {t.name!r})")

    @property
    def all_pairs_tiers(self) -> tuple[BoundTier, ...]:
        return tuple(t for t in self.tiers if t.scope == "all_pairs")

    @property
    def pairwise_tiers(self) -> tuple[BoundTier, ...]:
        return tuple(t for t in self.tiers if t.scope == "pairwise")


def bucket_pow2(x: int, floor: int) -> int:
    """Round ``x`` up to the next power-of-two bucket (>= ``floor``)."""
    b = floor
    while b < x:
        b <<= 1
    return b


_TIER_REGISTRY: dict[str, Callable[[], BoundTier]] = {}


def register_tier(name: str):
    """Decorator: register a zero-argument ``BoundTier`` factory."""

    def deco(factory: Callable[[], BoundTier]):
        _TIER_REGISTRY[name] = factory
        return factory

    return deco


def get_tier(name: str) -> BoundTier:
    try:
        return _TIER_REGISTRY[name]()
    except KeyError:
        raise KeyError(f"unknown tier {name!r}; registered: "
                       f"{sorted(_TIER_REGISTRY)}") from None


@register_tier("kim")
def _kim_tier() -> BoundTier:
    """O(1)/pair Kim bound from the index's features."""

    def fn(q, index, cfg):
        from repro_torch.search.cascade import lb_kim_tier

        return lb_kim_tier(q, index)

    return BoundTier("kim", cost="O(1)", scope="all_pairs", fn=fn)


@register_tier("bands")
def _bands_tier() -> BoundTier:
    """O(V^2)/pair elastic-bands tier (Alg. 1 lines 1-11), kernel K2 with
    ``bands_only=True``."""

    def fn(q, index, cfg):
        from repro_torch.search.cascade import bands_prefilter

        return bands_prefilter(q, index, cfg)

    return BoundTier("bands", cost="O(V^2)", scope="all_pairs", fn=fn)


@register_tier("enhanced_pairwise")
def _enhanced_pairwise_tier() -> BoundTier:
    """O(L)/pair LB_ENHANCED^V over the packed survivor rows (kernel
    K3)."""

    def fn(qrows, crows, urows, lrows, cfg):
        return cfg.pairwise_fn()(qrows, crows, urows, lrows, cfg.w, cfg.v)

    return BoundTier("enhanced_pairwise", cost="O(L)", scope="pairwise",
                     fn=fn)


@register_tier("enhanced_dense")
def _enhanced_dense_tier() -> BoundTier:
    """O(L)/pair LB_ENHANCED^V on every pair (kernel K2, full form)."""

    def fn(q, index, cfg):
        from repro_torch.search.cascade import enhanced_all_pairs

        return enhanced_all_pairs(q, index, cfg)

    return BoundTier("enhanced_dense", cost="O(L)", scope="all_pairs",
                     fn=fn)


def _front_tiers(cfg) -> list[BoundTier]:
    return [get_tier("kim")] if cfg.use_kim else []


def default_plan(cfg, *, schedule: str = "bound") -> VerificationPlan:
    """The paper's staged cascade: kim -> bands -> compact -> pairwise
    LB_ENHANCED (``cfg.use_kim=False`` drops Kim)."""
    tiers = _front_tiers(cfg) + [get_tier("bands"),
                                 get_tier("enhanced_pairwise")]
    return VerificationPlan(tiers=tuple(tiers), schedule=schedule)


def dense_plan(cfg, *, schedule: str = "bound") -> VerificationPlan:
    """Every pair pays the full O(L) tier (the baseline the staged plan is
    held against)."""
    tiers = _front_tiers(cfg) + [get_tier("enhanced_dense")]
    return VerificationPlan(tiers=tuple(tiers), schedule=schedule)


# choose_survivor_budget costs one cheap-tier pass and S*k uncut DTWs, so
# its bucket is memoised per index and re-estimated only when what the
# estimate depends on changes: the index (identity, size), w, k (tau is
# the k-th seed distance), the bound knobs and whether a candidate is
# excluded.  A weak reference to the series keeps a freed tensor whose
# id() is reused from inheriting a stale budget.
_BUDGET_CACHE: dict = {}
_BUDGET_CACHE_MAX = 64


def _budget_cache_key(index, cascade, k: int, exclude) -> tuple:
    return (id(index.series), index.n, cascade.w, k, cascade.v,
            cascade.use_kim, cascade.use_kernels, exclude is not None)


def resolve_adaptive_budget(q, index, cascade, k: int, exclude) -> int:
    """Memoised ``cascade.choose_survivor_budget``."""
    from repro_torch.search.cascade import choose_survivor_budget

    key = _budget_cache_key(index, cascade, k, exclude)
    hit = _BUDGET_CACHE.get(key)
    if hit is not None and hit[0]() is index.series:
        return hit[1]
    budget = choose_survivor_budget(q, index, cascade, k, exclude=exclude)
    if len(_BUDGET_CACHE) >= _BUDGET_CACHE_MAX:
        _BUDGET_CACHE.clear()
    _BUDGET_CACHE[key] = (weakref.ref(index.series), budget)
    return budget
