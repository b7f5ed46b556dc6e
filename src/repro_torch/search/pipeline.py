"""Tier pipeline: the declarative vocabulary of the lower-bound cascade
(port of ``repro.search.pipeline``).

  * ``BoundTier``: one bound stage, with a cost class, a scope and the
    bound function.  ``all_pairs`` tiers map ``(q, index, cfg)`` to a
    ``(Q, N)`` bound matrix; ``pairwise`` tiers map packed survivor rows
    ``(qrows, crows, urows, lrows, cfg)`` to ``(P,)`` bounds.  A tier fn
    that takes a ``live`` keyword receives the liveness mask (the store
    mask for all-pairs tiers, the refine limit for pairwise ones) and
    returns ``-inf`` for dead entries.
  * ``Compaction``: the single gather point between the two scopes: the
    ``B`` best-bounded candidates per query are packed into rows, and an
    optional ``limit_fn`` caps how many of them each query refines.
  * ``VerificationPlan``: the ordered tiers, the compaction and the
    verification schedule (``"bound"`` sorts each round's pairs by bound
    before packing them into DTW launches, ``"index"`` keeps stripe
    order; neither changes results or ``n_dtw``).

Every tier returns a valid lower bound on ``DTW_w``; the executor
(``cascade.run_plan``) keeps their running elementwise maximum, so a loose
tier can cost work but never correctness.

Tier -1 (``sketch``, kernel K7) is an all-pairs tier that reads the
index's int8 PAA feature store (``index.sk_lo/sk_hi``), never the series.
It scores every candidate (the store-level ``live`` mask is derived from
its bounds, so it never consumes the mask), prices as ``"O(S)"``, and on
an index without features returns the all-zero bound, which the planner
measures idle and drops.  ``TierStats`` is what the instrumented executor
(``run_plan(collect_stats=True)``) measures per tier for the planner
(search/planner.py).
"""

from __future__ import annotations

import dataclasses
import weakref
from typing import Callable

import numpy as np
import torch

Tensor = torch.Tensor


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
    """Gather-compaction policy between all-pairs and pairwise tiers.

    Attributes:
      budget: per-query packed width ``B``; ``None`` defers to
        ``CascadeConfig.budget``.
      limit_fn: optional ``(lb01, budget, k) -> (Q,)`` int refine limits:
        query ``i`` refines only its first ``limit[i]`` packed slots (the
        tightest), the rest keep their all-pairs bound.  ``None`` refines
        the whole packed width.
      width_scale: with a ``limit_fn`` the packed width is
        ``min(n, width_scale * B)``, headroom for limits above ``B``.
    """

    budget: int | None = None
    limit_fn: Callable | None = None
    width_scale: int = 2


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
    """Round ``x`` up to the next power-of-two bucket (>= ``floor``): the
    rule of the cascade's survivor budgets (floor 64) and the planner's
    committed budgets (floor 8)."""
    b = floor
    while b < x:
        b <<= 1
    return b


def tier_cost_weight(cost: str, L: int, v: int, w: int,
                     s: int = 16) -> float:
    """Per-pair work weight of a cost class (``"O(S)"``: ``s`` segments).
    Unrecognised classes price at ``O(L)``."""
    key = cost.replace(" ", "").upper()
    if key == "O(1)":
        return 1.0
    if key == "O(S)":
        return float(max(s, 1))
    if key == "O(V)":
        return float(max(v, 1))
    if key in ("O(V^2)", "O(V2)", "O(V*V)"):
        return float(max(v, 1)) ** 2
    if key == "O(L)":
        return float(max(L, 1))
    if key in ("O(L*W)", "O(LW)", "O(W*L)", "O(WL)"):
        return float(max(L, 1)) * float(max(min(w, L), 1))
    return float(max(L, 1))


@dataclasses.dataclass(frozen=True)
class TierStats:
    """Measured pruning mass and cost-weighted work per tier of one plan.

    ``run_plan(collect_stats=True)`` prices each tier against the seeds'
    threshold ``tau`` (the k-th seed distance bounds the final k-th best
    from above, so a pair whose running bound reaches ``tau`` is pruned;
    the crossing is charged to the tier whose fold took it across).

    Attributes:
      names / costs / scopes: per-tier labels, in plan order.
      mass: (T,) pairs whose running bound first reached ``tau`` at this
        tier.
      scored: (T,) pairs the tier scored (masked tiers score only live
        entries).
      work: (T,) ``scored * tier_cost_weight(cost)``.
      pairs: () measured (query, candidate) pairs, excluded ones removed.
      queries: () measured queries.
      survivors: (Q,) per-query candidates whose all-pairs bound stays
        below ``tau``.
    """

    names: tuple[str, ...]
    costs: tuple[str, ...]
    scopes: tuple[str, ...]
    mass: Tensor
    scored: Tensor
    work: Tensor
    pairs: Tensor
    queries: Tensor
    survivors: Tensor

    def mass_per_work(self) -> np.ndarray:
        """(T,) mass per unit of work (host side)."""
        w = np.maximum(host_array(self.work), 1e-30)
        return host_array(self.mass) / w

    def table(self) -> str:
        """Per-tier pricing table (host side)."""
        pairs = max(float(host_array(self.pairs)), 1.0)
        ratio = self.mass_per_work()
        mass, scored, work = (host_array(self.mass), host_array(self.scored),
                              host_array(self.work))
        rows = [f"{'tier':<20} {'cost':<8} {'scored':>9} {'mass':>9} "
                f"{'mass%':>7} {'work':>10} {'mass/work':>10}"]
        for i, name in enumerate(self.names):
            rows.append(
                f"{name:<20} {self.costs[i]:<8} {scored[i]:>9.0f} "
                f"{mass[i]:>9.0f} {100.0 * mass[i] / pairs:>6.1f}% "
                f"{work[i]:>10.3g} {ratio[i]:>10.3g}")
        return "\n".join(rows)


def host_array(x) -> np.ndarray:
    """A tensor, array or number as a float64 numpy array (host sync)."""
    if isinstance(x, Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype=np.float64)


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


def list_tiers() -> tuple[str, ...]:
    """Sorted names of every registered tier factory."""
    return tuple(sorted(_TIER_REGISTRY))


def registered_tiers() -> tuple[str, ...]:
    """Alias of ``list_tiers``."""
    return list_tiers()


def unregister_tier(name: str) -> bool:
    """Remove a registered tier factory; ``True`` if it was there (a
    second call is a no-op returning ``False``)."""
    return _TIER_REGISTRY.pop(name, None) is not None


@register_tier("sketch")
def _sketch_tier() -> BoundTier:
    """Tier -1: O(S)/pair int8 sketch bound (kernel K7).  Scores every
    candidate; all zeros on an index built without features."""

    def fn(q, index, cfg):
        if index.sk_lo is None:
            return torch.zeros((q.shape[0], index.n), dtype=torch.float32,
                               device=q.device)
        from repro_torch.kernels import ref as _ref
        from repro_torch.kernels.ops import sketch_bound_op
        from repro_torch.search.index import (
            sketch_query_means, sketch_segment_sizes)

        s = index.sk_lo.shape[1]
        qbar = sketch_query_means(q, s)
        seg = sketch_segment_sizes(index.length, s, device=q.device)
        op = sketch_bound_op if cfg.use_kernels else _ref.sketch_bound_ref
        return op(qbar, index.sk_lo, index.sk_hi, index.sk_scale, seg)

    return BoundTier("sketch", cost="O(S)", scope="all_pairs", fn=fn)


@register_tier("lb_improved")
def _lb_improved_tier() -> BoundTier:
    """Lemire's two-pass LB_Improved over the packed survivor rows (plain
    PyTorch, no kernel): LB_Keogh against the candidate's envelope plus
    LB_Keogh of the candidate against the envelope of the query projected
    onto it.  Registered, not in ``default_plan``."""

    def fn(qrows, crows, urows, lrows, cfg, *, live=None):
        from repro_torch.core.envelopes import envelope
        from repro_torch.core.lower_bounds import lb_keogh_env

        first = lb_keogh_env(qrows, urows, lrows)
        proj = torch.minimum(torch.maximum(qrows, lrows), urows)
        up, lp = envelope(proj, cfg.w)
        out = first + lb_keogh_env(crows, up, lp)
        if live is not None:
            out = torch.where(torch.as_tensor(live, device=out.device)
                              .bool().expand(out.shape), out, -float("inf"))
        return out

    return BoundTier("lb_improved", cost="O(L)", scope="pairwise", fn=fn)


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

    def fn(q, index, cfg, *, live=None):
        from repro_torch.search.cascade import bands_prefilter

        return bands_prefilter(q, index, cfg, live=live)

    return BoundTier("bands", cost="O(V^2)", scope="all_pairs", fn=fn)


@register_tier("enhanced_pairwise")
def _enhanced_pairwise_tier() -> BoundTier:
    """O(L)/pair LB_ENHANCED^V over the packed survivor rows (kernel
    K3)."""

    def fn(qrows, crows, urows, lrows, cfg, *, live=None):
        return cfg.pairwise_fn()(qrows, crows, urows, lrows, cfg.w, cfg.v,
                                 live=live)

    return BoundTier("enhanced_pairwise", cost="O(L)", scope="pairwise",
                     fn=fn)


@register_tier("enhanced_dense")
def _enhanced_dense_tier() -> BoundTier:
    """O(L)/pair LB_ENHANCED^V on every pair (kernel K2, full form)."""

    def fn(q, index, cfg, *, live=None):
        from repro_torch.search.cascade import enhanced_all_pairs

        return enhanced_all_pairs(q, index, cfg, live=live)

    return BoundTier("enhanced_dense", cost="O(L)", scope="all_pairs",
                     fn=fn)


def _front_tiers(cfg) -> list[BoundTier]:
    tiers = [get_tier("sketch")] if cfg.use_sketch else []
    return tiers + ([get_tier("kim")] if cfg.use_kim else [])


def default_plan(cfg, *, schedule: str = "bound") -> VerificationPlan:
    """The paper's staged cascade: [sketch ->] kim -> bands -> compact ->
    pairwise LB_ENHANCED (``cfg.use_sketch`` prepends the sketch tier,
    ``cfg.use_kim=False`` drops Kim)."""
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


def budget_cache_clear() -> None:
    _BUDGET_CACHE.clear()


def budget_cache_len() -> int:
    return len(_BUDGET_CACHE)


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
