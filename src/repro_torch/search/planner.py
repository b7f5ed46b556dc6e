"""Self-tuning tier planner: measured mass/cost plan optimisation (port of
``repro.search.planner``, without its distributed parts).

  1. **measure**: ``cascade.run_plan(collect_stats=True)`` prices every
     tier of a plan on real queries (``pipeline.TierStats``);
  2. **decide**: ``optimise_plan`` drops tiers whose realised mass is at
     most ``drop_mass_frac`` of the measured pairs, reorders the rest by
     mass per work (within each scope), shrinks the compaction budget to
     a power-of-two bucket of the measured survivor mass and, where that
     leaves slack, adds a constant refine limit (a multiple of 8) whose
     masked slots the pairwise kernel skips;
  3. **commit**: the decision is cached per (store, window, k, config,
     base plan, planner thresholds), so ``engine.nn_search`` and
     ``build_index(calibrate=...)`` measure once and every later search
     runs the optimised plan.

A planner plan only removes bound work; unrefined pairs keep a valid
looser bound, so the neighbours are those of the base plan.  The
decision is a function of host numbers only (the ``TierStats`` counts),
which is what lets it equal the JAX package's on the same data.
"""

from __future__ import annotations

import dataclasses
import math
import warnings
import weakref
from typing import Callable

import numpy as np
import torch

from repro_torch.search.pipeline import (
    TierStats,
    VerificationPlan,
    bucket_pow2,
    default_plan,
    host_array,
)

Tensor = torch.Tensor

# committed budgets snap to powers of two (floor 8), refine limits to
# multiples of 8
_BUCKET_FLOOR = 8


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@dataclasses.dataclass(frozen=True)
class PlannerConfig:
    """Decision thresholds for ``optimise_plan``.

    Attributes:
      drop_mass_frac: drop a tier whose realised mass is at most this
        fraction of the measured pairs (0.0: only measured-idle tiers).
      limit_safety: headroom on the measured per-query survivor mass
        before bucketing the budget and the refine limit.
      limit_slack: attach a refine limit only when it is at most this
        fraction of the committed budget.
      reorder: reorder the kept tiers by measured mass per work.
      calibrate_block: queries of a cold ``nn_search`` that run the base
        plan to measure it.
    """

    drop_mass_frac: float = 0.0
    limit_safety: float = 1.3
    limit_slack: float = 0.75
    reorder: bool = True
    calibrate_block: int = 8


@dataclasses.dataclass(frozen=True)
class PlanDecision:
    """One committed plan rewrite and the measurement behind it.

    Attributes:
      plan: the optimised ``VerificationPlan``.
      base: the plan that was measured.
      stats: the host-side ``TierStats`` of the measurement.
      dropped: tier names removed from the base plan.
      order: committed tier names, in order.
      budget: committed compaction budget (``None``: base untouched).
      limit: committed constant refine limit (``None``: no mask).
    """

    plan: VerificationPlan
    base: VerificationPlan
    stats: TierStats
    dropped: tuple[str, ...]
    order: tuple[str, ...]
    budget: int | None
    limit: int | None

    def summary(self) -> str:
        parts = [" -> ".join(self.order) if self.order else "<no tiers>"]
        if self.dropped:
            parts.append(f"dropped: {', '.join(self.dropped)}")
        if self.budget is not None:
            parts.append(f"budget={self.budget}")
        if self.limit is not None:
            parts.append(f"limit={self.limit}")
        return "   ".join(parts)


def _host_stats(stats: TierStats) -> TierStats:
    """The stats as host numpy values (one sync)."""
    return dataclasses.replace(
        stats, mass=host_array(stats.mass),
        scored=host_array(stats.scored), work=host_array(stats.work),
        pairs=float(host_array(stats.pairs)),
        queries=float(host_array(stats.queries)),
        survivors=host_array(stats.survivors))


def optimise_plan(base: VerificationPlan, stats: TierStats, *, n: int,
                  k: int, base_budget: int,
                  pcfg: PlannerConfig | None = None) -> PlanDecision:
    """Rewrite ``base`` from its measured ``TierStats`` (module
    docstring).  ``n`` clamps the committed budget; ``base_budget`` is the
    packed width the base plan would use, which the planner only
    shrinks."""
    pcfg = pcfg if pcfg is not None else PlannerConfig()
    st = _host_stats(stats)
    names = tuple(t.name for t in base.tiers)
    if len(set(names)) != len(names):
        raise ValueError(
            f"duplicate tier names in plan {names!r}: the planner keys "
            "decisions by name; give each tier a distinct one")
    by_name = {t.name: t for t in base.tiers}
    if tuple(st.names) != names:
        raise ValueError(
            f"stats tiers {st.names!r} do not match plan tiers "
            f"{names!r}; price the plan you are optimising")

    pairs = max(st.pairs, 1.0)
    ratio = st.mass_per_work()
    if not np.any(st.mass > 0):
        # no tier crossed the threshold anywhere (useless bounds, or
        # tau = 0 on a store with duplicates): a zero measurement cannot
        # tell the two apart, so the base plan is committed unchanged
        return PlanDecision(plan=base, base=base, stats=st, dropped=(),
                            order=names, budget=None, limit=None)
    keep, dropped = [], []
    for i, name in enumerate(st.names):
        if st.mass[i] <= pcfg.drop_mass_frac * pairs:
            dropped.append(name)
        else:
            keep.append((i, name))
    # a kept pairwise tier needs a kept all-pairs tier to select its
    # survivors: keep the best-measured cheap tier even at zero mass
    if (any(st.scopes[i] == "pairwise" for i, _ in keep)
            and not any(st.scopes[i] == "all_pairs" for i, _ in keep)):
        ap = [i for i, s in enumerate(st.scopes) if s == "all_pairs"]
        if ap:
            best = max(ap, key=lambda i: (st.mass[i], ratio[i], -i))
            keep.append((best, st.names[best]))
            dropped.remove(st.names[best])
    if pcfg.reorder:
        keep.sort(key=lambda it: (st.scopes[it[0]] == "pairwise",
                                  -ratio[it[0]], it[0]))
    else:
        keep.sort(key=lambda it: it[0])
    tiers = tuple(by_name[name] for _, name in keep)

    comp = base.compaction
    budget = limit = None
    if any(t.scope == "pairwise" for t in tiers):
        smax = float(np.max(st.survivors)) if np.size(st.survivors) else 0.0
        cap = max(int(math.ceil(smax * pcfg.limit_safety)), 4 * k,
                  _BUCKET_FLOOR)
        budget = min(base_budget, bucket_pow2(cap, _BUCKET_FLOOR), n)
        limit_c = min(_round_up(cap, 8), budget)
        new_comp = dataclasses.replace(comp, budget=budget)
        if comp.limit_fn is not None:
            new_comp = dataclasses.replace(
                new_comp, limit_fn=_compose_limit(comp.limit_fn, limit_c))
            limit = limit_c
        elif limit_c <= pcfg.limit_slack * budget:
            new_comp = dataclasses.replace(
                new_comp, limit_fn=_const_limit(limit_c), width_scale=1)
            limit = limit_c
        comp = new_comp
    plan = dataclasses.replace(base, tiers=tiers, compaction=comp)
    return PlanDecision(plan=plan, base=base, stats=st,
                        dropped=tuple(dropped),
                        order=tuple(t.name for t in tiers), budget=budget,
                        limit=limit)


def calibration_sample(n: int, sample: int) -> np.ndarray:
    """Strided calibration indices (sorted, unique): a contiguous block
    would measure only the first classes of a class-ordered batch."""
    s = max(1, min(sample, n))
    return np.unique(np.round(np.linspace(0, n - 1, s)).astype(np.int64))


def _const_limit(limit: int) -> Callable:
    def limit_fn(lb01, budget, k):
        return torch.full((lb01.shape[0],), limit, dtype=torch.int64,
                          device=lb01.device)

    return limit_fn


def _compose_limit(prev_fn: Callable, limit: int) -> Callable:
    def limit_fn(lb01, budget, k):
        prev = torch.as_tensor(prev_fn(lb01, budget, k), device=lb01.device)
        return torch.clamp(prev, max=limit).to(torch.int64)

    return limit_fn


# ---------------------------------------------------------------------------
# commit cache: one decision per (store, window, k, config, base plan)
# ---------------------------------------------------------------------------

# Entries hold a weak reference to the store's series tensor and hit only
# while that tensor is alive.  No leave-one-out flag in the key: a plan
# calibrated with exclusion is conservative for plain queries.
_PLAN_CACHE: dict = {}
_PLAN_CACHE_MAX = 64


def _plan_sig(plan: VerificationPlan) -> tuple:
    comp = plan.compaction
    return (tuple(t.name for t in plan.tiers), plan.schedule, comp.budget,
            comp.width_scale, comp.limit_fn)


def _plan_cache_key(index, cascade, k: int, base: VerificationPlan,
                    pcfg: PlannerConfig | None) -> tuple:
    pcfg = pcfg if pcfg is not None else PlannerConfig()
    return (id(index.series), index.n, cascade.w, k, cascade.v,
            cascade.use_kim, cascade.use_sketch, cascade.use_kernels,
            cascade.survivor_budget, index.sk_lo is not None,
            index.live is not None, _plan_sig(base),
            dataclasses.astuple(pcfg))


def plan_cache_clear() -> None:
    _PLAN_CACHE.clear()


def plan_cache_len() -> int:
    return len(_PLAN_CACHE)


def lookup_plan(index, cascade, k: int, base: VerificationPlan,
                pcfg: PlannerConfig | None = None) -> PlanDecision | None:
    """The committed decision for this store, config and base plan."""
    hit = _PLAN_CACHE.get(_plan_cache_key(index, cascade, k, base, pcfg))
    if hit is not None and hit[0]() is index.series:
        return hit[1]
    return None


def commit_plan(index, cascade, k: int, base: VerificationPlan,
                decision: PlanDecision,
                pcfg: PlannerConfig | None = None) -> PlanDecision:
    """Cache a decision for later searches."""
    if len(_PLAN_CACHE) >= _PLAN_CACHE_MAX:
        _PLAN_CACHE.clear()
    key = _plan_cache_key(index, cascade, k, base, pcfg)
    _PLAN_CACHE[key] = (weakref.ref(index.series), decision)
    return decision


def base_budget_for(index, cascade, k: int, base: VerificationPlan) -> int:
    """The packed width the base plan would refine."""
    if base.compaction.budget is not None:
        return max(1, min(index.n, base.compaction.budget))
    return cascade.budget(index.n, k)


def calibrate_plan(q, index, cascade, k: int = 1, *,
                   plan: VerificationPlan | None = None, exclude=None,
                   sample: int = 8,
                   pcfg: PlannerConfig | None = None) -> PlanDecision:
    """Measure, decide and commit in one call on a ``sample``-query
    strided block of ``q``.  A measurement under tripped guards commits
    the base plan unchanged, with a ``GuardWarning``."""
    from repro_torch.search.cascade import run_plan
    from repro_torch.search.guards import GuardWarning
    from repro_torch.search.pipeline import resolve_adaptive_budget

    base = plan if plan is not None else default_plan(cascade)
    q = torch.as_tensor(q, dtype=torch.float32, device=index.device)
    pick = torch.as_tensor(calibration_sample(q.shape[0], sample),
                           device=q.device)
    qs = q[pick]
    ex = None
    if exclude is not None:
        ex = torch.as_tensor(exclude, device=q.device).to(torch.int64)[pick]
    cascade_r = cascade
    if (cascade.adaptive_budget and cascade.survivor_budget is None
            and base.compaction.budget is None):
        budget = resolve_adaptive_budget(qs, index, cascade, k, ex)
        cascade_r = dataclasses.replace(cascade, survivor_budget=budget)
    cres = run_plan(qs, index, cascade_r, base, k=k, exclude=ex,
                    collect_stats=True)
    trip = cres.guard.tripped() if cres.guard is not None else ()
    if trip:
        warnings.warn(
            "plan calibration measured under tripped exactness guards "
            f"({', '.join(trip)}); committing the base plan unchanged",
            GuardWarning, stacklevel=2)
        decision = PlanDecision(
            plan=base, base=base, stats=_host_stats(cres.stats), dropped=(),
            order=tuple(t.name for t in base.tiers), budget=None,
            limit=None)
    else:
        decision = optimise_plan(
            base, cres.stats, n=index.n, k=k,
            base_budget=base_budget_for(index, cascade_r, k, base),
            pcfg=pcfg)
    return commit_plan(index, cascade, k, base, decision, pcfg)
