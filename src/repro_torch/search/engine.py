"""Exact NN-DTW search engine with lower-bound pruning (port of
``repro.search.engine``).

  1. ``cascade.run_plan`` bounds every (query, candidate) pair and
     verifies ``k`` seeds per query;
  2. the seeds warm-start each query's top-k, and the other candidates
     are sorted by ascending bound;
  3. banded DTW (kernel K4) verifies them in rounds of ``Q *
     verify_chunk`` pairs, each query's current k-th best threaded into
     its pairs' cutoff;
  4. a query stops once its k-th best is <= its smallest unverified bound
     (the exactness certificate: bounds never exceed the true DTW).

Rounds are work-conserving: a round's flat batch is striped over the
queries not yet done, so stragglers take the slots finished queries no
longer need (up to ``8 * verify_chunk`` ranks per query and round).  With
``plan.schedule == "bound"`` the batch is sorted by bound before it is
packed into the DTW launch and the results are scattered back; the order
changes no result and no ``n_dtw``.

``lax.while_loop`` becomes a Python loop of at most ``max_rounds``
rounds with one host sync per round (``done.all()``) to decide whether to
go on; everything else stays on the device, the round guards included
(search/guards.py: admissibility of every verified slot, the accounting
mirror of the per-query ``n_dtw`` increments, the NaN gate on DTW
values), which are read once after the loop.  Every sort is stable, as
``jnp.argsort`` is, and every top-k is a stable sort cut to ``k``, so
ties resolve as in the JAX package and the neighbour ids and per-query
``n_dtw`` agree with it.
"""

from __future__ import annotations

import dataclasses
import warnings

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels.ops import dtw_band_op
from repro_torch.kernels.ref import dtw_band_ref
from repro_torch.kernels.tiling import unpermute_pairs
from repro_torch.search.cascade import (
    CascadeConfig,
    compute_bounds,
    run_plan,
    smallest_k,
)
from repro_torch.search import guards as _g
from repro_torch.search import planner as _planner
from repro_torch.search.index import DTWIndex
from repro_torch.search.pipeline import (
    TierStats,
    VerificationPlan,
    default_plan,
    dense_plan,
    resolve_adaptive_budget,
)
from repro_torch.search.planner import PlannerConfig

Tensor = torch.Tensor

_INF = float("inf")


@dataclasses.dataclass(frozen=True, eq=False)
class SearchResult:
    """Exact k-NN under DTW_w plus pruning accounting.

    Attributes:
      dists: (Q, k) squared-cost DTW distances, ascending.
      idx:   (Q, k) int32 candidate indices into the store.
      n_dtw: (Q,) int32 DTW verifications the engine counted.
      lb:    (Q, N) the cascade's bound matrix.
    """

    dists: Tensor
    idx: Tensor
    n_dtw: Tensor
    lb: Tensor

    def pruning_power(self, n: int | None = None) -> Tensor:
        n = n if n is not None else self.lb.shape[1]
        return 1.0 - self.n_dtw.to(torch.float32) / n


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Engine knobs on top of the cascade config.

    Attributes:
      cascade: the lower-bound cascade configuration.
      verify_chunk: DTW verifications per query and round; a round is one
        kernel launch of ``Q * verify_chunk`` pairs.
      k: neighbours to return.
      auto_plan: calibrate-then-commit (staged cascades): a cold search
        runs a strided block of ``planner.calibrate_block`` queries under
        the base plan with stats on, commits the planner's plan, and runs
        the rest of the batch, and every later search against the store,
        under it (search/planner.py).  Neighbours are the base plan's.
      planner: decision thresholds (``None``: ``PlannerConfig()``).
      guards: exactness guards (search/guards.py); ``None`` is the
        default-on ``GuardConfig()``, ``GuardConfig(enabled=False)`` opts
        out, ``REPRO_FORCE_GUARDS=1`` forces them on.
    """

    cascade: CascadeConfig
    verify_chunk: int = 32
    k: int = 1
    auto_plan: bool = False
    planner: PlannerConfig | None = None
    guards: _g.GuardConfig | None = None


@dataclasses.dataclass(frozen=True)
class SearchStats:
    """Pruning report of one search (``nn_search(with_stats=True)``).

    Attributes:
      tiers: the measured ``TierStats`` (the base plan's when the search
        calibrated, the committed decision's otherwise).
      plan_tiers: committed tier names, in order.
      schedule: committed verification schedule.
      dropped: tiers the planner removed.
      budget / limit: committed compaction budget / refine limit.
      calibrated: whether a planner decision produced the plan.
      n_dtw: (Q,) DTW verifications per query.
      n: store size.
      guards: the merged ``GuardReport`` (``None`` with guards off).
      degraded: whether a tripped guard made the engine serve the batch
        by plain brute force.
    """

    tiers: TierStats | None
    plan_tiers: tuple[str, ...]
    schedule: str
    dropped: tuple[str, ...]
    budget: int | None
    limit: int | None
    calibrated: bool
    n_dtw: Tensor
    n: int
    guards: _g.GuardReport | None = None
    degraded: bool = False

    def pruning_power(self) -> np.ndarray:
        return 1.0 - self.n_dtw.cpu().numpy() / self.n

    def table(self) -> str:
        nd = self.n_dtw.cpu().numpy()
        lines = [self.tiers.table() if self.tiers is not None else
                 "(no tier measurement)", "-" * 78]
        commit = (f"plan: {' -> '.join(self.plan_tiers) or '<no tiers>'} "
                  f"[{self.schedule}]")
        if self.dropped:
            commit += f"   dropped: {', '.join(self.dropped)}"
        if self.budget is not None:
            commit += f"   budget={self.budget}"
        if self.limit is not None:
            commit += f"   limit={self.limit}"
        if self.calibrated:
            commit += "   (planner-committed)"
        lines.append(commit)
        lines.append(
            f"n_dtw: {int(nd.sum())} of {nd.size * self.n} pairs verified "
            f"(mean pruning power {float(np.mean(self.pruning_power())):.1%})")
        if self.guards is not None:
            gline = self.guards.summary()
            if self.degraded:
                gline += "   [DEGRADED: plain brute force served]"
            lines.append(gline)
        return "\n".join(lines)


def _queries(index: DTWIndex, queries, sanitize: bool):
    q = torch.as_tensor(queries, dtype=torch.float32, device=index.device)
    if q.dim() != 2 or q.shape[1] != index.length:
        raise ValueError(f"queries: expected (Q, {index.length}), got "
                         f"{tuple(q.shape)}")
    q, hyg = _g.validate_series(q, name="query", sanitize=sanitize)
    return q.contiguous(), hyg


def _exclude(index: DTWIndex, exclude) -> Tensor | None:
    if exclude is None:
        return None
    return torch.as_tensor(exclude, device=index.device).to(torch.int64)


def _resolve_cascade(q: Tensor, index: DTWIndex, cascade: CascadeConfig,
                     k: int, exclude: Tensor | None,
                     plan: VerificationPlan) -> CascadeConfig:
    """The cascade with the memoised adaptive survivor budget."""
    if (cascade.staged and cascade.adaptive_budget
            and cascade.survivor_budget is None
            and plan.compaction.budget is None):
        budget = resolve_adaptive_budget(q, index, cascade, k, exclude)
        return dataclasses.replace(cascade, survivor_budget=budget)
    return cascade


def nn_search(index: DTWIndex, queries, cfg: EngineConfig, *,
              exclude=None, plan: VerificationPlan | None = None,
              with_stats: bool = False, with_guards: bool = False,
              sanitize: bool = False):
    """Exact k-NN-DTW for a ``(Q, L)`` query batch on the index's device.

    ``exclude`` ((Q,) ints) removes one candidate per query (leave-one-
    out evaluation).  ``plan`` defaults to ``default_plan(cfg.cascade)``
    (``dense_plan`` for an unstaged cascade); with ``cfg.auto_plan`` it is
    the base plan the calibration measures.  A query batch holding NaN/Inf
    raises unless ``sanitize=True`` masks it.

    ``with_stats`` returns ``(SearchResult, SearchStats)`` (staged
    cascades only); otherwise ``with_guards`` returns ``(SearchResult,
    GuardReport)``.

    Degradation: when a trigger guard trips, the batch is served by brute
    force through the plain versions (``use_kernels=False``: a tripped
    guard means the bounds or the kernel route cannot be trusted), with a
    ``GuardWarning`` and ``degraded`` counted.  A clean run never gets
    there.
    """
    q, hyg = _queries(index, queries, sanitize)
    exclude = _exclude(index, exclude)
    Q = q.shape[0]
    N = index.n
    k = min(cfg.k, N)
    cascade = cfg.cascade
    if plan is None:
        plan = default_plan(cascade) if cascade.staged \
            else dense_plan(cascade)
    if with_stats and not cascade.staged:
        raise ValueError("with_stats reports on the staged tier pipeline: "
                         "it needs cascade.staged=True")
    pcfg = cfg.planner if cfg.planner is not None else PlannerConfig()
    decision = None
    stats = None
    if cfg.auto_plan and cascade.staged and Q > 0:
        decision = _planner.lookup_plan(index, cascade, k, plan, pcfg)
        if decision is not None:
            res, _, guard = _search(index, q, cfg, decision.plan, exclude)
            stats = decision.stats
        else:
            # calibrate: a strided block runs the base plan with stats on
            # (its bound pass is the measurement), the rest commits
            pick = _planner.calibration_sample(Q, pcfg.calibrate_block)
            rest = np.setdiff1d(np.arange(Q), pick)
            pick_t = torch.as_tensor(pick, device=q.device)
            qa = q[pick_t]
            ex_a = None if exclude is None else exclude[pick_t]
            cascade_a = _resolve_cascade(qa, index, cascade, k, ex_a, plan)
            res_a, stats, guard = _search(index, qa, cfg, plan, ex_a,
                                          cascade=cascade_a,
                                          collect_stats=True)
            decision = _planner.optimise_plan(
                plan, stats, n=N, k=k,
                base_budget=_planner.base_budget_for(index, cascade_a, k,
                                                     plan),
                pcfg=pcfg)
            _planner.commit_plan(index, cascade, k, plan, decision, pcfg)
            if rest.size:
                rest_t = torch.as_tensor(rest, device=q.device)
                ex_b = None if exclude is None else exclude[rest_t]
                res_b, _, guard_b = _search(index, q[rest_t], cfg,
                                            decision.plan, ex_b)
                if guard is not None and guard_b is not None:
                    guard = guard.merge(guard_b)
                inv = torch.as_tensor(
                    np.argsort(np.concatenate([pick, rest])),
                    device=q.device)
                res = SearchResult(
                    dists=torch.cat([res_a.dists, res_b.dists])[inv],
                    idx=torch.cat([res_a.idx, res_b.idx])[inv],
                    n_dtw=torch.cat([res_a.n_dtw, res_b.n_dtw])[inv],
                    lb=torch.cat([res_a.lb, res_b.lb])[inv])
            else:
                res = res_a
        committed = decision.plan
    else:
        res, stats, guard = _search(index, q, cfg, plan, exclude,
                                    collect_stats=with_stats)
        committed = plan

    # ---- degradation ladder layer 2 (search/guards.py) ------------------
    gcfg = _g.resolve_guards(cfg.guards)
    if hyg.any() and guard is not None:
        guard = guard.merge(_g.hygiene_to_report(hyg, q.device))
    degraded = False
    trip = guard.tripped() if guard is not None else ()   # one host sync
    if trip and gcfg.degrade:
        warnings.warn(
            f"exactness guards tripped ({', '.join(trip)}): serving this "
            "query batch by brute force through the plain versions "
            "(bounds and kernel route untrusted); see SearchStats.guards",
            _g.GuardWarning, stacklevel=2)
        bf_d, bf_i = brute_force(index, q, cascade.w, k=k, exclude=exclude,
                                 use_kernels=False)
        res = SearchResult(dists=bf_d, idx=bf_i,
                           n_dtw=torch.full((Q,), N, dtype=torch.int32,
                                            device=q.device),
                           lb=res.lb)
        guard = dataclasses.replace(guard, degraded=guard.degraded + 1.0)
        degraded = True

    if not with_stats:
        if with_guards:
            return res, (guard if guard is not None
                         else _g.GuardReport.zeros(q.device))
        return res
    report = SearchStats(
        tiers=stats, plan_tiers=tuple(t.name for t in committed.tiers),
        schedule=committed.schedule,
        dropped=decision.dropped if decision is not None else (),
        budget=decision.budget if decision is not None else None,
        limit=decision.limit if decision is not None else None,
        calibrated=decision is not None, n_dtw=res.n_dtw, n=N,
        guards=guard, degraded=degraded)
    return res, report


def _search(index: DTWIndex, q: Tensor, cfg: EngineConfig,
            plan: VerificationPlan, exclude: Tensor | None, *,
            cascade: CascadeConfig | None = None,
            collect_stats: bool = False
            ) -> tuple[SearchResult, TierStats | None,
                       _g.GuardReport | None]:
    """One engine pass under one plan.  ``cascade`` is the budget-resolved
    config (``None`` resolves it here).  Returns the result, the tier
    stats (with ``collect_stats``) and the merged guard report (``None``
    with guards off)."""
    Q = q.shape[0]
    N = index.n
    k = min(cfg.k, N)
    M = min(cfg.verify_chunk, N)
    if cascade is None:
        cascade = _resolve_cascade(q, index, cfg.cascade, k, exclude, plan)
    w = cascade.w
    dev = q.device
    dtw_fn = cascade.dtw_fn()
    qarange = torch.arange(Q, device=dev)
    g = _g.resolve_guards(cfg.guards)
    gon = g.enabled

    tier_stats = None
    guard0 = None
    if cascade.staged:
        cres = run_plan(q, index, cascade, plan, k=k, dtw_fn=dtw_fn,
                        exclude=exclude, collect_stats=collect_stats,
                        guards=g)
        tier_stats, guard0 = cres.stats, cres.guard
        lb = cres.lb
        # the seeds are verified: they warm-start the top-k and leave the
        # unverified ordering
        sel = torch.sort(cres.seed_d, dim=1, stable=True).indices
        best_d = cres.seed_d.gather(1, sel)
        best_i = cres.seed_idx.gather(1, sel)
        n_dtw = torch.full((Q,), k, dtype=torch.int64, device=dev)
        if gon and g.finite_gates:
            # a gated (+inf) seed was never really verified: its bound
            # stays in the ordering so the rounds verify it
            cur = lb.gather(1, cres.seed_idx)
            lb_order = lb.scatter(1, cres.seed_idx, torch.where(
                torch.isfinite(cres.seed_d), _INF, cur))
        else:
            lb_order = lb.scatter(1, cres.seed_idx, _INF)
    else:
        lb = compute_bounds(q, index, cascade, k=k, plan=plan)
        best_d = torch.full((Q, k), _INF, dtype=torch.float32, device=dev)
        best_i = torch.full((Q, k), -1, dtype=torch.int64, device=dev)
        n_dtw = torch.zeros((Q,), dtype=torch.int64, device=dev)
        lb_order = lb
    if exclude is not None:
        lb = lb.index_put((qarange, exclude), torch.tensor(_INF, device=dev))
        lb_order = lb_order.index_put((qarange, exclude),
                                      torch.tensor(_INF, device=dev))

    order = torch.sort(lb_order, dim=1, stable=True).indices       # (Q, N)
    slb = lb_order.gather(1, order)
    slb_pad = F.pad(slb, (0, 1), value=_INF)
    P = Q * M
    T_max = min(N, 8 * M)
    jarange = torch.arange(P, device=dev)
    t = torch.arange(T_max, device=dev)
    max_rounds = -(-Q * N // P) + 2
    bound_sched = plan.schedule == "bound"
    cursor = torch.zeros((Q,), dtype=torch.int64, device=dev)
    # round guards accumulate on the device: admissibility checked, viol,
    # gap; accounting checked, viol; gated DTW values
    gacc = torch.zeros((6,), dtype=torch.float32, device=dev)
    hook_cnt = _g.fault_hook("engine_count")
    # queries whose seeded k-th best already certifies never enter a round
    done = best_d[:, k - 1] <= slb_pad[:, 0]

    for _ in range(max_rounds):
        if bool(done.all()):                          # the round's host sync
            break
        n_un = (~done).sum().clamp(min=1)
        quota = torch.clamp(P // n_un, max=T_max)     # ranks per query
        qorder = torch.sort(done.to(torch.uint8), stable=True).indices
        pos = torch.sort(qorder, stable=True).indices  # query -> stripe
        qi = qorder[jarange % n_un]                   # (P,) slot query
        stripe = jarange // n_un
        rank = cursor[qi] + stripe
        valid = (~done[qi]) & (rank < N) & (stripe < quota)
        rank_c = rank.clamp(max=N - 1)
        cidx = order[qi, rank_c]                      # candidate ids
        slbv = slb[qi, rank_c]
        valid = valid & _g.verification_eligible(slbv)
        lbv = torch.where(valid, slbv, _INF)
        kth0 = best_d[:, k - 1]
        if bound_sched:
            # loosest bounds pack together; invalid slots sort last and
            # get a -inf cutoff so they die before sweeping
            perm = torch.sort(lbv, stable=True).indices
            cut = torch.where(valid, kth0[qi], -_INF)[perm]
            dp = dtw_fn(q[qi[perm]], index.series[cidx[perm]], w, cut)
            d = unpermute_pairs(perm, dp)
        else:
            d = dtw_fn(q[qi], index.series[cidx], w, kth0[qi])
        if gon and g.finite_gates:
            d, gated = _g.finite_gate_dtw(d, valid=valid)
            gacc[5] += gated
        d = torch.where(valid, d, _INF)
        if gon and g.admissibility:
            # every verified slot is an admissibility sample
            ac, av, ag = _g.admissibility_check(lbv, d, g.rtol, g.atol,
                                                valid=valid)
            gacc[0] += ac
            gacc[1] += av
            gacc[2] = torch.maximum(gacc[2], ag)
        # per-query gather of this round's results (stripe layout)
        slots = pos[:, None] + t[None, :] * n_un      # (Q, T_max)
        ok = (t[None, :] < quota) & (slots < P)
        slots_c = slots.clamp(max=P - 1)
        gd = torch.where(ok & (qi[slots_c] == qarange[:, None]),
                         d[slots_c], _INF)
        gi = cidx[slots_c]
        alld = torch.cat([best_d, gd], dim=1)
        alli = torch.cat([best_i, gi], dim=1)
        sel = smallest_k(alld, k)
        best_d = alld.gather(1, sel)
        best_i = alli.gather(1, sel)
        # a slot is a necessary verification if its bound still beats the
        # post-round k-th best or it entered the top-k (the sequential
        # loop's count, the paper's pruning-power numerator)
        kth1 = best_d[:, k - 1]
        inc = (valid & ((lbv < kth1[qi]) | (d <= kth1[qi]))).to(torch.int64)
        seg = torch.zeros((Q,), dtype=torch.int64, device=dev)
        seg = seg.index_add(0, qi, inc)
        if hook_cnt is not None:
            seg = hook_cnt(seg)
        if gon and g.accounting:
            # the per-query increments must conserve the flat count
            gacc[3] += 1.0
            gacc[4] += (seg.sum() != inc.sum()).to(torch.float32)
        n_dtw = n_dtw + seg
        cursor = torch.clamp(cursor + torch.where(~done, quota, 0), max=N)
        next_lb = slb_pad[qarange, cursor]
        done = done | (best_d[:, k - 1] <= next_lb) | (cursor >= N)
    guard = None
    if gon:
        guard = dataclasses.replace(
            _g.GuardReport.zeros(dev),
            admiss_checked=gacc[0], admiss_viol=gacc[1], admiss_gap=gacc[2],
            account_checked=gacc[3], account_viol=gacc[4],
            nonfinite_dtw=gacc[5])
        if g.accounting:
            # every query verified at least its seeds (staged) and never
            # more than the store
            floor = k if cascade.staged else 0
            bv = ((n_dtw > N) | (n_dtw < floor)).sum().to(torch.float32)
            guard = dataclasses.replace(
                guard, account_checked=guard.account_checked + float(Q),
                account_viol=guard.account_viol + bv)
        if guard0 is not None:
            guard = guard0.merge(guard)
    return (SearchResult(dists=best_d, idx=best_i.to(torch.int32),
                         n_dtw=n_dtw.to(torch.int32), lb=lb),
            tier_stats, guard)


def classify(index: DTWIndex, queries, cfg: EngineConfig, *,
             exclude=None) -> tuple[Tensor, SearchResult]:
    """k-NN-DTW classification: majority vote over the k neighbours
    (lowest label wins a tied vote)."""
    res = nn_search(index, queries, cfg, exclude=exclude)
    votes = index.labels[res.idx.long()].long().clamp(min=0)       # (Q, k)
    n_cls = int(index.labels.max()) + 1 if index.labels.numel() else 1
    counts = torch.zeros((votes.shape[0], max(n_cls, 1)), dtype=torch.int64,
                         device=votes.device)
    counts.scatter_add_(1, votes, torch.ones_like(votes))
    return counts.argmax(dim=1).to(torch.int32), res


def brute_force(index: DTWIndex, queries, w: int, k: int = 1, *,
                exclude=None, use_kernels: bool = True,
                chunk: int = 512) -> tuple[Tensor, Tensor]:
    """Unpruned exact k-NN: ``(dists (Q, k), idx (Q, k) int32)``.

    Chunked over candidates with a running top-k merge, so peak memory is
    O(Q * chunk * L).  ``use_kernels=False`` verifies with the plain DTW.
    """
    q, _ = _queries(index, queries, sanitize=False)
    exclude = _exclude(index, exclude)
    Q = q.shape[0]
    N = index.n
    k = min(k, N)
    chunk = min(chunk, N)
    dev = q.device
    dtw_fn = dtw_band_op if use_kernels else dtw_band_ref
    best_d = torch.full((Q, k), _INF, dtype=torch.float32, device=dev)
    best_i = torch.full((Q, k), -1, dtype=torch.int64, device=dev)
    for s in range(0, N, chunk):
        e = min(s + chunk, N)
        C = e - s
        qrep = q.repeat_interleave(C, dim=0)          # (Q * C, L)
        crep = index.series[s:e].repeat(Q, 1)         # (Q * C, L)
        d = dtw_fn(qrep, crep, w).reshape(Q, C)
        ids = torch.arange(s, e, device=dev).expand(Q, C)
        if exclude is not None:
            d = torch.where(ids == exclude[:, None], _INF, d)
        alld = torch.cat([best_d, d], dim=1)
        alli = torch.cat([best_i, ids], dim=1)
        sel = smallest_k(alld, k)
        best_d = alld.gather(1, sel)
        best_i = alli.gather(1, sel)
    return best_d, best_i.to(torch.int32)
