"""Lower-bound cascade: the tier-pipeline executor (port of
``repro.search.cascade``).

``run_plan`` executes a ``VerificationPlan``:

  1. the all-pairs tiers in plan order, folded by a running elementwise
     maximum (sketch through kernel K7, kim from the index's features,
     bands through kernel K2; the store ``live`` mask feeds the tiers
     that take it);
  2. one gather compaction of the ``B`` best-bounded candidates per query
     into packed rows;
  3. the pairwise tiers on those rows (kernel K3), scatter-maxed back;
  4. the ``k`` best-bounded candidates per query verified with banded DTW
     (kernel K4): their k-th distance ``tau`` bounds the final k-th best
     from above and warm-starts the engine.

With guards on (search/guards.py) every tier output passes the finite
gate, the compaction and the scatter-max are checked for conservation,
and the seeds double as admissibility samples; the counters land in
``CascadeResult.guard`` without a host sync.  ``collect_stats`` prices
every tier into ``CascadeResult.stats`` (pipeline.TierStats).

Ties: ``lax.top_k`` returns the lowest index first among equal values and
``torch.topk`` makes no such promise, so every selection here is a stable
ascending sort cut to its first ``k`` columns.  Bands-tier bounds are
often exactly 0, so ties are common, and this is what keeps the survivors
and seeds equal to the JAX package's.
"""

from __future__ import annotations

import dataclasses
import inspect
from typing import Callable

import torch

from repro_torch.kernels import ref as kref
from repro_torch.kernels.ops import (
    dtw_band_op,
    lb_enhanced_op,
    lb_enhanced_pairwise_op,
)
from repro_torch.search import guards as _guards
from repro_torch.search.index import DTWIndex, kim_features
from repro_torch.search.pipeline import (
    TierStats,
    VerificationPlan,
    bucket_pow2,
    default_plan,
    dense_plan,
    tier_cost_weight,
)

Tensor = torch.Tensor

_INF = float("inf")

# survivor budgets come from power-of-two buckets (floor 64)
_BUDGET_FLOOR = 64


def _bucket_up(x: int) -> int:
    return bucket_pow2(x, _BUDGET_FLOOR)


def smallest_k(x: Tensor, k: int) -> Tensor:
    """Column indices of the ``k`` smallest entries of each row, lowest
    index first among ties (``lax.top_k(-x, k)``'s order)."""
    return torch.sort(x, dim=1, stable=True).indices[:, :k]


@dataclasses.dataclass(frozen=True)
class CascadeConfig:
    """Static configuration of the pruning cascade.

    Attributes:
      w: Sakoe-Chiba window.
      v: LB_ENHANCED speed-tightness parameter (paper SS III-A).
      use_kim: include the O(1) Kim tier in the default plans.
      use_sketch: put the tier-(-1) sketch tier first in the default
        plans; it pays only on an index built with sketch features.
      candidate_chunk: candidates per call of the plain cross-block
        tiers, and packed slots per call of the pairwise tiers.  The
        card's cross-block kernel (K2) ignores it and takes the whole
        store in one launch, as K4 ignores ``tile_p``.
      use_kernels: route the tiers and DTW through ``kernels/ops.py``
        (hand-written kernels on the card, plain versions on the CPU), or
        ``False`` for the plain versions everywhere; the counterpart of
        ``use_pallas``.
      staged: run the staged plan (compaction + pairwise tiers) instead
        of dense full-tier bounds.
      survivor_budget: per-query compaction width; ``None`` derives it.
      adaptive_budget: with ``survivor_budget=None``, pick the bucket from
        the observed tier-0/1 pruning mass (``choose_survivor_budget``).
    """

    w: int
    v: int = 4
    use_kim: bool = True
    use_sketch: bool = False
    candidate_chunk: int = 512
    use_kernels: bool = True
    staged: bool = True
    survivor_budget: int | None = None
    adaptive_budget: bool = True

    def lb_fn(self):
        return lb_enhanced_op if self.use_kernels else kref.lb_enhanced_ref

    def pairwise_fn(self):
        return (lb_enhanced_pairwise_op if self.use_kernels
                else kref.lb_enhanced_pairwise_ref)

    def dtw_fn(self):
        return dtw_band_op if self.use_kernels else kref.dtw_band_ref

    def budget(self, n: int, k: int = 1) -> int:
        if self.survivor_budget is not None:
            return max(1, min(n, self.survivor_budget))
        return min(n, _bucket_up(max(_BUDGET_FLOOR, 4 * k, -(-n // 8))))


@dataclasses.dataclass(frozen=True, eq=False)
class CascadeResult:
    """Tier-pipeline output consumed by the engine.

    Attributes:
      lb: (Q, N) per-pair lower bounds (exact DTW at the seeds).
      seed_idx: (Q, k) int64 candidate ids verified for the threshold.
      seed_d: (Q, k) their banded-DTW distances.
      stats: the per-tier ``TierStats`` with ``collect_stats=True``.
      guard: the executor's ``GuardReport`` when guards ran.
    """

    lb: Tensor
    seed_idx: Tensor
    seed_d: Tensor
    stats: TierStats | None = None
    guard: _guards.GuardReport | None = None


def lb_kim_tier(q: Tensor, index: DTWIndex) -> Tensor:
    """(Q, N) Kim bounds from precomputed features, O(1) per pair."""
    qf, qok = kim_features(q)                         # (Q, 4), (Q, 2)
    cf, cok = index.kim, index.kim_ok                 # (N, 4), (N, 2)
    d = qf[:, None, :] - cf[None, :, :]               # (Q, N, 4)
    d = d * d
    base = d[..., 0] + d[..., 1]
    # witness interiority: the series with the more extreme extremum
    ok_max = torch.where(qf[:, None, 2] >= cf[None, :, 2], qok[:, None, 0],
                         cok[None, :, 0])
    t_max = torch.where(ok_max, d[..., 2], 0.0)
    ok_min = torch.where(qf[:, None, 3] <= cf[None, :, 3], qok[:, None, 1],
                         cok[None, :, 1])
    t_min = torch.where(ok_min, d[..., 3], 0.0)
    return base + torch.maximum(t_max, t_min)


def _kernel_route(q: Tensor, cfg: CascadeConfig) -> bool:
    """Whether the cross-block tiers launch K2 (CUDA tensors with
    ``use_kernels``) rather than run the plain version."""
    return cfg.use_kernels and q.device.type == "cuda"


def _chunked_columns(q: Tensor, index: DTWIndex, cfg: CascadeConfig,
                     bands_only: bool, live: Tensor | None) -> Tensor:
    """(Q, N) cross-block LB_ENHANCED; ``live`` (``(N,)``) gives dead
    candidates ``-inf``.  The kernel route makes one call over the whole
    store (K2 writes the matrix directly); the plain route takes
    ``cfg.candidate_chunk`` candidates a call, since its full form
    materialises ``(Q, C, L)`` intermediates.  Results are per pair, so
    the two agree whatever the chunk."""
    n = index.n
    chunk = n if _kernel_route(q, cfg) else min(cfg.candidate_chunk, n)
    lb_fn = cfg.lb_fn()
    outs = []
    for s in range(0, n, chunk):
        e = min(s + chunk, n)
        outs.append(lb_fn(q, index.series[s:e], index.upper[s:e],
                          index.lower[s:e], cfg.w, cfg.v,
                          live=None if live is None else live[s:e],
                          bands_only=bands_only))
    return torch.cat(outs, dim=1) if len(outs) > 1 else outs[0]


def bands_prefilter(q: Tensor, index: DTWIndex, cfg: CascadeConfig, *,
                    live: Tensor | None = None) -> Tensor:
    """(Q, N) bands-only tier (Alg. 1 lines 1-11), the cheap pre-bound
    that picks the compaction survivors; ``live`` is the store mask."""
    return _chunked_columns(q, index, cfg, True, live)


def enhanced_all_pairs(q: Tensor, index: DTWIndex, cfg: CascadeConfig, *,
                       live: Tensor | None = None) -> Tensor:
    """(Q, N) dense O(L) LB_ENHANCED tier (the ``enhanced_dense`` tier)."""
    return _chunked_columns(q, index, cfg, False, live)


def _accepts_kw(fn, name: str) -> bool:
    """Whether ``fn`` takes the keyword ``name`` (or ``**kwargs``): custom
    tier fns written without ``live`` get the plain call."""
    try:
        params = inspect.signature(fn).parameters
    except (TypeError, ValueError):
        return False
    return name in params or any(
        p.kind is inspect.Parameter.VAR_KEYWORD for p in params.values())


def _set_rows(x: Tensor, exclude: Tensor | None) -> Tensor:
    """``x`` with entry ``exclude[i]`` of row ``i`` set to ``+inf``."""
    if exclude is None:
        return x
    rows = torch.arange(x.shape[0], device=x.device)
    return x.index_put((rows, exclude), torch.tensor(_INF, device=x.device))


def _scatter_max(x: Tensor, cols: Tensor, vals: Tensor) -> Tensor:
    """``x.at[rows, cols].max(vals)`` for per-row distinct ``cols``."""
    return x.scatter(1, cols, torch.maximum(x.gather(1, cols), vals))


def choose_survivor_budget(q: Tensor, index: DTWIndex, cfg: CascadeConfig,
                           k: int = 1, *, exclude: Tensor | None = None,
                           sample: int = 8, safety: float = 2.0) -> int:
    """Pick a power-of-two survivor budget from tier-0/1 pruning mass.

    Runs the cheap tiers on a query sample, verifies each sample query's
    ``k`` best-bounded candidates (their worst distance ``tau`` bounds
    its final k-th best from above), counts candidates whose cheap bound
    falls below ``tau``, and buckets ``safety`` times the largest count,
    capped at 4x the static rule's bucket.  One host sync.
    """
    n = index.n
    k = min(k, n)
    S = min(sample, q.shape[0])
    qs = q[:S]
    kim = lb_kim_tier(qs, index) if cfg.use_kim \
        else torch.zeros((S, n), dtype=qs.dtype, device=qs.device)
    lb01 = torch.maximum(kim, bands_prefilter(qs, index, cfg))
    lb01 = _set_rows(lb01, None if exclude is None else exclude[:S])
    cand = smallest_k(lb01, k)
    d = cfg.dtw_fn()(qs.repeat_interleave(k, dim=0),
                     index.series[cand.reshape(-1)], cfg.w)
    tau = d.reshape(S, k).amax(dim=1, keepdim=True)
    need = int((lb01 < tau).sum(dim=1).max())
    static_cap = 4 * _bucket_up(max(_BUDGET_FLOOR, 4 * k, -(-n // 8)))
    base = min(max(_BUDGET_FLOOR, 4 * k, int(need * safety)), static_cap)
    return min(n, _bucket_up(base))


def compute_bounds(q: Tensor, index: DTWIndex, cfg: CascadeConfig, *,
                   k: int = 1, plan: VerificationPlan | None = None
                   ) -> Tensor:
    """(Q, N) tightest available bound per pair: the staged plan's bound
    matrix, or with ``cfg.staged=False`` the dense plan's."""
    if cfg.staged:
        return run_plan(q, index, cfg, plan=plan, k=k).lb
    plan = plan if plan is not None else dense_plan(cfg)
    if plan.pairwise_tiers:
        raise ValueError(
            "dense (cfg.staged=False) bounds have no compaction stage to "
            f"feed pairwise tiers ({[t.name for t in plan.pairwise_tiers]})")
    return _all_pairs_bounds(q, index, cfg, plan)


def _call_all_pairs(tier, q: Tensor, index: DTWIndex,
                    cfg: CascadeConfig) -> tuple[Tensor, bool]:
    """One all-pairs tier, fed the store mask when it takes one; returns
    the bound and whether the mask was applied."""
    if index.live is not None and _accepts_kw(tier.fn, "live"):
        return tier.fn(q, index, cfg, live=index.live), True
    return tier.fn(q, index, cfg), False


def _all_pairs_bounds(q: Tensor, index: DTWIndex, cfg: CascadeConfig,
                      plan: VerificationPlan) -> Tensor:
    """The plan's all-pairs tiers folded by a running maximum (zeros when
    it has none)."""
    lb = torch.zeros((q.shape[0], index.n), dtype=q.dtype, device=q.device)
    for i, tier in enumerate(plan.all_pairs_tiers):
        t, _ = _call_all_pairs(tier, q, index, cfg)
        lb = t if i == 0 else torch.maximum(lb, t)
    return lb


def run_plan(q: Tensor, index: DTWIndex, cfg: CascadeConfig,
             plan: VerificationPlan | None = None, k: int = 1,
             dtw_fn: Callable | None = None, *,
             exclude: Tensor | None = None, collect_stats: bool = False,
             guards: _guards.GuardConfig | None = None) -> CascadeResult:
    """Execute a ``VerificationPlan`` (module docstring).  ``exclude``
    ((Q,) int64) removes one candidate per query from compaction and
    seeding; its bound entry is left for the engine to mask.  ``guards``
    (``None``: the default-on config) threads the exactness guards;
    ``collect_stats`` prices each tier into a ``TierStats``."""
    plan = plan if plan is not None else default_plan(cfg)
    Q, L = q.shape
    n = index.n
    k = min(k, n)
    dev = q.device
    if dtw_fn is None:
        dtw_fn = cfg.dtw_fn()
    qarange = torch.arange(Q, device=dev)

    g = _guards.resolve_guards(guards)
    gon = g.enabled
    z = torch.zeros((), dtype=torch.float32, device=dev)
    nf_bounds = nf_dtw = c_checked = c_viol = a_checked = a_viol = z
    a_gap = z

    # ---- all-pairs tiers (running max); the store mask feeds the tiers
    # that take it, the others (sketch, kim) score every candidate, so a
    # dead candidate keeps a finite cheap bound
    hook_tier = _guards.fault_hook("tier_out")
    lb01 = None
    ap_snaps, ap_masked = [], []
    for tier in plan.all_pairs_tiers:
        t, masked = _call_all_pairs(tier, q, index, cfg)
        ap_masked.append(masked)
        if hook_tier is not None:
            t = hook_tier(t, tier.name)
        if gon and g.finite_gates:
            t, gated = _guards.finite_gate_bounds(t)
            nf_bounds = nf_bounds + gated
        lb01 = t if lb01 is None else torch.maximum(lb01, t)
        if collect_stats:
            ap_snaps.append(lb01)
    if lb01 is None:
        lb01 = torch.zeros((Q, n), dtype=q.dtype, device=dev)

    pairwise_tiers = plan.pairwise_tiers
    if pairwise_tiers:
        # ---- compaction: the W best-bounded candidates per query --------
        comp = plan.compaction
        B = comp.budget if comp.budget is not None else cfg.budget(n, k)
        B = max(1, min(n, B))
        sel_key = _set_rows(lb01, exclude)
        if comp.limit_fn is None:
            W, limit = B, None
        else:
            W = max(1, min(n, comp.width_scale * B))
            limit = torch.as_tensor(comp.limit_fn(sel_key, B, k),
                                    device=dev).clamp(min(k, W), W)
        cand = smallest_k(sel_key, W)                 # ascending bound
        hook_cand = _guards.fault_hook("compaction_cand")
        if hook_cand is not None:
            cand = hook_cand(cand)
        if gon and g.conservation:
            cc, cv = _guards.conservation_check(cand, n)
            c_checked, c_viol = c_checked + cc, c_viol + cv

        # ---- pairwise tiers on the packed survivor rows ----------------
        chunk = min(cfg.candidate_chunk, W)
        hook_rows = _guards.fault_hook("packed_rows")
        cols = []
        pw_snaps = [[] for _ in pairwise_tiers]
        plive = None
        for s in range(0, W, chunk):
            e = min(s + chunk, W)
            cidx = cand[:, s:e].reshape(-1)           # (Q * (e - s),)
            qf = q.repeat_interleave(e - s, dim=0)
            crows = index.series[cidx]
            urows = index.upper[cidx]
            lrows = index.lower[cidx]
            if hook_rows is not None:
                crows, urows, lrows = hook_rows(crows, urows, lrows)
            # per-slot liveness: the refine limit per query, ANDed with
            # the store mask per candidate; dead slots come back -inf,
            # the scatter-max identity
            live2d = None
            if limit is not None:
                slot = torch.arange(s, e, device=dev)[None, :]
                live2d = slot < limit[:, None]
            if index.live is not None:
                sl = index.live[cidx].reshape(Q, e - s)
                live2d = sl if live2d is None else live2d & sl
            live = None if live2d is None else live2d.reshape(-1)
            if live2d is not None:
                c = live2d.sum().to(torch.float32)
                plive = c if plive is None else plive + c
            pe = None
            for ti, tier in enumerate(pairwise_tiers):
                if live is not None and _accepts_kw(tier.fn, "live"):
                    t = tier.fn(qf, crows, urows, lrows, cfg, live=live)
                else:
                    t = tier.fn(qf, crows, urows, lrows, cfg)
                if hook_tier is not None:
                    t = hook_tier(t, tier.name)
                if gon and g.finite_gates:
                    t, gated = _guards.finite_gate_bounds(t)
                    nf_bounds = nf_bounds + gated
                pe = t if pe is None else torch.maximum(pe, t)
                if collect_stats:
                    snap = pe.reshape(Q, e - s)
                    if live2d is not None:
                        snap = torch.where(live2d, snap, -_INF)
                    pw_snaps[ti].append(snap)
            block = pe.reshape(Q, e - s)
            if live2d is not None:
                # for tiers that ignore ``live``; idempotent on the -inf
                # the kernels already wrote
                block = torch.where(live2d, block, -_INF)
            cols.append(block)
        enh = torch.cat(cols, dim=1) if len(cols) > 1 else cols[0]
        lb = _scatter_max(lb01, cand, enh)
        if gon and g.conservation:
            mc, mv = _guards.scatter_monotone_check(lb01, lb)
            c_checked, c_viol = c_checked + mc, c_viol + mv
    else:
        lb = lb01

    # ---- seeds: the k best-bounded candidates, exactly the first k
    # verifications the engine's ascending-bound loop would make
    seed_idx = smallest_k(_set_rows(lb, exclude), k)  # (Q, k)
    seed_d = dtw_fn(q.repeat_interleave(k, dim=0),
                    index.series[seed_idx.reshape(-1)], cfg.w).reshape(Q, k)
    if gon and g.finite_gates:
        seed_d, gated = _guards.finite_gate_dtw(seed_d)
        nf_dtw = nf_dtw + gated
    if gon and g.admissibility:
        # the seeds carry exact DTW values: their running bound must not
        # exceed them (the check reuses values that already exist)
        ac, av, ag = _guards.admissibility_check(lb.gather(1, seed_idx),
                                                 seed_d, g.rtol, g.atol)
        a_checked, a_viol = a_checked + ac, a_viol + av
        a_gap = torch.maximum(a_gap, ag)
    if gon and g.finite_gates:
        # a gated (+inf) seed must not turn its bound into "never verify"
        lb = _scatter_max(lb, seed_idx,
                          torch.where(torch.isfinite(seed_d), seed_d, -_INF))
    else:
        lb = _scatter_max(lb, seed_idx, seed_d)

    stats = None
    if collect_stats:
        stats = _tier_stats(q, index, cfg, plan, exclude, seed_d, lb01,
                            ap_snaps, ap_masked,
                            cand if pairwise_tiers else None,
                            pw_snaps if pairwise_tiers else None,
                            plive if pairwise_tiers else None)
    guard = None
    if gon:
        guard = dataclasses.replace(
            _guards.GuardReport.zeros(dev),
            admiss_checked=a_checked, admiss_viol=a_viol, admiss_gap=a_gap,
            conserve_checked=c_checked, conserve_viol=c_viol,
            nonfinite_bounds=nf_bounds, nonfinite_dtw=nf_dtw)
    return CascadeResult(lb=lb, seed_idx=seed_idx, seed_d=seed_d,
                         stats=stats, guard=guard)


def staged_bounds(q: Tensor, index: DTWIndex, cfg: CascadeConfig,
                  k: int = 1, dtw_fn: Callable | None = None, *,
                  exclude: Tensor | None = None,
                  plan: VerificationPlan | None = None) -> CascadeResult:
    """Execute the default (or given) staged tier plan: the historical
    entry point of ``repro.search.cascade``; ``run_plan`` is the general
    executor it wraps."""
    return run_plan(q, index, cfg, plan=plan, k=k, dtw_fn=dtw_fn,
                    exclude=exclude)


def _tier_stats(q, index, cfg, plan, exclude, seed_d, lb01, ap_snaps,
                ap_masked, cand, pw_snaps, plive) -> TierStats:
    """Price every tier of an executed plan against the seeds' threshold
    ``tau`` (pipeline.TierStats)."""
    Q, L = q.shape
    n = index.n
    dev = q.device
    tau = seed_d.amax(dim=1, keepdim=True)               # (Q, 1)
    excl = None
    if exclude is not None:
        excl = torch.arange(n, device=dev)[None, :] == exclude[:, None]

    def crossed(prev, cur, emask):
        newly = (cur >= tau) & (prev < tau)
        if emask is not None:
            newly = newly & ~emask
        return newly.sum().to(torch.float32)

    s_sk = int(index.sk_lo.shape[1]) if index.sk_lo is not None else 16
    n_live = (None if index.live is None
              else index.live.sum().to(torch.float32))
    names, costs, scopes, mass, scored, work = [], [], [], [], [], []
    prev = torch.zeros((Q, n), dtype=q.dtype, device=dev)
    for i, tier in enumerate(plan.all_pairs_tiers):
        names.append(tier.name)
        costs.append(tier.cost)
        scopes.append(tier.scope)
        mass.append(crossed(prev, ap_snaps[i], excl))
        sc = (float(Q) * n_live if ap_masked[i]
              else torch.tensor(float(Q * n), device=dev))
        scored.append(sc)
        work.append(sc * tier_cost_weight(tier.cost, L, cfg.v, cfg.w, s_sk))
        prev = ap_snaps[i]
    if cand is not None:
        W = cand.shape[1]
        base = lb01.gather(1, cand)                      # (Q, W)
        pexcl = None if exclude is None else cand == exclude[:, None]
        pscored = (plive if plive is not None
                   else torch.tensor(float(Q * W), device=dev))
        prev_pw = base
        for ti, tier in enumerate(plan.pairwise_tiers):
            cur = torch.maximum(base, torch.cat(pw_snaps[ti], dim=1))
            names.append(tier.name)
            costs.append(tier.cost)
            scopes.append(tier.scope)
            mass.append(crossed(prev_pw, cur, pexcl))
            scored.append(pscored)
            work.append(pscored
                        * tier_cost_weight(tier.cost, L, cfg.v, cfg.w, s_sk))
            prev_pw = cur
    survivors = (_set_rows(lb01, exclude) < tau).sum(1).to(torch.float32)
    stack = (lambda xs: torch.stack(xs).to(torch.float32) if xs
             else torch.zeros((0,), dtype=torch.float32, device=dev))
    return TierStats(
        names=tuple(names), costs=tuple(costs), scopes=tuple(scopes),
        mass=stack(mass), scored=stack(scored), work=stack(work),
        pairs=torch.tensor(float(Q * (n - 1 if exclude is not None else n)),
                           device=dev),
        queries=torch.tensor(float(Q), device=dev), survivors=survivors)
