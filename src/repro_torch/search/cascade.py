"""Lower-bound cascade: the tier-pipeline executor (port of
``repro.search.cascade``).

``run_plan`` executes a ``VerificationPlan``:

  1. the all-pairs tiers in plan order, folded by a running elementwise
     maximum (kim from the index's features; bands through kernel K2);
  2. one gather compaction of the ``B`` best-bounded candidates per query
     into packed rows;
  3. the pairwise tiers on those rows (kernel K3), scatter-maxed back;
  4. the ``k`` best-bounded candidates per query verified with banded DTW
     (kernel K4): their k-th distance ``tau`` bounds the final k-th best
     from above and warm-starts the engine.

Ties: ``lax.top_k`` returns the lowest index first among equal values and
``torch.topk`` makes no such promise, so every selection here is a stable
ascending sort cut to its first ``k`` columns.  Bands-tier bounds are
often exactly 0, so ties are common, and this is what keeps the survivors
and seeds equal to the JAX package's.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.kernels import ref as kref
from repro_torch.kernels.ops import (
    dtw_band_op,
    lb_enhanced_op,
    lb_enhanced_pairwise_op,
)
from repro_torch.search.index import DTWIndex, kim_features
from repro_torch.search.pipeline import (
    VerificationPlan,
    bucket_pow2,
    default_plan,
    dense_plan,
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
      candidate_chunk: candidates (or packed slots) per kernel call.
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
    """

    lb: Tensor
    seed_idx: Tensor
    seed_d: Tensor


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


def _chunked_columns(q: Tensor, index: DTWIndex, cfg: CascadeConfig,
                     bands_only: bool) -> Tensor:
    """(Q, N) cross-block LB_ENHANCED over candidate chunks of
    ``cfg.candidate_chunk``."""
    n = index.n
    chunk = min(cfg.candidate_chunk, n)
    lb_fn = cfg.lb_fn()
    outs = []
    for s in range(0, n, chunk):
        e = min(s + chunk, n)
        outs.append(lb_fn(q, index.series[s:e], index.upper[s:e],
                          index.lower[s:e], cfg.w, cfg.v,
                          bands_only=bands_only))
    return torch.cat(outs, dim=1) if len(outs) > 1 else outs[0]


def bands_prefilter(q: Tensor, index: DTWIndex,
                    cfg: CascadeConfig) -> Tensor:
    """(Q, N) bands-only tier (Alg. 1 lines 1-11), the cheap pre-bound
    that picks the compaction survivors."""
    return _chunked_columns(q, index, cfg, bands_only=True)


def enhanced_all_pairs(q: Tensor, index: DTWIndex,
                       cfg: CascadeConfig) -> Tensor:
    """(Q, N) dense O(L) LB_ENHANCED tier (the ``enhanced_dense`` tier)."""
    return _chunked_columns(q, index, cfg, bands_only=False)


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


def _all_pairs_bounds(q: Tensor, index: DTWIndex, cfg: CascadeConfig,
                      plan: VerificationPlan) -> Tensor:
    """The plan's all-pairs tiers folded by a running maximum (zeros when
    it has none)."""
    lb = torch.zeros((q.shape[0], index.n), dtype=q.dtype, device=q.device)
    for i, tier in enumerate(plan.all_pairs_tiers):
        t = tier.fn(q, index, cfg)
        lb = t if i == 0 else torch.maximum(lb, t)
    return lb


def run_plan(q: Tensor, index: DTWIndex, cfg: CascadeConfig,
             plan: VerificationPlan | None = None, k: int = 1,
             dtw_fn: Callable | None = None, *,
             exclude: Tensor | None = None) -> CascadeResult:
    """Execute a ``VerificationPlan`` (module docstring).  ``exclude``
    ((Q,) int64) removes one candidate per query from compaction and
    seeding; its bound entry is left for the engine to mask."""
    plan = plan if plan is not None else default_plan(cfg)
    Q = q.shape[0]
    n = index.n
    k = min(k, n)
    if dtw_fn is None:
        dtw_fn = cfg.dtw_fn()

    lb01 = _all_pairs_bounds(q, index, cfg, plan)
    lb = lb01
    if plan.pairwise_tiers:
        comp = plan.compaction
        B = comp.budget if comp.budget is not None else cfg.budget(n, k)
        B = max(1, min(n, B))
        cand = smallest_k(_set_rows(lb01, exclude), B)  # ascending bound
        chunk = min(cfg.candidate_chunk, B)
        cols = []
        for s in range(0, B, chunk):
            e = min(s + chunk, B)
            cidx = cand[:, s:e].reshape(-1)           # (Q * (e - s),)
            qf = q.repeat_interleave(e - s, dim=0)
            crows = index.series[cidx]
            urows = index.upper[cidx]
            lrows = index.lower[cidx]
            pe = None
            for tier in plan.pairwise_tiers:
                t = tier.fn(qf, crows, urows, lrows, cfg)
                pe = t if pe is None else torch.maximum(pe, t)
            cols.append(pe.reshape(Q, e - s))
        enh = torch.cat(cols, dim=1) if len(cols) > 1 else cols[0]
        lb = _scatter_max(lb01, cand, enh)

    # the k best-bounded candidates: exactly the first k verifications the
    # engine's ascending-bound loop would make, moved ahead of it
    seed_idx = smallest_k(_set_rows(lb, exclude), k)  # (Q, k)
    seed_d = dtw_fn(q.repeat_interleave(k, dim=0),
                    index.series[seed_idx.reshape(-1)], cfg.w).reshape(Q, k)
    lb = _scatter_max(lb, seed_idx, seed_d)
    return CascadeResult(lb=lb, seed_idx=seed_idx, seed_d=seed_d)
