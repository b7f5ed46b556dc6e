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
go on; everything else stays on the device.  Every sort is stable, as
``jnp.argsort`` is, and every top-k is a stable sort cut to ``k``, so
ties resolve as in the JAX package and the neighbour ids and per-query
``n_dtw`` agree with it.
"""

from __future__ import annotations

import dataclasses

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
from repro_torch.search.index import DTWIndex, validate_series
from repro_torch.search.pipeline import (
    VerificationPlan,
    default_plan,
    dense_plan,
    resolve_adaptive_budget,
)

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
    """

    cascade: CascadeConfig
    verify_chunk: int = 32
    k: int = 1


def _queries(index: DTWIndex, queries, sanitize: bool) -> Tensor:
    q = torch.as_tensor(queries, dtype=torch.float32, device=index.device)
    if q.dim() != 2 or q.shape[1] != index.length:
        raise ValueError(f"queries: expected (Q, {index.length}), got "
                         f"{tuple(q.shape)}")
    q, _ = validate_series(q, name="query", sanitize=sanitize)
    return q.contiguous()


def _exclude(index: DTWIndex, exclude) -> Tensor | None:
    if exclude is None:
        return None
    return torch.as_tensor(exclude, device=index.device).to(torch.int64)


def nn_search(index: DTWIndex, queries, cfg: EngineConfig, *,
              exclude=None, plan: VerificationPlan | None = None,
              sanitize: bool = False) -> SearchResult:
    """Exact k-NN-DTW for a ``(Q, L)`` query batch on the index's device.

    ``exclude`` ((Q,) ints) removes one candidate per query (leave-one-
    out evaluation).  ``plan`` defaults to ``default_plan(cfg.cascade)``
    (``dense_plan`` for an unstaged cascade).  A query batch holding
    NaN/Inf raises unless ``sanitize=True`` masks it
    (``index.validate_series``).
    """
    q = _queries(index, queries, sanitize)
    exclude = _exclude(index, exclude)
    cascade = cfg.cascade
    if plan is None:
        plan = default_plan(cascade) if cascade.staged \
            else dense_plan(cascade)
    k = min(cfg.k, index.n)
    if (cascade.staged and cascade.adaptive_budget
            and cascade.survivor_budget is None
            and plan.compaction.budget is None):
        budget = resolve_adaptive_budget(q, index, cascade, k, exclude)
        cascade = dataclasses.replace(cascade, survivor_budget=budget)
    return _search(index, q, cfg, cascade, plan, exclude)


def _search(index: DTWIndex, q: Tensor, cfg: EngineConfig,
            cascade: CascadeConfig, plan: VerificationPlan,
            exclude: Tensor | None) -> SearchResult:
    """One engine pass under one plan with a budget-resolved cascade."""
    Q = q.shape[0]
    N = index.n
    k = min(cfg.k, N)
    M = min(cfg.verify_chunk, N)
    w = cascade.w
    dev = q.device
    dtw_fn = cascade.dtw_fn()
    qarange = torch.arange(Q, device=dev)

    if cascade.staged:
        cres = run_plan(q, index, cascade, plan, k=k, dtw_fn=dtw_fn,
                        exclude=exclude)
        lb = cres.lb
        # the seeds are verified: they warm-start the top-k and leave the
        # unverified ordering
        sel = torch.sort(cres.seed_d, dim=1, stable=True).indices
        best_d = cres.seed_d.gather(1, sel)
        best_i = cres.seed_idx.gather(1, sel)
        n_dtw = torch.full((Q,), k, dtype=torch.int64, device=dev)
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
        # exactly +inf marks a verified seed or an excluded candidate;
        # every other value, NaN and -inf included, stays eligible
        valid = valid & ~torch.isposinf(slbv)
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
        d = torch.where(valid, d, _INF)
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
        active = valid & ((lbv < kth1[qi]) | (d <= kth1[qi]))
        n_dtw = n_dtw.index_add(0, qi, active.to(torch.int64))
        cursor = torch.clamp(cursor + torch.where(~done, quota, 0), max=N)
        next_lb = slb_pad[qarange, cursor]
        done = done | (best_d[:, k - 1] <= next_lb) | (cursor >= N)
    return SearchResult(dists=best_d, idx=best_i.to(torch.int32),
                        n_dtw=n_dtw.to(torch.int32), lb=lb)


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
    q = _queries(index, queries, sanitize=False)
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
