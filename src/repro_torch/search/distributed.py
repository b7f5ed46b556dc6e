"""Distributed NN-DTW search over a (pod, data, model) device mesh (port of
``repro.search.distributed``).

Sharding contract:
  * the candidate store is sharded along its N axis over the *data* axes
    (``('data',)`` single-pod, ``('pod', 'data')`` multi-pod), the axis
    that grows with the corpus;
  * the query batch is sharded over the *model* axis (queries are
    independent);
  * each rank runs the tier pipeline and the verification engine on its
    own rows, then the per-query top-k merges with one ``all_gather`` over
    the data axes (k values a query and shard).

Global survivor budget (``global_budget=True``, staged cascades): each
shard all-gathers its per-query k-th smallest tier-0/1 bound over the data
axes, takes the tightest shard's as the survivor threshold, all-gathers
its survivor mass under it, and refines a mass-proportional share of the
uniform total ``D * B`` (an f32 ceil share, clamped into ``[k, 2 B]`` by
``cascade.run_plan``), so the shard holding a query's neighbourhood
tightens more bounds than the empty ones.  Dead slots keep their tier-0/1
bound, so the merged result is exact whatever the allocation.

SPMD, one process a rank.  JAX writes the step as one ``shard_map``
program; here every rank of a ``torch.distributed`` world runs that
program's body, and collectives over the mesh's process groups take the
place of the ``lax`` ones (``all_gather`` for ``all_gather``,
``all_reduce`` SUM / MAX for ``psum`` / ``pmax``).  The step's calling
contract:

    step(series, labels, upper, lower, kim, kim_ok, queries
         [, sk_lo, sk_hi, sk_scale, live])  # with_sketch=True

takes this rank's own leaves (its rows of the store, ``shard_index``) and
the *whole* query batch, of which it searches its block on the model
axis (``Q`` must divide by the axis size), and returns ``(dists, idx,
n_dtw[, guard_vector])`` for that block: ids are *global* (the shard's row
offset added), ``n_dtw`` sums over the data axes, and the guard vector is
merged over the whole mesh.  Every rank calls it with the same batch.

Every rank makes the same collectives in the same order: a rank that
skipped one would leave the others waiting in it.  So the step never
degrades.  As in JAX, where values inside ``shard_map`` are not concrete,
a tripped guard is reported in the merged vector (its ``degraded`` stays
0) and nothing reruns; likewise the adaptive survivor budget and
``cfg.auto_plan``, host decisions on concrete values, do not apply: every
rank runs the static budget rule and the plan it was given.  The query
batch is validated (``guards.validate_series``) before any collective, on
every rank alike.

Ties: ``lax.top_k`` keeps the lower flat index among equal distances; the
merge here is a stable ascending sort of the gathered ``(D, Qloc, k)``
block in combined-axis order (``pod`` major for ``('pod', 'data')``),
cut to ``k``, which keeps the same candidates.

Backends: gloo for a ``"cpu"`` mesh, NCCL for a ``"cuda"`` one
(``launch.mesh.make_host_mesh``).  The JAX module's ``jit=`` argument and
``guards.preflight_shard_map`` work around a jax 0.4 miscompile of
``jit(shard_map(while_loop))``; nothing here is compiled that way, so
neither has a counterpart.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from repro_torch.search import guards as _guards
from repro_torch.search.cascade import run_plan, smallest_k
from repro_torch.search.engine import EngineConfig, _search
from repro_torch.search.index import DTWIndex
from repro_torch.search.pipeline import (
    Compaction,
    TierStats,
    VerificationPlan,
    default_plan,
    dense_plan,
)

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class _Axes:
    """A group of mesh axes as one flattened axis: its process group,
    size, and this rank's combined index (``axes[0]`` major, the order of
    JAX's ``_combined_axis_index``)."""

    group: object
    size: int
    index: int


def _axes(mesh, axes: tuple[str, ...]) -> _Axes:
    names = tuple(mesh.mesh_dim_names or ())
    axes = tuple(axes)
    if not axes or any(a not in names for a in axes) or \
            list(axes) != sorted(axes, key=names.index) or \
            len(set(axes)) != len(axes):
        raise ValueError(f"axes {axes} must be distinct axes of the mesh "
                         f"{names}, in its order")
    sub = mesh[axes[0]] if len(axes) == 1 else mesh[axes]._flatten()
    return _Axes(group=sub.get_group(), size=sub.size(),
                 index=sub.get_local_rank())


def _all_gather(x: Tensor, ax: _Axes) -> Tensor:
    """``(size, *x.shape)``: every rank's ``x`` in combined-index order."""
    x = x.contiguous()
    out = [torch.empty_like(x) for _ in range(ax.size)]
    dist.all_gather(out, x, group=ax.group)
    return torch.stack(out)


def _all_reduce(x: Tensor, ax: _Axes, op) -> Tensor:
    x = x.clone().contiguous()
    dist.all_reduce(x, op=op, group=ax.group)
    return x


def global_budget_limit_fn(mesh, axes: tuple[str, ...]):
    """Compaction ``limit_fn`` allocating one global budget across the
    shards of ``axes``.

    Returns ``(lb01, budget, k) -> (Q,)`` int32 refine limits; every rank
    of the data axes must call it together (two ``all_gather``s): each
    shard's per-query k-th smallest tier-0/1 bound, then its survivor mass
    under the tightest shard's.  The share ``ceil(D * budget * mass /
    total)`` is computed in f32 as in JAX, so the limits are bit-equal to
    its.  Excluded candidates arrive as +inf and never count toward mass.
    The mesh makes up for what JAX reads from the ``shard_map`` context.
    """
    ax = _axes(mesh, axes)

    def limit_fn(lb01: Tensor, budget: int, k: int) -> Tensor:
        kq = max(1, min(k, lb01.shape[1]))
        kth_local = torch.topk(lb01, kq, dim=1, largest=False,
                               sorted=True).values[:, kq - 1]
        theta = _all_gather(kth_local, ax).amin(dim=0)          # (Q,)
        mass_local = (lb01 <= theta[:, None]).sum(dim=1).to(torch.int32)
        mass_all = _all_gather(mass_local, ax)                  # (D, Q)
        total = mass_all.sum(dim=0).clamp(min=1)
        frac = mass_local.to(torch.float32) / total.to(torch.float32)
        scale = torch.tensor(float(ax.size * budget), dtype=torch.float32,
                             device=lb01.device)
        return torch.ceil(scale * frac).to(torch.int32)

    return limit_fn


def _default_distributed_plan(cfg: EngineConfig, mesh,
                              axes: tuple[str, ...],
                              global_budget: bool) -> VerificationPlan:
    plan = (default_plan(cfg.cascade) if cfg.cascade.staged
            else dense_plan(cfg.cascade))
    if global_budget and cfg.cascade.staged:
        plan = dataclasses.replace(plan, compaction=Compaction(
            limit_fn=global_budget_limit_fn(mesh, axes)))
    return plan


def gather_tier_stats(stats: TierStats, mesh, data_axes: tuple[str, ...],
                      query_axis: str | None = None) -> TierStats:
    """Merge shard-local ``TierStats`` into one fleet measurement, on every
    rank of the mesh together: per-tier mass / scored / work and the pair
    count sum over the data axes and ``query_axis``, the query count over
    the query axis only, and the per-query survivor counts take the MAX
    (over the data axes, then over every query of the query axis: the
    committed refine limit must cover the heaviest shard).  Every rank
    ends with the same measurement, so every rank derives the same plan.
    """
    daxes = tuple(data_axes)
    data = _axes(mesh, daxes)
    surv = _all_reduce(stats.survivors, data, dist.ReduceOp.MAX)
    whole, queries = data, stats.queries
    if query_axis is not None:
        qax = _axes(mesh, (query_axis,))
        whole = _axes(mesh, daxes + (query_axis,))
        surv = _all_reduce(surv.amax().reshape(1), qax, dist.ReduceOp.MAX)
        queries = _all_reduce(stats.queries, qax, dist.ReduceOp.SUM)
    n_t = stats.mass.shape[0]
    sums = _all_reduce(torch.cat([stats.mass, stats.scored, stats.work,
                                  stats.pairs.reshape(1)]),
                       whole, dist.ReduceOp.SUM)
    return dataclasses.replace(
        stats, mass=sums[:n_t], scored=sums[n_t:2 * n_t],
        work=sums[2 * n_t:3 * n_t], pairs=sums[3 * n_t], queries=queries,
        survivors=surv)


def _query_block(queries, model: _Axes, device) -> Tensor:
    """This rank's block of the whole query batch on the model axis, after
    the batch is validated (the same on every rank)."""
    q = torch.as_tensor(queries, dtype=torch.float32, device=device)
    if q.dim() != 2:
        raise ValueError(f"queries: expected (Q, L), got {tuple(q.shape)}")
    if q.shape[0] % model.size:
        raise ValueError(f"{q.shape[0]} queries do not split over a model "
                         f"axis of {model.size}")
    q, _ = _guards.validate_series(q, name="query")
    b = q.shape[0] // model.size
    return q[model.index * b:(model.index + 1) * b].contiguous()


def calibrate_distributed_plan(
    mesh,
    cfg: EngineConfig,
    series, labels, upper, lower, kim, kim_ok, queries,
    sk_lo=None, sk_hi=None, sk_scale=None, live=None,
    *,
    data_axes: tuple[str, ...] = ("data",),
    query_axis: str = "model",
    global_budget: bool = True,
    sample: int = 8,
    pcfg=None,
):
    """Measure the base plan across the mesh and derive one global plan
    (a ``planner.PlanDecision``), on every rank together.

    Each rank runs the instrumented executor on a ``sample``-query strided
    block of its query block against its rows, the measurements merge over
    the mesh (``gather_tier_stats``), and each rank's host turns the
    *global* measurement into the same decision: pass ``decision.plan`` to
    ``make_distributed_search(plan=...)`` and every rank commits the same
    plan, the planner's refine limit composed into the global-budget
    allocation.  Takes what the step takes: the rank's own leaves and the
    whole query batch, then, for a ``with_sketch`` step, the sketch leaves
    and the store mask.  JAX's takes the first seven only, so a sketch
    tier there scores zeros, measures no mass and is dropped; given the
    sketch leaves, the port prices the tier as the step will run it.
    """
    from repro_torch.search.planner import calibration_sample, optimise_plan

    axes = tuple(data_axes)
    base = _default_distributed_plan(cfg, mesh, axes, global_budget)
    q = _query_block(queries, _axes(mesh, (query_axis,)), series.device)
    index = DTWIndex(series=series, labels=labels, upper=upper, lower=lower,
                     kim=kim, kim_ok=kim_ok, w=cfg.cascade.w, sk_lo=sk_lo,
                     sk_hi=sk_hi, sk_scale=sk_scale, live=live)
    pick = torch.as_tensor(calibration_sample(q.shape[0], sample),
                           device=q.device)
    cres = run_plan(q[pick], index, cfg.cascade, base, k=cfg.k,
                    collect_stats=True)
    stats = gather_tier_stats(cres.stats, mesh, axes, query_axis)
    n_local = max(1, index.n)
    return optimise_plan(base, stats, n=n_local, k=cfg.k,
                         base_budget=cfg.cascade.budget(n_local, cfg.k),
                         pcfg=pcfg)


def make_distributed_search(
    mesh,
    cfg: EngineConfig,
    *,
    data_axes: tuple[str, ...] = ("data",),
    query_axis: str = "model",
    global_budget: bool = True,
    plan: VerificationPlan | None = None,
    with_guards: bool = False,
    with_sketch: bool = False,
):
    """Build the distributed search step for ``mesh`` (module docstring:
    the calling contract).  Every rank of the mesh calls this together
    (it makes the process groups of the axes).

    ``with_sketch`` appends the quantised sketch leaves ``sk_lo, sk_hi,
    sk_scale, live`` to the step's arguments (a store built with
    ``build_index(sketch=..., mask=True)``; ``shard_index`` splits them,
    ``sk_scale`` whole; pass ``live = ones(N, bool)`` for a store with
    features but no mask).  ``global_budget`` (staged cascades) swaps the
    per-shard survivor budget for the mass-proportional global one;
    ``False`` keeps local compaction.  ``plan`` overrides the default plan
    on every rank, as a ``calibrate_distributed_plan`` decision commits.
    ``with_guards`` appends the fleet-merged ``GuardReport`` vector
    (``GuardReport.from_vector``): counts summed over the whole mesh,
    ``admiss_gap`` the MAX, including the shard-dropout echo check (each
    shard must find its own top-k intact in the gather).
    """
    axes = tuple(data_axes)
    data = _axes(mesh, axes)
    model = _axes(mesh, (query_axis,))
    whole = _axes(mesh, axes + (query_axis,))
    if plan is None:
        plan = _default_distributed_plan(cfg, mesh, axes, global_budget)
    gcfg = _guards.resolve_guards(cfg.guards)
    gap_i = _guards._VEC_FIELDS.index("admiss_gap")

    def step(series, labels, upper, lower, kim, kim_ok, queries,
             sk_lo=None, sk_hi=None, sk_scale=None, live=None):
        if with_sketch and any(x is None for x in (sk_lo, sk_hi, sk_scale,
                                                   live)):
            raise ValueError("with_sketch: pass sk_lo, sk_hi, sk_scale and "
                             "live after the queries")
        if not with_sketch:
            sk_lo = sk_hi = sk_scale = live = None
        q = _query_block(queries, model, series.device)
        index = DTWIndex(series=series, labels=labels, upper=upper,
                         lower=lower, kim=kim, kim_ok=kim_ok,
                         w=cfg.cascade.w, sk_lo=sk_lo, sk_hi=sk_hi,
                         sk_scale=sk_scale, live=live)
        # the engine pass under the static budget rule and the given plan:
        # no adaptive budget, no calibration, no degradation (docstring)
        res, _, grep = _search(index, q, cfg, plan, None,
                               cascade=cfg.cascade)
        if grep is None:
            grep = _guards.GuardReport.zeros(q.device)
        gidx = res.idx + data.index * index.n
        d_all = _all_gather(res.dists, data)          # (D, Qloc, k)
        i_all = _all_gather(gidx, data)
        hook = _guards.fault_hook("allgather_topk")
        if hook is not None:
            d_all = hook(d_all)
        q_loc, k = res.dists.shape
        if gcfg.enabled and gcfg.conservation:
            # shard-dropout echo check: this shard's own top-k must come
            # back intact from the gather
            lost = (d_all[data.index] != res.dists).any(dim=-1).sum()
            grep = dataclasses.replace(
                grep, conserve_checked=grep.conserve_checked + float(q_loc),
                conserve_viol=grep.conserve_viol + lost.to(torch.float32))
        d_flat = d_all.permute(1, 0, 2).reshape(q_loc, -1)
        i_flat = i_all.permute(1, 0, 2).reshape(q_loc, -1)
        sel = smallest_k(d_flat, k)
        merged_d = d_flat.gather(1, sel)
        merged_i = i_flat.gather(1, sel)
        n_dtw = _all_reduce(res.n_dtw, data, dist.ReduceOp.SUM)
        if not with_guards:
            return merged_d, merged_i, n_dtw
        gv = grep.to_vector().to(q.device)
        merged = _all_reduce(gv, whole, dist.ReduceOp.SUM)
        merged[gap_i] = _all_reduce(gv[gap_i:gap_i + 1], whole,
                                    dist.ReduceOp.MAX)[0]
        return merged_d, merged_i, n_dtw, merged

    return step


def shard_index(mesh, index: DTWIndex, data_axes=("data",)) -> DTWIndex:
    """This rank's rows of ``index`` over the data axes (views, no copy):
    every per-candidate leaf split by rows, ``live`` too, the store-wide
    ``sk_scale`` whole; absent leaves stay ``None``.  N must divide by the
    data shards, so that a shard's global row offset is its combined
    index times its rows."""
    data = _axes(mesh, tuple(data_axes))
    if index.n % data.size:
        raise ValueError(f"{index.n} store rows do not split over "
                         f"{data.size} data shards")
    b = index.n // data.size
    rows = slice(data.index * b, (data.index + 1) * b)

    def cut(x):
        return None if x is None else x[rows]

    return DTWIndex(series=cut(index.series), labels=cut(index.labels),
                    upper=cut(index.upper), lower=cut(index.lower),
                    kim=cut(index.kim), kim_ok=cut(index.kim_ok), w=index.w,
                    sk_lo=cut(index.sk_lo), sk_hi=cut(index.sk_hi),
                    sk_scale=index.sk_scale, live=cut(index.live))
