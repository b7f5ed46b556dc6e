"""The port's tier planner (search/planner.py) and the instrumented
executor on the CPU, against the JAX package.

The same numpy data (``make_dataset`` from a seed) goes to both packages.
The measured ``TierStats`` counts (mass, scored, work, survivors) and the
committed decision (tier order, dropped tiers, budget bucket, refine
limit) must be equal to JAX's, and so must neighbour ids and per-query
``n_dtw`` under ``auto_plan``.  The JAX side runs its jnp references
(``use_pallas=False``) with its guards off (they change nothing on clean
data, and dominate its run time here).  The ``plan_auto_*`` count rows of
``BENCH_kernels.json`` are the JAX package's own numbers at
``benchmarks/kernel_bench.py``'s setups; the port must reproduce them.
"""

import dataclasses
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import make_dataset as j_make_dataset
from repro.search import CascadeConfig as JCascadeConfig
from repro.search import EngineConfig as JEngineConfig
from repro.search import TierStats as JTierStats
from repro.search import build_index as j_build_index
from repro.search import default_plan as j_default_plan
from repro.search import nn_search as j_nn_search
from repro.search import optimise_plan as j_optimise_plan
from repro.search import planner as j_planner
from repro.search import run_plan as j_run_plan
from repro.search.guards import GuardConfig as JGuardConfig
from repro.search.pipeline import tier_cost_weight as j_tier_cost_weight
from repro_torch.data import make_dataset
from repro_torch.search import (
    BoundTier,
    CascadeConfig,
    Compaction,
    EngineConfig,
    PlannerConfig,
    TierStats,
    brute_force,
    build_index,
    calibrate_plan,
    default_plan,
    list_tiers,
    nn_search,
    optimise_plan,
    register_tier,
    registered_tiers,
    run_plan,
    tier_cost_weight,
    unregister_tier,
)
from repro_torch.search import planner as plr
from repro_torch.search.pipeline import resolve_adaptive_budget

BENCH = json.loads((Path(__file__).resolve().parents[1]
                    / "BENCH_kernels.json").read_text())
L_TEST = 48
_J_NO_GUARDS = JGuardConfig(enabled=False)


def _data(seed=0, n_per=12, L=L_TEST):
    return make_dataset(n_classes=3, n_train_per_class=n_per,
                        n_test_per_class=4, length=L, seed=seed)


def _setup(w=8, n_per=12, L=L_TEST, seed=0, k=1, verify=4, auto=True):
    ds = _data(seed, n_per, L)
    idx = build_index(ds.x_train, w, ds.y_train, device="cpu")
    cfg = EngineConfig(cascade=CascadeConfig(w=w, v=4, candidate_chunk=16),
                       verify_chunk=verify, k=k, auto_plan=auto)
    return ds, idx, cfg


def _committed_decision():
    assert plr.plan_cache_len() >= 1
    return next(iter(plr._PLAN_CACHE.values()))[1]


def _same_decision(dec, jdec):
    assert (dec.order, dec.dropped, dec.budget, dec.limit) == (
        jdec.order, jdec.dropped, jdec.budget, jdec.limit)


def _same_stats(st, jst):
    assert tuple(st.names) == tuple(jst.names)
    for f in ("mass", "scored", "work", "survivors"):
        np.testing.assert_array_equal(np.asarray(getattr(st, f), np.float64),
                                      np.asarray(getattr(jst, f),
                                                 np.float64), err_msg=f)
    assert float(st.pairs) == float(np.asarray(jst.pairs))


# ---------------------------------------------------------------------------
# parity with JAX: stats, decisions, ids and n_dtw under auto_plan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("w,k,verify,seed", [(8, 1, 4, 0), (12, 2, 4, 7),
                                             (L_TEST, 3, 9, 5)])
def test_auto_plan_matches_jax(w, k, verify, seed):
    """Calibrate-then-commit: the same measurement, the same committed
    plan, the same neighbours and per-query n_dtw as JAX; exact against
    brute force, never more DTW than the default plan, and a warm search
    replays the committed decision."""
    plr.plan_cache_clear()
    j_planner.plan_cache_clear()
    ds, idx, cfg = _setup(w=w, seed=seed, k=k, verify=verify)
    res, stats = nn_search(idx, ds.x_test, cfg, with_stats=True)
    jds = j_make_dataset(n_classes=3, n_train_per_class=12,
                         n_test_per_class=4, length=L_TEST, seed=seed)
    jidx = j_build_index(jds.x_train, w, jds.y_train, sketch=None)
    jcfg = JEngineConfig(
        cascade=JCascadeConfig(w=w, v=4, candidate_chunk=16,
                               use_pallas=False),
        verify_chunk=verify, k=k, auto_plan=True, guards=_J_NO_GUARDS)
    jres = j_nn_search(jidx, jds.x_test, jcfg)
    jdec = next(iter(j_planner._PLAN_CACHE.values()))[1]
    dec = _committed_decision()
    _same_decision(dec, jdec)
    _same_stats(dec.stats, jdec.stats)
    np.testing.assert_array_equal(res.idx.numpy(), np.asarray(jres.idx))
    np.testing.assert_array_equal(res.n_dtw.numpy(), np.asarray(jres.n_dtw))
    bd, bi = brute_force(idx, ds.x_test, w, k=k)
    assert torch.equal(res.idx, bi) and torch.equal(res.dists, bd)
    res0 = nn_search(idx, ds.x_test, dataclasses.replace(cfg,
                                                         auto_plan=False))
    assert (res.n_dtw <= res0.n_dtw).all()
    assert stats.calibrated and stats.plan_tiers == dec.order
    warm = nn_search(idx, ds.x_test, cfg)
    assert torch.equal(warm.idx, res.idx)
    plr.plan_cache_clear()
    j_planner.plan_cache_clear()


def test_run_plan_stats_match_jax():
    """The instrumented executor's counts, on its own: equal to JAX's with
    leave-one-out exclusion and the sketch tier."""
    ds = _data(seed=3)
    w, k = 8, 2
    q = ds.x_train[::5]
    ex = np.arange(0, ds.x_train.shape[0], 5)
    idx = build_index(ds.x_train, w, device="cpu")
    jidx = j_build_index(ds.x_train, w)
    cfg = CascadeConfig(w=w, candidate_chunk=16, use_sketch=True,
                        survivor_budget=16)
    jcfg = JCascadeConfig(w=w, candidate_chunk=16, use_sketch=True,
                          survivor_budget=16, use_pallas=False)
    res = run_plan(torch.from_numpy(q), idx, cfg, k=k, collect_stats=True,
                   exclude=torch.from_numpy(ex))
    jres = j_run_plan(jnp.asarray(q), jidx, jcfg, k=k, collect_stats=True,
                      exclude=jnp.asarray(ex), guards=_J_NO_GUARDS)
    _same_stats(res.stats, jres.stats)
    np.testing.assert_array_equal(res.seed_idx.numpy(),
                                  np.asarray(jres.seed_idx))
    dec = optimise_plan(default_plan(cfg), res.stats, n=idx.n, k=k,
                        base_budget=16)
    jdec = j_optimise_plan(j_default_plan(jcfg), jres.stats, n=idx.n, k=k,
                           base_budget=16)
    _same_decision(dec, jdec)


def _synthetic_stats(pkg_stats, mass, survivors, names=None):
    names = names or ("kim", "bands", "enhanced_pairwise")
    costs = {"kim": "O(1)", "bands": "O(V^2)", "enhanced_pairwise": "O(L)",
             "sketch": "O(S)"}
    scopes = {"enhanced_pairwise": "pairwise"}
    conv = torch.tensor if pkg_stats is TierStats else jnp.asarray
    return pkg_stats(
        names=tuple(names), costs=tuple(costs[n] for n in names),
        scopes=tuple(scopes.get(n, "all_pairs") for n in names),
        mass=conv(mass, dtype=torch.float32 if conv is torch.tensor
                  else jnp.float32),
        scored=conv([100.0] * len(names)),
        work=conv([100.0 * (i + 1) for i in range(len(names))]),
        pairs=conv(100.0), queries=conv(float(len(survivors))),
        survivors=conv(survivors))


@pytest.mark.parametrize("mass,survivors,frac", [
    ([0.0, 0.0, 5.0], [10.0, 10.0, 10.0, 10.0], 0.0),
    ([30.0, 2.0, 5.0], [3.0, 1.0, 7.0, 2.0], 0.0),
    ([30.0, 2.0, 5.0], [3.0, 1.0, 7.0, 2.0], 0.05),
    ([30.0, 0.0, 0.0], [40.0, 33.0, 50.0, 12.0], 0.0),
    ([0.0, 0.0, 0.0], [4.0, 4.0, 4.0, 4.0], 0.0),
    ([12.0, 9.0, 1.0], [90.0, 20.0, 2.0, 2.0], 0.0),
])
def test_optimise_plan_decisions_match_jax(mass, survivors, frac):
    """The decision rule alone, on the same synthetic measurement."""
    plan = default_plan(CascadeConfig(w=8))
    jplan = j_default_plan(JCascadeConfig(w=8, use_pallas=False))
    pcfg = PlannerConfig(drop_mass_frac=frac)
    jpcfg = j_planner.PlannerConfig(drop_mass_frac=frac)
    dec = optimise_plan(plan, _synthetic_stats(TierStats, mass, survivors),
                        n=100, k=1, base_budget=64, pcfg=pcfg)
    jdec = j_optimise_plan(jplan,
                           _synthetic_stats(JTierStats, mass, survivors),
                           n=100, k=1, base_budget=64, pcfg=jpcfg)
    _same_decision(dec, jdec)


def test_tier_cost_weight_matches_jax():
    for cost in ("O(1)", "O(S)", "O(V)", "O(V^2)", "O(L)", "O(L*W)",
                 "O(weird)"):
        for L, v, w, s in [(48, 4, 8, 16), (256, 2, 300, 8)]:
            assert tier_cost_weight(cost, L, v, w, s) == \
                j_tier_cost_weight(cost, L, v, w, s)


# ---------------------------------------------------------------------------
# the committed count rows of BENCH_kernels.json
# ---------------------------------------------------------------------------


def _sched_store():
    """kernel_bench.py's plan_auto setup: 16 queries, N = 192, L = 256."""
    rng = np.random.default_rng(11)
    queries = rng.normal(size=(16, 256)).astype(np.float32)
    near = queries + 0.05 * rng.normal(size=(16, 256)).astype(np.float32)
    far = 5.0 + rng.normal(size=(176, 256)).astype(np.float32)
    return queries, np.concatenate([near, far], axis=0)


@pytest.mark.parametrize("w", [26, 77])
def test_plan_auto_n_dtw_rows(w):
    """``plan_auto_L256_w{26,77}_n_dtw`` = 16 / 18 and the tier mass rows,
    at the bench's own setup (static-plan budget resolved first)."""
    queries, series = _sched_store()
    q = torch.from_numpy(queries)
    idx = build_index(series, w, device="cpu")
    cascade = CascadeConfig(w=w)
    budget = resolve_adaptive_budget(q, idx, cascade, 1, None)
    cascade = dataclasses.replace(cascade, survivor_budget=budget)
    plr.plan_cache_clear()
    dec = calibrate_plan(q, idx, cascade, 1, plan=default_plan(cascade))
    res = nn_search(idx, queries, EngineConfig(cascade=cascade,
                                               verify_chunk=32, k=1),
                    plan=dec.plan)
    assert int(res.n_dtw.sum()) == BENCH[f"plan_auto_L256_w{w}_n_dtw"]
    assert float(dec.stats.mass.sum()) == \
        BENCH[f"plan_auto_L256_w{w}_tier_mass"]
    plr.plan_cache_clear()


def test_planner_drop_at_full_window_L256():
    """``plan_auto_L256_w256_n_dropped`` = 1: at w = L the pairwise tier
    measures no mass and is dropped; neighbours stay exact."""
    plr.plan_cache_clear()
    L, Q, w = 256, 4, 256
    ds = make_dataset(n_classes=4, n_train_per_class=48,
                      n_test_per_class=4, length=L, seed=11)
    idx = build_index(ds.x_train, w, ds.y_train, device="cpu")
    casc = CascadeConfig(w=w, survivor_budget=64)
    dec = calibrate_plan(torch.from_numpy(ds.x_test[:16]), idx, casc, k=1)
    assert len(dec.dropped) == BENCH["plan_auto_L256_w256_n_dropped"] == 1
    assert dec.dropped == ("enhanced_pairwise",)
    res = nn_search(idx, ds.x_test[:Q], EngineConfig(cascade=casc,
                                                     auto_plan=True))
    bd, bi = brute_force(idx, ds.x_test[:Q], w, k=1)
    assert torch.equal(res.idx, bi) and torch.equal(res.dists, bd)
    plr.plan_cache_clear()


# ---------------------------------------------------------------------------
# planner properties on the port alone
# ---------------------------------------------------------------------------


def test_auto_plan_exact_with_exclude():
    plr.plan_cache_clear()
    ds, idx, cfg = _setup(k=2)
    q = ds.x_train[:6]
    ex = torch.arange(6)
    res = nn_search(idx, q, cfg, exclude=ex)
    bd, bi = brute_force(idx, q, 8, k=2, exclude=ex)
    assert torch.equal(res.idx, bi) and torch.equal(res.dists, bd)
    assert (res.idx[:, 0] != ex.to(torch.int32)).all()
    plr.plan_cache_clear()


def test_planner_exact_on_skewed_store():
    plr.plan_cache_clear()
    rng = np.random.default_rng(7)
    Q, L, N, w, k = 8, 48, 96, 8, 2
    queries = rng.normal(size=(Q, L)).astype(np.float32)
    near = np.repeat(queries, 4, axis=0) \
        + 0.05 * rng.normal(size=(Q * 4, L)).astype(np.float32)
    far = 5.0 + rng.normal(size=(N - Q * 4, L)).astype(np.float32)
    idx = build_index(np.concatenate([near, far]).astype(np.float32), w,
                      device="cpu")
    cfg = EngineConfig(cascade=CascadeConfig(w=w, candidate_chunk=32),
                       verify_chunk=8, k=k, auto_plan=True)
    res = nn_search(idx, queries, cfg)
    res0 = nn_search(idx, queries, dataclasses.replace(cfg, auto_plan=False))
    bd, bi = brute_force(idx, queries, w, k=k)
    assert torch.equal(res.idx, bi) and torch.equal(res.dists, bd)
    assert (res.n_dtw <= res0.n_dtw).all()
    dec = _committed_decision()
    assert dec.dropped or (dec.budget is not None and dec.budget < idx.n)
    plr.plan_cache_clear()


def test_planner_drops_idle_bands_tier_at_w0():
    plr.plan_cache_clear()
    ds, idx, cfg = _setup(w=0)
    res = nn_search(idx, ds.x_test, cfg)
    res0 = nn_search(idx, ds.x_test, dataclasses.replace(cfg,
                                                         auto_plan=False))
    dec = _committed_decision()
    assert "bands" in dec.dropped and "bands" not in dec.order
    assert torch.equal(res.n_dtw, res0.n_dtw)
    plr.plan_cache_clear()


def test_planner_limit_mask_is_ndtw_neutral():
    plr.plan_cache_clear()
    ds, idx, cfg = _setup(w=12, seed=7, k=2)
    res = nn_search(idx, ds.x_test, cfg)
    res0 = nn_search(idx, ds.x_test, dataclasses.replace(cfg,
                                                         auto_plan=False))
    dec = _committed_decision()
    assert dec.limit is not None
    assert dec.budget is not None and dec.limit <= dec.budget
    assert torch.equal(res.dists, res0.dists)
    assert (res.n_dtw <= res0.n_dtw).all()
    plr.plan_cache_clear()


def test_economic_profile_drops_low_mass_tier_exactly():
    plr.plan_cache_clear()
    ds, idx, cfg = _setup(w=12, seed=0, k=1)
    pcfg = PlannerConfig(drop_mass_frac=0.02)
    q = torch.from_numpy(ds.x_test)
    dec = calibrate_plan(q, idx, cfg.cascade, k=1, pcfg=pcfg)
    base = calibrate_plan(q, idx, cfg.cascade, k=1)
    assert len(dec.order) <= len(base.order)
    res = nn_search(idx, ds.x_test, dataclasses.replace(cfg, planner=pcfg))
    bd, bi = brute_force(idx, ds.x_test, 12, k=1)
    assert torch.equal(res.idx, bi) and torch.equal(res.dists, bd)
    plr.plan_cache_clear()


def test_reorder_puts_best_mass_per_work_first():
    plr.plan_cache_clear()
    ds, idx, cfg = _setup(w=8)
    dec = calibrate_plan(torch.from_numpy(ds.x_test), idx, cfg.cascade, k=1)
    st = dec.stats
    ratios = dict(zip(st.names, st.mass_per_work()))
    ap = [n for n, s in zip(st.names, st.scopes)
          if s == "all_pairs" and n in dec.order]
    assert [n for n in dec.order if n in ap] == sorted(ap,
                                                       key=lambda n:
                                                       -ratios[n])
    plr.plan_cache_clear()


def test_plan_cache_keys_on_planner_config():
    plr.plan_cache_clear()
    ds, idx, cfg = _setup(w=12, seed=0)
    nn_search(idx, ds.x_test, cfg)
    assert plr.plan_cache_len() == 1
    nn_search(idx, ds.x_test, dataclasses.replace(
        cfg, planner=PlannerConfig(drop_mass_frac=0.05)))
    assert plr.plan_cache_len() == 2
    plr.plan_cache_clear()


def test_commit_cache_keys_on_store_w_k(monkeypatch):
    from repro_torch.search import engine as eng

    calls = []
    orig = plr.optimise_plan

    def counting(*a, **kw):
        calls.append(1)
        return orig(*a, **kw)

    monkeypatch.setattr(eng._planner, "optimise_plan", counting)
    plr.plan_cache_clear()
    ds, idx, cfg = _setup(w=8)
    nn_search(idx, ds.x_test, cfg)
    nn_search(idx, ds.x_test, cfg)
    assert len(calls) == 1
    nn_search(idx, ds.x_test, dataclasses.replace(cfg, k=2))
    assert len(calls) == 2
    idx12 = build_index(ds.x_train, 12, ds.y_train, device="cpu")
    nn_search(idx12, ds.x_test, dataclasses.replace(
        cfg, cascade=dataclasses.replace(cfg.cascade, w=12)))
    assert len(calls) == 3 and plr.plan_cache_len() == 3
    plr.plan_cache_clear()


def test_build_index_calibration_warms_serving(monkeypatch):
    from repro_torch.search import engine as eng

    plr.plan_cache_clear()
    ds = _data()
    cfg = EngineConfig(cascade=CascadeConfig(w=8, candidate_chunk=16),
                       verify_chunk=4, k=1, auto_plan=True)
    idx = build_index(ds.x_train, 8, ds.y_train, device="cpu", calibrate=cfg)
    assert plr.plan_cache_len() == 1
    calls = []
    monkeypatch.setattr(eng._planner, "optimise_plan",
                        lambda *a, **kw: calls.append(1))
    res = nn_search(idx, ds.x_test, cfg)
    assert not calls
    bd, bi = brute_force(idx, ds.x_test, 8, k=1)
    assert torch.equal(res.idx, bi) and torch.equal(res.dists, bd)
    plr.plan_cache_clear()


def test_with_stats_reports_measurement_and_decision():
    plr.plan_cache_clear()
    ds, idx, cfg = _setup(w=8, k=2)
    res, stats = nn_search(idx, ds.x_test, cfg, with_stats=True)
    assert stats.calibrated
    assert stats.plan_tiers == _committed_decision().order
    assert tuple(stats.tiers.names) == ("kim", "bands", "enhanced_pairwise")
    assert torch.equal(stats.n_dtw, res.n_dtw)
    text = stats.table()
    assert "mass/work" in text and "kim" in text and "n_dtw" in text
    assert "guards[ok]" in text and stats.degraded is False
    dense = dataclasses.replace(
        cfg, auto_plan=False,
        cascade=dataclasses.replace(cfg.cascade, staged=False))
    with pytest.raises(ValueError, match="staged"):
        nn_search(idx, ds.x_test, dense, with_stats=True)
    plr.plan_cache_clear()


def test_degenerate_calibration_commits_base_plan_unchanged():
    plr.plan_cache_clear()
    ds = _data()
    twins = np.concatenate([ds.x_train, ds.x_train], axis=0)
    cfg = EngineConfig(cascade=CascadeConfig(w=8, candidate_chunk=16),
                       verify_chunk=4, k=1, auto_plan=True)
    idx = build_index(twins, 8, device="cpu", calibrate=cfg)
    dec = _committed_decision()
    assert dec.dropped == () and dec.plan is dec.base
    assert dec.budget is None and dec.limit is None
    res = nn_search(idx, ds.x_test, cfg)
    res0 = nn_search(idx, ds.x_test, dataclasses.replace(cfg,
                                                         auto_plan=False))
    assert (res.n_dtw <= res0.n_dtw).all()
    bd, bi = brute_force(idx, ds.x_test, 8, k=1)
    assert torch.equal(res.dists, bd)
    plr.plan_cache_clear()


def test_pairwise_survivor_keeps_a_selection_tier():
    plan = default_plan(CascadeConfig(w=8))
    stats = _synthetic_stats(TierStats, [0.0, 0.0, 5.0], [10.0] * 4)
    dec = optimise_plan(plan, stats, n=100, k=1, base_budget=64)
    kept = [t.scope for t in dec.plan.tiers]
    assert "pairwise" in kept and "all_pairs" in kept
    assert set(dec.dropped) <= {"kim", "bands"} and len(dec.dropped) == 1


def test_plan_cache_keys_on_limit_policy():
    plr.plan_cache_clear()
    ds, idx, cfg = _setup(w=8)
    base = default_plan(cfg.cascade)

    def policy_a(lb01, B, k):
        return torch.full((lb01.shape[0],), 4)

    def policy_b(lb01, B, k):
        return torch.full((lb01.shape[0],), 6)

    plan_a = dataclasses.replace(base, compaction=Compaction(
        budget=8, limit_fn=policy_a))
    plan_b = dataclasses.replace(base, compaction=Compaction(
        budget=8, limit_fn=policy_b))
    q = torch.from_numpy(ds.x_test)
    dec_a = calibrate_plan(q, idx, cfg.cascade, 1, plan=plan_a)
    assert plr.lookup_plan(idx, cfg.cascade, 1, plan_b) is None
    dec_b = calibrate_plan(q, idx, cfg.cascade, 1, plan=plan_b)
    assert plr.plan_cache_len() == 2
    assert plr.lookup_plan(idx, cfg.cascade, 1, plan_a) is dec_a
    assert plr.lookup_plan(idx, cfg.cascade, 1, plan_b) is dec_b
    # a limit policy never changes the neighbours
    res = nn_search(idx, ds.x_test, dataclasses.replace(cfg, auto_plan=False),
                    plan=plan_a)
    bd, bi = brute_force(idx, ds.x_test, 8, k=1)
    assert torch.equal(res.idx, bi) and torch.equal(res.dists, bd)
    plr.plan_cache_clear()


def test_optimise_plan_rejects_mismatched_stats():
    ds, idx, cfg = _setup(w=8)
    plan = default_plan(cfg.cascade)
    cres = run_plan(torch.from_numpy(ds.x_test), idx, cfg.cascade, plan,
                    k=1, collect_stats=True)
    other = dataclasses.replace(plan, tiers=plan.tiers[1:])
    with pytest.raises(ValueError, match="do not match"):
        optimise_plan(other, cres.stats, n=idx.n, k=1, base_budget=64)


def test_list_and_unregister_tiers_idempotent():
    before = list_tiers()
    assert {"sketch", "kim", "bands", "enhanced_pairwise", "enhanced_dense",
            "lb_improved"} <= set(before)

    @register_tier("throwaway_probe_tier")
    def throwaway() -> BoundTier:
        return BoundTier("throwaway_probe_tier", cost="O(1)",
                         scope="all_pairs", fn=lambda q, i, c: None)

    assert "throwaway_probe_tier" in list_tiers()
    assert list_tiers() == registered_tiers()
    assert unregister_tier("throwaway_probe_tier") is True
    assert unregister_tier("throwaway_probe_tier") is False
    assert unregister_tier("never_registered") is False
    assert list_tiers() == before
