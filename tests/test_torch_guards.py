"""The port's exactness guards and fault injectors on the CPU
(search/guards.py, testing/faults.py), against the JAX package's.

  * clean data: guards change no result, and every counter equals the
    JAX engine's on the same data;
  * every injector trips the guard built for it;
  * a tripped trigger guard degrades: the batch is re-served by brute
    force through the plain versions (the ``dtw_out`` seam lies in
    ``kernels/ops.py`` only, so the rerun cannot meet an injected kernel
    fault) and equals an independent brute force;
  * non-finite faults are contained (counted and gated, results exact)
    without degrading, except NaN verification values;
  * input hygiene at ``build_index`` / ``nn_search`` rejects or
    sanitizes NaN/Inf and zero-variance series.

The JAX package's distributed guard tests belong to distributed search,
which the port does not have yet.
"""

import dataclasses
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.search import CascadeConfig as JCascadeConfig
from repro.search import EngineConfig as JEngineConfig
from repro.search import build_index as j_build_index
from repro.search import nn_search as j_nn_search
from repro.search.guards import GuardReport as JGuardReport
from repro.search.guards import GuardWarning as JGuardWarning
from repro.testing import faults as j_faults
from repro_torch.search import (
    CascadeConfig,
    EngineConfig,
    GuardConfig,
    GuardReport,
    GuardWarning,
    brute_force,
    build_index,
    nn_search,
    preflight_engine,
    validate_series,
)
from repro_torch.search import guards as guards_mod
from repro_torch.search.planner import PlannerConfig, calibrate_plan
from repro_torch.testing import faults

W, K = 4, 2


def _store(n=48, length=24, n_q=6, seed=7):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, length)).astype(np.float32)
    q = rng.normal(size=(n_q, length)).astype(np.float32)
    return x, q


def _cfg(use_kernels=True, guards=None, **kw):
    return EngineConfig(
        cascade=CascadeConfig(w=W, v=4, candidate_chunk=16,
                              use_kernels=use_kernels, **kw),
        verify_chunk=8, k=K, guards=guards)


def _search(idx, q, cfg):
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        res, rep = nn_search(idx, q, cfg, with_guards=True)
    gw = [x for x in w if issubclass(x.category, GuardWarning)]
    return res, rep, gw


def _count(rep, field):
    return float(getattr(rep, field))


@pytest.fixture()
def store():
    x, q = _store()
    idx = build_index(x, W, device="cpu")
    bd, bi = brute_force(idx, q, W, K, use_kernels=False)
    return idx, q, bd, bi


def _exact(res, bd, bi):
    assert torch.equal(res.dists, bd) and torch.equal(res.idx, bi)


# ---------------------------------------------------------------------------
# clean path: no result changes, counters equal to JAX's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("forced", [False, True])
def test_clean_guarded_run_bit_equal_and_counters_zero(store, monkeypatch,
                                                       forced):
    if forced:
        monkeypatch.setenv("REPRO_FORCE_GUARDS", "1")
    else:
        monkeypatch.delenv("REPRO_FORCE_GUARDS", raising=False)
    idx, q, bd, bi = store
    res_off = nn_search(idx, q, _cfg(guards=GuardConfig(enabled=False)))
    res_on, rep, gw = _search(idx, q, _cfg())
    assert torch.equal(res_on.dists, res_off.dists)
    assert torch.equal(res_on.n_dtw, res_off.n_dtw)
    _exact(res_on, bd, bi)
    assert rep.ok() and rep.tripped() == ()
    for f in ("admiss_viol", "conserve_viol", "account_viol",
              "nonfinite_bounds", "nonfinite_dtw", "degraded"):
        assert _count(rep, f) == 0.0, f
    assert _count(rep, "admiss_checked") > 0
    assert _count(rep, "conserve_checked") > 0
    assert not gw


def test_clean_guard_counters_equal_jax(store):
    """Every counter of a clean guarded search, the number of checks
    included, equals the JAX engine's on the same data."""
    idx, q, _, _ = store
    x, _ = _store()
    _, rep, _ = _search(idx, q, _cfg())
    jcfg = JEngineConfig(cascade=JCascadeConfig(w=W, v=4, candidate_chunk=16,
                                                use_pallas=False),
                         verify_chunk=8, k=K)
    _, jrep = j_nn_search(j_build_index(x, W), jnp.asarray(q), jcfg,
                          with_guards=True)
    np.testing.assert_array_equal(rep.to_vector().numpy(),
                                  np.asarray(jrep.to_vector()))


def test_guard_report_vector_roundtrip_and_merge():
    rep = dataclasses.replace(
        GuardReport.zeros(), admiss_checked=torch.tensor(10.0),
        admiss_viol=torch.tensor(2.0), admiss_gap=torch.tensor(0.5),
        nonfinite_dtw=torch.tensor(3.0))
    back = GuardReport.from_vector(rep.to_vector())
    for f in guards_mod._VEC_FIELDS:
        assert _count(back, f) == _count(rep, f), f
    merged = rep.merge(rep)
    assert _count(merged, "admiss_checked") == 20.0
    assert _count(merged, "admiss_gap") == 0.5          # max, not sum
    assert merged.tripped() == ("admiss_viol", "nonfinite_dtw")
    assert guards_mod._VEC_FIELDS == tuple(
        f.name for f in dataclasses.fields(JGuardReport))
    assert "TRIPPED" in merged.summary()


def test_forced_guards_env(monkeypatch):
    monkeypatch.setenv("REPRO_FORCE_GUARDS", "1")
    g = guards_mod.resolve_guards(GuardConfig(enabled=False))
    assert g.enabled and g.admissibility and g.conservation
    monkeypatch.setenv("REPRO_FORCE_GUARDS", "0")
    assert not guards_mod.resolve_guards(GuardConfig(enabled=False)).enabled
    assert guards_mod.resolve_guards(None) == GuardConfig()


# ---------------------------------------------------------------------------
# trigger guards: the injector trips, degradation restores exactness
# ---------------------------------------------------------------------------


def test_inadmissible_tier_trips_and_degrades(store):
    idx, q, bd, bi = store
    with faults.inadmissible_tier():
        res, rep, gw = _search(idx, q, _cfg())
    assert "admiss_viol" in rep.tripped()
    assert _count(rep, "degraded") == 1.0 and len(gw) == 1
    assert (res.n_dtw == idx.n).all()
    _exact(res, bd, bi)


def test_inadmissible_tier_trips_like_jax(store):
    """The same fault on both packages trips the same guards."""
    idx, q, _, _ = store
    x, _ = _store()
    with faults.inadmissible_tier():
        _, rep, _ = _search(idx, q, _cfg())
    jcfg = JEngineConfig(cascade=JCascadeConfig(w=W, v=4, candidate_chunk=16,
                                                use_pallas=False),
                         verify_chunk=8, k=K)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with j_faults.inadmissible_tier():
            _, jrep = j_nn_search(j_build_index(x, W), jnp.asarray(q), jcfg,
                                  with_guards=True)
    assert rep.tripped() == jrep.tripped()
    for f in ("admiss_viol", "degraded"):
        assert _count(rep, f) == float(np.asarray(getattr(jrep, f))), f


def test_corrupt_dtw_scale_trips_admissibility(store):
    idx, q, bd, bi = store
    with faults.corrupt_dtw():
        res, rep, gw = _search(idx, q, _cfg())
    assert "admiss_viol" in rep.tripped()
    assert _count(rep, "degraded") == 1.0
    _exact(res, bd, bi)


def test_corrupt_dtw_blind_at_long_band_like_jax():
    """A 20x DTW shrink at a long series with a wide band (L = 512,
    w = 0.1 L, V = 4, k = 1, the synthetic generator) goes unseen, in the
    port as in the JAX engine: the shrunk seed DTW becomes the later
    pairs' cutoff, they abandon to +inf, which admissibility skips, and
    the seeds' own bound is under 5 % of their DTW.  Both packages give
    the same guard report and the same wrong distances."""
    from repro_torch.data import make_dataset
    from repro_torch.kernels import ref

    ds = make_dataset(n_classes=8, n_train_per_class=8, n_test_per_class=1,
                      length=512, seed=7)
    w, scale = 51, 0.05
    x, q = ds.x_train, ds.x_test[:4]
    idx = build_index(x, w, device="cpu")
    cfg = EngineConfig(cascade=CascadeConfig(w=w, v=4), verify_chunk=32, k=1)
    with faults.corrupt_dtw(scale=scale):
        res, rep, gw = _search(idx, q, cfg)
    jcfg = JEngineConfig(cascade=JCascadeConfig(w=w, v=4, use_pallas=True),
                         verify_chunk=32, k=1)
    with warnings.catch_warnings(record=True) as jw:
        warnings.simplefilter("always")
        with j_faults.corrupt_dtw(scale=scale):
            jres, jrep = j_nn_search(j_build_index(x, w), jnp.asarray(q),
                                     jcfg, with_guards=True)
    assert rep.tripped() == () and jrep.tripped() == ()
    assert not gw
    assert not [m for m in jw if issubclass(m.category, JGuardWarning)]
    np.testing.assert_array_equal(rep.to_vector().numpy(),
                                  np.asarray(jrep.to_vector()))
    # the seeds are the only admissibility samples
    assert _count(rep, "admiss_checked") == len(q)
    seeds = idx.series[res.idx[:, 0].long()]
    d = ref.dtw_band_ref(torch.as_tensor(q), seeds, w)
    u, lo = ref.envelope_ref(seeds, w)
    lb = ref.lb_enhanced_pairwise_ref(torch.as_tensor(q), seeds, u, lo, w, 4)
    assert (lb < scale * d).all()
    # the fault went through: the returned distances are the shrunk ones
    torch.testing.assert_close(res.dists[:, 0], d * scale, rtol=0, atol=0)
    np.testing.assert_array_equal(np.asarray(jres.idx), res.idx.numpy())
    bd, bi = brute_force(idx, q, w, 1, use_kernels=False)
    assert not torch.equal(res.idx, bi)


def test_corrupt_dtw_nan_trips_nonfinite_and_degrades(store):
    idx, q, bd, bi = store
    with faults.corrupt_dtw(value=np.nan):
        res, rep, gw = _search(idx, q, _cfg())
    assert "nonfinite_dtw" in rep.tripped()
    assert _count(rep, "nonfinite_dtw") > 0 and _count(rep, "degraded") > 0
    _exact(res, bd, bi)


def test_drop_compaction_candidates_trips_conservation(store):
    idx, q, bd, bi = store
    with faults.drop_compaction_candidates():
        res, rep, gw = _search(idx, q, _cfg())
    assert "conserve_viol" in rep.tripped()
    assert _count(rep, "degraded") > 0
    _exact(res, bd, bi)


def test_miscount_verifications_trips_accounting(store):
    idx, q, bd, bi = store
    with faults.miscount_verifications():
        res, rep, gw = _search(idx, q, _cfg())
    assert "account_viol" in rep.tripped()
    _exact(res, bd, bi)


def test_inward_quantiser_trips_and_degrades():
    """A build-time fault: the inverted sketch inflates the tier-(-1)
    bound, the seed admissibility check trips, and the plain brute force
    (which never reads the sketch) serves the batch exactly."""
    x, q = _store()
    with faults.inward_quantiser():
        bad = build_index(x, W, device="cpu")
    assert bad.sk_lo is not None
    bd, bi = brute_force(bad, q, W, K, use_kernels=False)
    res, rep, gw = _search(bad, q, _cfg(use_sketch=True))
    assert "admiss_viol" in rep.tripped()
    assert _count(rep, "degraded") > 0 and len(gw) == 1
    _exact(res, bd, bi)
    res2, rep2, _ = _search(bad, q, _cfg())         # no sketch tier: clean
    assert rep2.tripped() == ()
    _exact(res2, bd, bi)


def test_degrade_false_reports_but_serves_raw(store, monkeypatch):
    monkeypatch.delenv("REPRO_FORCE_GUARDS", raising=False)
    idx, q, _, _ = store
    with faults.inadmissible_tier():
        res, rep, gw = _search(idx, q, _cfg(guards=GuardConfig(
            degrade=False)))
    assert "admiss_viol" in rep.tripped()
    assert _count(rep, "degraded") == 0.0
    assert not gw


def test_with_stats_surfaces_the_degradation(store):
    idx, q, bd, bi = store
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with faults.inadmissible_tier():
            res, stats = nn_search(idx, q, _cfg(), with_stats=True)
    assert stats.degraded and "admiss_viol" in stats.guards.tripped()
    assert "DEGRADED" in stats.table()
    _exact(res, bd, bi)


# ---------------------------------------------------------------------------
# containment guards: counted and gated, results exact, no trip
# ---------------------------------------------------------------------------


def test_poison_envelopes_contained(store):
    idx, q, bd, bi = store
    bad = faults.poison_envelopes(idx, rows=(0, 3, 5))
    res, rep, gw = _search(bad, q, _cfg())
    assert _count(rep, "nonfinite_bounds") > 0 and rep.tripped() == ()
    _exact(res, bd, bi)


def test_nonfinite_tier_contained(store):
    idx, q, bd, bi = store
    with faults.nonfinite_tier():
        res, rep, gw = _search(idx, q, _cfg())
    assert _count(rep, "nonfinite_bounds") > 0 and rep.tripped() == ()
    _exact(res, bd, bi)


def test_corrupt_packed_rows_contained(store):
    idx, q, bd, bi = store
    with faults.corrupt_packed_rows():
        res, rep, gw = _search(idx, q, _cfg())
    assert _count(rep, "nonfinite_bounds") > 0 and rep.tripped() == ()
    _exact(res, bd, bi)


def test_gates_off_nan_bounds_would_poison(store):
    # NaN bounds with the gates on stay exact; a NaN bound is never
    # treated as "never verify" (verification_eligible)
    idx, q, bd, bi = store
    with faults.nonfinite_tier(value=np.inf):
        res, rep, gw = _search(idx, q, _cfg())
    _exact(res, bd, bi)
    slb = torch.tensor([float("nan"), -float("inf"), 1.0, float("inf")])
    assert guards_mod.verification_eligible(slb).tolist() == [
        True, True, True, False]


# ---------------------------------------------------------------------------
# input hygiene (boundary)
# ---------------------------------------------------------------------------


def test_hygiene_build_index_rejects_nan():
    x, _ = _store()
    bad = faults.corrupt_series(x, rows=(1, 4), cols=(0, 3))
    with pytest.raises(ValueError, match="series"):
        build_index(bad, W, device="cpu")


def test_hygiene_build_index_sanitize_masks_and_warns():
    x, q = _store()
    bad = faults.corrupt_series(x, rows=(1,), cols=(0, 3), value=np.inf)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        idx = build_index(bad, W, device="cpu", sanitize=True)
    assert any(issubclass(c.category, GuardWarning) for c in w)
    assert torch.isfinite(idx.series).all()
    res, rep, _ = _search(idx, q, _cfg())
    assert torch.isfinite(res.dists).all()


def test_hygiene_query_rejects_and_sanitizes(store):
    idx, q, bd, _ = store
    badq = faults.corrupt_series(q, rows=(0,), cols=(2,))
    with pytest.raises(ValueError, match="query"):
        nn_search(idx, badq, _cfg())
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        res, rep = nn_search(idx, badq, _cfg(), with_guards=True,
                             sanitize=True)
    assert any(issubclass(c.category, GuardWarning) for c in w)
    assert _count(rep, "hygiene_values") == 1.0
    assert torch.equal(res.dists[1:], bd[1:])


def test_hygiene_flat_series_under_normalize():
    x, _ = _store()
    x[2] = 1.5
    with pytest.raises(ValueError, match="zero-variance"):
        build_index(x, W, device="cpu", normalize=True)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        idx = build_index(x, W, device="cpu", normalize=True, sanitize=True)
    assert any(issubclass(c.category, GuardWarning) for c in w)
    assert torch.isfinite(idx.series).all()
    with pytest.warns(GuardWarning, match="zero-variance"):
        _, report = validate_series(torch.from_numpy(x), check_flat=True,
                                    sanitize=True)
    assert report.flat_series == 1
    assert guards_mod.hygiene_to_report(report).hygiene_flat == 1.0


# ---------------------------------------------------------------------------
# preflight, the planner's fallback, warn_once
# ---------------------------------------------------------------------------


def test_preflight_engine_ok_and_cached():
    guards_mod.preflight_clear()
    try:
        assert preflight_engine("cpu") is True
        assert preflight_engine("cpu") is True
        assert len(guards_mod._PREFLIGHT_CACHE) == 1
    finally:
        guards_mod.preflight_clear()


def test_build_index_preflight_flag():
    x, _ = _store(n=32, length=16)
    guards_mod.preflight_clear()
    try:
        build_index(x, W, device="cpu", preflight=True)
        assert ("engine", torch.__version__, "cpu") in \
            guards_mod._PREFLIGHT_CACHE
    finally:
        guards_mod.preflight_clear()


def test_warn_once_counts():
    guards_mod.preflight_clear()
    try:
        with pytest.warns(GuardWarning, match="canary"):
            assert guards_mod.warn_once("probe", "canary") is True
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            assert guards_mod.warn_once("probe", "canary") is False
        assert guards_mod.warn_count("probe") == 2
    finally:
        guards_mod.preflight_clear()


def test_calibrate_plan_falls_back_on_tripped_guard(store):
    idx, q, _, _ = store
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        with faults.inadmissible_tier():
            dec = calibrate_plan(torch.from_numpy(q), idx, _cfg().cascade,
                                 K, pcfg=PlannerConfig())
    assert any(issubclass(c.category, GuardWarning) for c in w)
    assert dec.dropped == () and dec.plan is dec.base


# ---------------------------------------------------------------------------
# injector harness hygiene
# ---------------------------------------------------------------------------


def test_inject_rejects_nested_same_seam():
    with faults.miscount_verifications():
        with pytest.raises(RuntimeError, match="already injected"):
            with faults.miscount_verifications():
                pass
    assert "engine_count" not in guards_mod._FAULT_HOOKS


def test_seams_empty_after_faults():
    x, q = _store(n=16, length=16, n_q=2)
    idx = build_index(x, W, device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with faults.drop_compaction_candidates():
            nn_search(idx, q, _cfg())
    assert guards_mod._FAULT_HOOKS == {}
