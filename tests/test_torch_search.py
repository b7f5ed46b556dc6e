"""The port's search path on the CPU against the JAX package: the index,
the tier pipeline, ``nn_search``, ``classify`` and both brute forces.

The same numpy data (``make_dataset`` from a seed; the port's copy gives
the same arrays) goes to both packages.  The JAX side runs its jnp
references (``use_pallas=False``, which its own tests hold equal to the
Pallas kernels) with its exactness guards off: the guards change nothing
on clean data (property-tested in tests/test_guards.py) and dominate the
JAX run time at this size.

Neighbour ids and per-query ``n_dtw`` must be equal; distances and bounds
agree to rtol 1e-5 (XLA contracts the DTW cell update into an FMA on the
CPU, the port keeps it unfused as its kernel does).
"""

import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import make_dataset as j_make_dataset
from repro.search import CascadeConfig as JCascadeConfig
from repro.search import EngineConfig as JEngineConfig
from repro.search import brute_force as j_brute_force
from repro.search import build_index as j_build_index
from repro.search import classify as j_classify
from repro.search import nn_search as j_nn_search
from repro.search.cascade import run_plan as j_run_plan
from repro.search.guards import GuardConfig
from repro_torch.data import make_dataset
from repro_torch.search import (
    CascadeConfig,
    EngineConfig,
    brute_force,
    build_index,
    classify,
    index_from_numpy,
    nn_search,
    run_plan,
    validate_series,
)
from repro_torch.search.pipeline import default_plan

L = 41                       # odd
W = L // 4
DATA = dict(n_classes=3, n_train_per_class=24, n_test_per_class=6,
            length=L, seed=3)
CHUNK, VERIFY = 16, 4
_NO_GUARDS = GuardConfig(enabled=False)


@pytest.fixture(scope="module")
def ds():
    d = make_dataset(**DATA)
    jd = j_make_dataset(**DATA)
    for name in ("x_train", "y_train", "x_test", "y_test"):
        np.testing.assert_array_equal(getattr(d, name), getattr(jd, name))
    return d


@pytest.fixture(scope="module")
def indexes(ds):
    """Per-window (port index, JAX index), built once."""
    cache = {}

    def get(w):
        if w not in cache:
            cache[w] = (build_index(ds.x_train, w, ds.y_train, device="cpu"),
                        j_build_index(ds.x_train, w, ds.y_train,
                                      sketch=None))
        return cache[w]

    return get


@pytest.fixture(scope="module")
def jax_search(ds, indexes):
    """JAX ``nn_search`` results per (w, k, exclude), computed once."""
    cache = {}

    def get(w, k, exclude):
        key = (w, k, exclude)
        if key not in cache:
            _, jidx = indexes(w)
            cfg = JEngineConfig(
                cascade=JCascadeConfig(w=w, v=4, use_pallas=False,
                                       candidate_chunk=CHUNK),
                verify_chunk=VERIFY, k=k, guards=_NO_GUARDS)
            ex, q = _queries(ds, exclude)
            res = j_nn_search(jidx, q, cfg,
                              exclude=None if ex is None else jnp.asarray(ex))
            cache[key] = res
        return cache[key]

    return get


def _queries(ds, exclude):
    """Plain test queries, or leave-one-out: store members searched with
    themselves excluded."""
    if not exclude:
        return None, ds.x_test
    ex = np.arange(0, ds.x_train.shape[0], 4, dtype=np.int32)
    return ex, ds.x_train[ex]


def _engine(w, k, **kw):
    return EngineConfig(cascade=CascadeConfig(w=w, v=4,
                                              candidate_chunk=CHUNK, **kw),
                        verify_chunk=VERIFY, k=k)


def test_build_index_matches_jax(indexes):
    idx, jidx = indexes(W)
    assert idx.w == jidx.w and idx.n == jidx.n and idx.length == L
    for name in ("series", "labels", "upper", "lower", "kim", "kim_ok"):
        np.testing.assert_array_equal(getattr(idx, name).numpy(),
                                      np.asarray(getattr(jidx, name)))
    assert idx.labels.dtype == torch.int32 and idx.kim_ok.dtype == torch.bool


def test_index_from_numpy_round_trip(ds, indexes):
    idx, jidx = indexes(W)
    fields = ("series", "labels", "upper", "lower", "kim", "kim_ok")
    moved = index_from_numpy({f: np.asarray(getattr(jidx, f))
                              for f in fields}, jidx.w, device="cpu")
    for f in fields:
        assert torch.equal(getattr(moved, f), getattr(idx, f))
    cfg = _engine(W, 1)
    a = nn_search(moved, ds.x_test, cfg)
    b = nn_search(idx, ds.x_test, cfg)
    assert torch.equal(a.idx, b.idx) and torch.equal(a.dists, b.dists)


@pytest.mark.parametrize("k", [1, 3])
def test_run_plan_matches_jax(ds, indexes, k):
    idx, jidx = indexes(W)
    q = ds.x_test
    ex = np.arange(q.shape[0], dtype=np.int32) * 3
    cfg = CascadeConfig(w=W, v=4, candidate_chunk=CHUNK, survivor_budget=24)
    jcfg = JCascadeConfig(w=W, v=4, use_pallas=False, candidate_chunk=CHUNK,
                          survivor_budget=24)
    res = run_plan(torch.from_numpy(q), idx, cfg, k=k,
                   exclude=torch.from_numpy(ex).long())
    jres = j_run_plan(jnp.asarray(q), jidx, jcfg, k=k,
                      exclude=jnp.asarray(ex), guards=_NO_GUARDS)
    np.testing.assert_array_equal(res.seed_idx.numpy(),
                                  np.asarray(jres.seed_idx))
    np.testing.assert_allclose(res.seed_d.numpy(), np.asarray(jres.seed_d),
                               rtol=1e-5)
    np.testing.assert_allclose(res.lb.numpy(), np.asarray(jres.lb),
                               rtol=1e-5, atol=1e-6)


# (w, k, exclude): k in {1, 3} with and without leave-one-out at w = L/4,
# and the other windows of the sweep at k = 1
SEARCH_CASES = [(W, 1, False), (W, 3, False), (W, 1, True), (W, 3, True),
                (0, 1, False), (1, 3, True), (L, 1, False)]


@pytest.mark.parametrize("schedule", ["bound", "index"])
@pytest.mark.parametrize("w,k,exclude", SEARCH_CASES)
def test_nn_search_matches_jax_and_brute_force(ds, indexes, jax_search, w, k,
                                               exclude, schedule):
    idx, jidx = indexes(w)
    ex, q = _queries(ds, exclude)
    cfg = _engine(w, k)
    res = nn_search(idx, q, cfg, exclude=ex,
                    plan=default_plan(cfg.cascade, schedule=schedule))
    jres = jax_search(w, k, exclude)
    np.testing.assert_array_equal(res.idx.numpy(), np.asarray(jres.idx))
    np.testing.assert_array_equal(res.n_dtw.numpy(), np.asarray(jres.n_dtw))
    np.testing.assert_allclose(res.dists.numpy(), np.asarray(jres.dists),
                               rtol=1e-5)
    assert res.idx.dtype == torch.int32 and res.n_dtw.dtype == torch.int32
    bd, bi = brute_force(idx, q, w, k=k, exclude=ex)
    assert torch.equal(bi, res.idx) and torch.equal(bd, res.dists)
    if ex is not None:
        assert not (res.idx.numpy() == ex[:, None]).any()
    assert (res.n_dtw >= k).all() and (res.n_dtw <= idx.n).all()


def test_brute_forces_agree(ds, indexes):
    idx, jidx = indexes(W)
    bd, bi = brute_force(idx, ds.x_test, W, k=3, chunk=20)
    pd, pi = brute_force(idx, ds.x_test, W, k=3, use_kernels=False)
    jd, ji = j_brute_force(jidx, ds.x_test, W, k=3, use_pallas=False)
    assert torch.equal(bi, pi) and torch.equal(bd, pd)
    np.testing.assert_array_equal(bi.numpy(), np.asarray(ji))
    np.testing.assert_allclose(bd.numpy(), np.asarray(jd), rtol=1e-5)


@pytest.mark.parametrize("k", [1, 3])
def test_classify_matches_jax(ds, indexes, k):
    idx, jidx = indexes(W)
    pred, res = classify(idx, ds.x_test, _engine(W, k))
    jcfg = JEngineConfig(
        cascade=JCascadeConfig(w=W, v=4, use_pallas=False,
                               candidate_chunk=CHUNK),
        verify_chunk=VERIFY, k=k, guards=_NO_GUARDS)
    jpred, _ = j_classify(jidx, ds.x_test, jcfg)
    np.testing.assert_array_equal(pred.numpy(), np.asarray(jpred))
    assert pred.dtype == torch.int32
    assert (pred.numpy() == ds.y_test).mean() > 0.8


def test_dense_and_unkernelled_configs_give_the_same_neighbours(ds,
                                                                indexes):
    idx, _ = indexes(W)
    base = nn_search(idx, ds.x_test, _engine(W, 3))
    for cfg in (_engine(W, 3, staged=False), _engine(W, 3, use_kernels=False),
                _engine(W, 3, use_kim=False, adaptive_budget=False)):
        res = nn_search(idx, ds.x_test, cfg)
        assert torch.equal(res.idx, base.idx)
        assert torch.equal(res.dists, base.dists)


def test_import_loads_no_jax():
    src = Path(__file__).resolve().parents[1] / "src"
    code = (
        "import sys, repro_torch, repro_torch.search, repro_torch.data, "
        "repro_torch.kernels.ops; "
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro')]; "
        "print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=str(src))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_default_device_is_cuda_and_raises_without_a_card(ds, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_index(ds.x_train, W, ds.y_train)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_index(ds.x_train, W, ds.y_train, device="cuda")


def test_build_index_refuses_unported_options(ds):
    # the sketch store, plan calibration and the store mask are ported
    # now: build_index takes them, and the sketch equals the JAX index's
    from repro_torch.search.planner import plan_cache_clear, plan_cache_len

    jidx = j_build_index(ds.x_train, W, ds.y_train)
    idx = build_index(ds.x_train, W, ds.y_train, device="cpu")   # sketch=16
    for name in ("sk_lo", "sk_hi", "sk_scale"):
        np.testing.assert_array_equal(getattr(idx, name).numpy(),
                                      np.asarray(getattr(jidx, name)))
    plan_cache_clear()
    cfg = EngineConfig(cascade=CascadeConfig(w=W, v=4, use_sketch=True,
                                             candidate_chunk=CHUNK),
                       verify_chunk=VERIFY, k=1)
    masked = build_index(ds.x_train, W, device="cpu", calibrate=cfg,
                         mask=True)
    assert plan_cache_len() == 1
    assert masked.live is not None and masked.live.shape == (idx.n,)
    assert idx.live is None and build_index(ds.x_train, W, device="cpu",
                                            sketch=None).sk_lo is None
    plan_cache_clear()


def test_input_hygiene_rejects_or_sanitizes(ds):
    x = ds.x_train.copy()
    x[3, 5] = np.nan
    x[7, :] = np.inf
    with pytest.raises(ValueError, match="non-finite"):
        build_index(x, W, device="cpu")
    with pytest.warns(UserWarning, match="sanitized"):
        idx = build_index(x, W, device="cpu", sanitize=True)
    row3 = np.delete(ds.x_train[3], 5)
    assert idx.series[3, 5].item() == pytest.approx(float(row3.mean()),
                                                    rel=1e-5)
    assert torch.equal(idx.series[7], torch.zeros(L))
    flat = ds.x_train.copy()
    flat[2] = 1.0
    with pytest.raises(ValueError, match="zero-variance"):
        build_index(flat, W, device="cpu", normalize=True)
    _, report = validate_series(torch.from_numpy(ds.x_test))
    assert not report.any()
    q = ds.x_test.copy()
    q[0, 0] = np.inf
    clean = build_index(ds.x_train, W, device="cpu")
    with pytest.raises(ValueError, match="query"):
        nn_search(clean, q, _engine(W, 1))


def test_plan_validation_custom_tier_and_fixed_budget(ds, indexes):
    from repro_torch.search.pipeline import (
        BoundTier, Compaction, VerificationPlan, get_tier, register_tier)

    idx, _ = indexes(W)
    with pytest.raises(ValueError, match="compaction point"):
        VerificationPlan(tiers=(get_tier("enhanced_pairwise"),
                                get_tier("bands")))
    with pytest.raises(ValueError, match="schedule"):
        VerificationPlan(tiers=(), schedule="random")
    with pytest.raises(KeyError, match="unknown tier"):
        get_tier("no_such_tier")

    @register_tier("zero_test_tier")
    def _zero():
        return BoundTier("zero_test_tier", cost="O(1)", scope="all_pairs",
                         fn=lambda q, index, cfg: torch.zeros(q.shape[0],
                                                              index.n))

    cfg = _engine(W, 3)
    base = nn_search(idx, ds.x_test, cfg)
    plan = VerificationPlan(
        tiers=(get_tier("zero_test_tier"), get_tier("kim"),
               get_tier("bands"), get_tier("enhanced_pairwise")),
        compaction=Compaction(budget=5))
    res = nn_search(idx, ds.x_test, cfg, plan=plan)
    assert torch.equal(res.idx, base.idx)
    assert torch.equal(res.dists, base.dists)
