"""The slice's two kernels' plain versions (K7 sketch bound, K8 LB_Keogh),
the sketch store and the store mask of the port on the CPU, against the
JAX package.

Inputs come from numpy seeds and go through both packages.  The sketch
store (``sk_lo``, ``sk_hi``, ``sk_scale``) and the query segment means
are bit-equal to JAX's: both sum each segment left to right and multiply
by the f32 reciprocal of its length.  Sketch bounds agree to rtol 1e-5
(XLA may contract the weighted square into an FMA on the CPU, the port
keeps it unfused as its kernel does), LB_Keogh to rtol 1e-5 (another
summation order).  At search level, the ``live`` mask, the committed
plan, neighbour ids and per-query ``n_dtw`` are equal to JAX's.  The
JAX side runs its jnp references (``use_pallas=False``), except one
small interpret-mode check each of ``sketch_bound_pallas`` and
``lb_keogh_pallas``.
"""

import dataclasses
import json
import warnings
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import lower_bounds as j_lb
from repro.kernels import ref as j_ref
from repro.kernels.lb_keogh import lb_keogh_pallas
from repro.kernels.sketch import sketch_bound_pallas
from repro.search import CascadeConfig as JCascadeConfig
from repro.search import EngineConfig as JEngineConfig
from repro.search import build_index as j_build_index
from repro.search import nn_search as j_nn_search
from repro.search import planner as j_planner
from repro.search.guards import GuardConfig as JGuardConfig
from repro.search.index import sketch_features as j_sketch_features
from repro.search.index import sketch_query_means as j_sketch_query_means
from repro_torch.core import lower_bounds as lb
from repro_torch.kernels import ops, ref
from repro_torch.kernels.lb_keogh import lb_keogh_cuda
from repro_torch.kernels.sketch import sketch_bound_cuda
from repro_torch.search import (
    CascadeConfig,
    EngineConfig,
    brute_force,
    build_index,
    get_tier,
    index_from_numpy,
    nn_search,
    run_plan,
)
from repro_torch.search.index import (
    sketch_features,
    sketch_query_means,
    sketch_segment_sizes,
    sketch_segments,
)
from repro_torch.search.pipeline import default_plan
from repro_torch.search.planner import calibration_sample, plan_cache_clear

BENCH = json.loads((Path(__file__).resolve().parents[1]
                    / "BENCH_kernels.json").read_text())


def _walks(rng, n, L):
    return np.cumsum(rng.normal(size=(n, L)), axis=1).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _sketch_bound(index, q):
    s = index.sk_lo.shape[1]
    qbar = sketch_query_means(_t(q), s)
    seg = sketch_segment_sizes(index.length, s)
    return ref.sketch_bound_ref(qbar, index.sk_lo, index.sk_hi,
                                index.sk_scale, seg)


# ---------------------------------------------------------------------------
# the sketch store: admissible, outward, bit-equal to JAX's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("L", [64, 37, 8])          # even, ragged, S > L
@pytest.mark.parametrize("wsel", ["0", "1", "L/4", "L"])
def test_sketch_admissible_under_keogh_and_dtw(rng, L, wsel):
    w = {"0": 0, "1": 1, "L/4": L // 4, "L": L}[wsel]
    store = _walks(rng, 24, L)
    qs = _walks(rng, 5, L)
    index = build_index(store, w, device="cpu")
    sb = _sketch_bound(index, qs)
    keogh = lb.lb_keogh_matrix(_t(qs), index.upper, index.lower)
    assert (sb <= keogh * (1 + 1e-5) + 1e-5).all()
    d = ref.dtw_band_ref(_t(qs).repeat_interleave(index.n, 0),
                         index.series.repeat(qs.shape[0], 1),
                         w).reshape(qs.shape[0], index.n)
    assert (sb <= d * (1 + 1e-5) + 1e-5).all()


def test_sketch_segments_ragged_and_short():
    from repro.search.index import sketch_segments as j_segments

    for L, s in [(37, 16), (8, 16), (1, 16), (512, 16), (100, 7)]:
        assert sketch_segments(L, s) == j_segments(L, s)
    sizes = [b - a for a, b in sketch_segments(37, 16)]
    assert len(sizes) == 16 and sum(sizes) == 37 and set(sizes) <= {2, 3}
    assert len(sketch_segments(8, 16)) == 8
    assert torch.equal(sketch_segment_sizes(37, 16),
                       torch.tensor(sizes, dtype=torch.float32))


@pytest.mark.parametrize("N,L,s", [(24, 64, 16), (24, 37, 16), (24, 8, 16),
                                   (40, 256, 16), (16, 50, 7), (5, 1, 16)])
def test_sketch_features_bit_equal_to_jax(rng, N, L, s):
    store = _walks(rng, N, L)
    u, lo = ref.envelope_ref(_t(store), max(1, L // 8))
    got = sketch_features(u, lo, s)
    want = j_sketch_features(jnp.asarray(u.numpy()), jnp.asarray(lo.numpy()),
                             s)
    for g, j in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(j))
    assert got[0].dtype == torch.int8 and got[2].dtype == torch.float32
    np.testing.assert_array_equal(
        sketch_query_means(_t(store), s).numpy(),
        np.asarray(j_sketch_query_means(jnp.asarray(store), s)))


def test_sketch_outward_rounding_cellwise(rng):
    store = _walks(rng, 16, 50)
    index = build_index(store, 5, device="cpu")
    segs = sketch_segments(50, index.sk_lo.shape[1])
    useg = np.stack([index.upper.numpy()[:, a:b].mean(1) for a, b in segs],
                    1)
    lseg = np.stack([index.lower.numpy()[:, a:b].mean(1) for a, b in segs],
                    1)
    scale = float(index.sk_scale)
    assert np.all(index.sk_hi.numpy().astype(np.float32) * scale
                  >= useg - 1e-6)
    assert np.all(index.sk_lo.numpy().astype(np.float32) * scale
                  <= lseg + 1e-6)


def test_sketch_zero_variance_store_sanitized(rng):
    store = np.zeros((12, 32), np.float32)
    store[6:] = _walks(rng, 6, 32)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        index = build_index(store, 4, device="cpu", sanitize=True,
                            normalize=True)
    sb = _sketch_bound(index, index.series.numpy())
    assert torch.isfinite(sb).all() and (sb >= 0).all()
    assert float(index.sk_scale) > 0


def test_sketch_store_size_budget(rng):
    # 32 bytes per candidate at the default S = 16 (the
    # sketch_L256_w{26,77}_bytes_per_cand rows)
    index = build_index(_walks(rng, 40, 256), 26, device="cpu")
    per_cand = (index.sk_lo.numel() * index.sk_lo.element_size()
                + index.sk_hi.numel() * index.sk_hi.element_size()) / index.n
    assert per_cand == BENCH["sketch_L256_w26_bytes_per_cand"] == 32


# ---------------------------------------------------------------------------
# K7: the plain version against JAX's, the CPU route, the kernel's order
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("Q,N,L", [(4, 40, 64), (1, 200, 37), (9, 129, 96)])
def test_sketch_bound_ref_matches_jax(rng, Q, N, L):
    store = _walks(rng, N, L)
    qs = _walks(rng, Q, L)
    index = build_index(store, max(1, L // 8), device="cpu")
    s = index.sk_lo.shape[1]
    qbar = sketch_query_means(_t(qs), s)
    seg = sketch_segment_sizes(L, s)
    got = ref.sketch_bound_ref(qbar, index.sk_lo, index.sk_hi,
                               index.sk_scale, seg)
    want = j_ref.sketch_bound_ref(
        jnp.asarray(qbar.numpy()), jnp.asarray(index.sk_lo.numpy()),
        jnp.asarray(index.sk_hi.numpy()), jnp.asarray(index.sk_scale.numpy()),
        jnp.asarray(seg.numpy()))
    assert got.shape == (Q, N)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    # the CPU route of the op is the plain version, bit for bit
    assert torch.equal(ops.sketch_bound_op(qbar, index.sk_lo, index.sk_hi,
                                           index.sk_scale, seg), got)


def test_sketch_bound_fixed_segment_order(rng):
    # the kernel's order: acc + (wseg_j * d) * d for j = 0..S-1, each step
    # rounded to f32 (numpy float32 scalars, one pair at a time)
    qs = rng.normal(size=(3, 16)).astype(np.float32) * 40
    lo = rng.integers(-127, 100, size=(5, 16)).astype(np.int8)
    hi = np.minimum(lo.astype(np.int32) + rng.integers(0, 27, size=(5, 16)),
                    127).astype(np.int8)
    wseg = (rng.uniform(1, 40, size=16) * 0.01).astype(np.float32)
    got = ref.sketch_bound_scaled(_t(qs), _t(lo), _t(hi), _t(wseg)).numpy()
    for q in range(3):
        for n in range(5):
            acc = np.float32(0.0)
            for j in range(16):
                d = max(qs[q, j] - np.float32(hi[n, j]),
                        np.float32(lo[n, j]) - qs[q, j], np.float32(0.0))
                acc = np.float32(acc + np.float32(np.float32(wseg[j] * d) * d))
            assert got[q, n] == acc


def test_sketch_pallas_interpret_agrees_with_the_port(rng):
    index = build_index(_walks(rng, 130, 64), 8, device="cpu")
    qbar = sketch_query_means(_t(_walks(rng, 3, 64)), 16)
    qs, wseg = ref.sketch_operands(qbar, index.sk_scale,
                                   sketch_segment_sizes(64, 16))
    want = sketch_bound_pallas(jnp.asarray(qs.numpy()),
                               jnp.asarray(index.sk_lo.numpy()),
                               jnp.asarray(index.sk_hi.numpy()),
                               jnp.asarray(wseg.numpy()), interpret=True)
    got = ref.sketch_bound_scaled(qs, index.sk_lo, index.sk_hi, wseg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def test_kernel_wrappers_of_the_slice_refuse_cpu_tensors():
    x = torch.zeros(4, 16)
    i8 = torch.zeros(4, 16, dtype=torch.int8)
    with pytest.raises(ValueError, match="CUDA"):
        sketch_bound_cuda(x, i8, i8, torch.zeros(16))
    with pytest.raises(ValueError, match="CUDA"):
        lb_keogh_cuda(x, x, x)


# ---------------------------------------------------------------------------
# K8 and the core LB_Keogh family
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("Q,C,L,w", [(3, 37, 33, 8), (9, 70, 64, 1),
                                     (5, 33, 31, 0), (2, 600, 24, 24)])
def test_lb_keogh_ref_matches_jax(rng, Q, C, L, w):
    q = _walks(rng, Q, L)
    u, lo = ref.envelope_ref(_t(_walks(rng, C, L)), w)
    got = ref.lb_keogh_ref(_t(q), u, lo)
    want = j_ref.lb_keogh_ref(jnp.asarray(q), jnp.asarray(u.numpy()),
                              jnp.asarray(lo.numpy()))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    assert torch.equal(ops.lb_keogh_op(_t(q), u, lo), got)
    assert torch.equal(got, lb.lb_keogh_matrix(_t(q), u, lo))   # chunking


def test_lb_keogh_pallas_interpret_agrees_with_the_port(rng):
    q = _walks(rng, 5, 40)
    u, lo = ref.envelope_ref(_t(_walks(rng, 21, 40)), 4)
    want = lb_keogh_pallas(jnp.asarray(q), jnp.asarray(u.numpy()),
                           jnp.asarray(lo.numpy()), interpret=True)
    np.testing.assert_allclose(ref.lb_keogh_ref(_t(q), u, lo).numpy(),
                               np.asarray(want), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("L,w", [(17, 0), (17, 1), (32, 8), (17, 17)])
def test_get_bound_matches_jax(rng, L, w):
    a, b = _walks(rng, 2, L)
    for name in j_lb.BOUND_NAMES + ("lb_kim_paper", "lb_yi"):
        want = float(j_lb.get_bound(name, w)(jnp.asarray(a), jnp.asarray(b)))
        got = float(lb.get_bound(name, w)(_t(a), _t(b)))
        assert got == pytest.approx(want, rel=1e-5, abs=1e-6), name
    keogh = float(lb.lb_keogh(_t(a), _t(b), w))
    improved = float(lb.lb_improved(_t(a), _t(b), w))
    dtw = float(ref.dtw_band_ref(_t(a)[None], _t(b)[None], w)[0])
    assert keogh <= improved * (1 + 1e-6) + 1e-6
    assert improved <= dtw * (1 + 1e-5) + 1e-5
    with pytest.raises(ValueError, match="unknown"):
        lb.get_bound("lb_nonesuch", w)


# ---------------------------------------------------------------------------
# the sketch tier and the store mask inside the search, against JAX
# ---------------------------------------------------------------------------


def test_sketch_tier_zeros_without_features(rng):
    store = _walks(rng, 16, 32)
    index = build_index(store, 4, device="cpu", sketch=None)
    t = get_tier("sketch").fn(_t(store[:3]), index,
                              CascadeConfig(w=4, use_sketch=True))
    assert torch.equal(t, torch.zeros(3, 16))


def test_sketch_tier_first_in_default_plan():
    plan = default_plan(CascadeConfig(w=4, use_sketch=True))
    assert plan.tiers[0].name == "sketch" and plan.tiers[0].cost == "O(S)"
    assert default_plan(CascadeConfig(w=4)).tiers[0].name != "sketch"


def _decision():
    from repro_torch.search import planner

    return next(iter(planner._PLAN_CACHE.values()))[1]


def _j_decision():
    return next(iter(j_planner._PLAN_CACHE.values()))[1]


@pytest.mark.parametrize("wsel", ["L/4"])
def test_masked_search_matches_jax(rng, wsel):
    """``use_sketch`` + ``auto_plan`` + ``mask``: the live mask and the
    committed plan equal JAX's, and the leave-one-out calibration queries
    get JAX's neighbours and per-query n_dtw."""
    N, L, k = 96, 64, 3
    w = {"1": 1, "L/4": L // 4}[wsel]
    store = _walks(rng, N, L)
    cfg = EngineConfig(cascade=CascadeConfig(w=w, use_sketch=True), k=k,
                       auto_plan=True)
    jcfg = JEngineConfig(cascade=JCascadeConfig(w=w, use_sketch=True,
                                                use_pallas=False),
                         k=k, auto_plan=True,
                         guards=JGuardConfig(enabled=False))
    plan_cache_clear()
    j_planner.plan_cache_clear()
    index = build_index(store, w, device="cpu", calibrate=cfg, mask=True)
    jindex = j_build_index(store, w, calibrate=jcfg, mask=True)
    assert torch.equal(index.live, torch.from_numpy(np.array(jindex.live)))
    dec, jdec = _decision(), _j_decision()
    assert (dec.order, dec.dropped, dec.budget, dec.limit) == (
        jdec.order, jdec.dropped, jdec.budget, jdec.limit)
    pick = calibration_sample(N, 8)
    res = nn_search(index, store[pick], cfg, exclude=torch.from_numpy(pick))
    jres = j_nn_search(jindex, jnp.asarray(store[pick]), jcfg,
                       exclude=jnp.asarray(pick, jnp.int32))
    np.testing.assert_array_equal(res.idx.numpy(), np.asarray(jres.idx))
    np.testing.assert_array_equal(res.n_dtw.numpy(), np.asarray(jres.n_dtw))
    plan_cache_clear()
    j_planner.plan_cache_clear()


@pytest.mark.parametrize("wsel", ["0", "1", "L/4", "L"])
def test_masked_search_bit_equal_and_no_extra_dtw(rng, wsel):
    """Neighbours equal brute force for out-of-sample queries, and the
    calibration queries never pay more DTW than the sketchless default
    plan."""
    N, L, k = 96, 64, 3
    w = {"0": 0, "1": 1, "L/4": L // 4, "L": L}[wsel]
    store = _walks(rng, N, L)
    cfg = EngineConfig(cascade=CascadeConfig(w=w, use_sketch=True), k=k,
                       auto_plan=True)
    plan_cache_clear()
    index = build_index(store, w, device="cpu", calibrate=cfg, mask=True)
    assert index.live.any()
    qs = _walks(rng, 5, L)
    res = nn_search(index, qs, cfg)
    bd, bi = brute_force(index, qs, w, k=k)
    assert torch.equal(res.idx, bi) and torch.equal(res.dists, bd)
    pick = calibration_sample(N, 8)
    ex = torch.from_numpy(pick)
    res = nn_search(index, store[pick], cfg, exclude=ex)
    bd, bi = brute_force(index, store[pick], w, k=k, exclude=ex)
    assert torch.equal(res.idx, bi) and torch.equal(res.dists, bd)
    index0 = build_index(store, w, device="cpu", sketch=None)
    res0 = nn_search(index0, store[pick], EngineConfig(
        cascade=CascadeConfig(w=w), k=k), exclude=ex)
    assert (res.n_dtw <= res0.n_dtw).all()
    plan_cache_clear()


def test_mask_dense_skip_frac_matches_the_jax_count():
    """``benchmarks/kernel_bench.py``'s mask setup (N = 128 walks, L = 64,
    w = 12, k = 2, four planted outliers off the calibration stride):
    5 of 128 candidates die (``mask_dense_skip_frac`` 0.039), all four
    outliers among them, and the masked search stays exact."""
    rng2 = np.random.default_rng(5)
    walks = np.cumsum(rng2.normal(size=(128, 64)).astype(np.float32), axis=1)
    out_rows = np.array([5, 40, 70, 100])
    walks[out_rows] += 50.0
    cfg = EngineConfig(cascade=CascadeConfig(w=12, use_sketch=True), k=2)
    plan_cache_clear()
    index = build_index(walks, 12, device="cpu", calibrate=cfg, mask=True)
    dead = ~index.live
    assert int(dead.sum()) == 5
    assert round(5 / 128, 3) == BENCH["mask_dense_skip_frac"]
    assert dead[torch.from_numpy(out_rows)].all()
    pick = calibration_sample(128, 8)
    ex = torch.from_numpy(pick)
    res = nn_search(index, walks[pick], cfg, exclude=ex)
    bd, bi = brute_force(index, walks[pick], 12, k=2, exclude=ex)
    assert torch.equal(res.idx, bi) and torch.equal(res.dists, bd)
    plan_cache_clear()


def test_masked_search_skewed_store(rng):
    L, N, w, k = 64, 128, 12, 2
    store = rng.normal(size=(N, L)).astype(np.float32)
    pick = calibration_sample(N, 8)
    out_rows = np.array([5, 40, 70, 100])
    assert not np.intersect1d(out_rows, pick).size
    store[out_rows] += 50.0
    cfg = EngineConfig(cascade=CascadeConfig(w=w, use_sketch=True), k=k)
    plan_cache_clear()
    index = build_index(store, w, device="cpu", calibrate=cfg, mask=True)
    live = index.live.numpy()
    assert not live[out_rows].any() and live.mean() > 0.5
    ex = torch.from_numpy(pick)
    res = nn_search(index, store[pick], cfg, exclude=ex)
    bd, bi = brute_force(index, store[pick], w, k=k, exclude=ex)
    assert torch.equal(res.idx, bi) and torch.equal(res.dists, bd)
    index0 = build_index(store, w, device="cpu", sketch=None)
    res0 = nn_search(index0, store[pick], EngineConfig(
        cascade=CascadeConfig(w=w), k=k), exclude=ex)
    assert (res.n_dtw <= res0.n_dtw).all()
    plan_cache_clear()


def test_mask_keeps_cheap_bound_on_dead_candidates(rng):
    N, L, w, k = 64, 48, 6, 2
    store = _walks(rng, N, L)
    store[[5, 40]] += 80.0       # off the calibration stride: they die
    cfg = EngineConfig(cascade=CascadeConfig(w=w, use_sketch=True), k=k)
    plan_cache_clear()
    index = build_index(store, w, device="cpu", calibrate=cfg, mask=True)
    dead = ~index.live
    assert dead.any()
    cres = run_plan(_t(_walks(rng, 3, L)), index, cfg.cascade, k=k)
    assert torch.isfinite(cres.lb[:, dead]).all()
    plan_cache_clear()


def test_index_from_numpy_carries_the_sketch_and_the_mask(rng):
    store = _walks(rng, 40, 32)
    jidx = dataclasses.replace(j_build_index(store, 4),
                               live=jnp.asarray(np.arange(40) % 3 > 0))
    fields = ("series", "labels", "upper", "lower", "kim", "kim_ok",
              "sk_lo", "sk_hi", "sk_scale", "live")
    moved = index_from_numpy({f: np.asarray(getattr(jidx, f))
                              for f in fields}, 4, device="cpu")
    for f in fields:
        np.testing.assert_array_equal(getattr(moved, f).numpy(),
                                      np.asarray(getattr(jidx, f)))
    assert moved.sk_lo.dtype == torch.int8 and moved.live.dtype == torch.bool
    own = build_index(store, 4, device="cpu")
    for f in ("sk_lo", "sk_hi", "sk_scale"):
        assert torch.equal(getattr(own, f), getattr(moved, f))


def test_lb_improved_tier_admissible_and_pluggable(rng):
    from repro.search.pipeline import get_tier as j_get_tier

    N, L, w, k = 48, 40, 5, 2
    store = _walks(rng, N, L)
    qs = _walks(rng, 4, L)
    index = build_index(store, w, device="cpu")
    cfg = CascadeConfig(w=w)
    tier = get_tier("lb_improved")
    assert tier.scope == "pairwise" and tier.cost == "O(L)"
    P = 16
    qrows = _t(qs[:1]).repeat(P, 1)
    args = (qrows, index.series[:P], index.upper[:P], index.lower[:P])
    out = tier.fn(*args, cfg)
    want = j_get_tier("lb_improved").fn(
        *(jnp.asarray(a.numpy()) for a in args),
        JCascadeConfig(w=w, use_pallas=False))
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    d = ref.dtw_band_ref(qrows, index.series[:P], w)
    assert (out <= d * (1 + 1e-5) + 1e-5).all()
    assert (out >= lb.lb_keogh_env(qrows, index.upper[:P],
                                   index.lower[:P]) - 1e-5).all()
    live = torch.arange(P) % 2 == 0
    masked = tier.fn(*args, cfg, live=live)
    assert torch.isneginf(masked[1::2]).all()
    assert torch.equal(masked[::2], out[::2])
    base = default_plan(cfg)
    plan = dataclasses.replace(base, tiers=tuple(
        t if t.scope != "pairwise" else tier for t in base.tiers))
    res = nn_search(index, qs, EngineConfig(cascade=cfg, k=k), plan=plan)
    bd, bi = brute_force(index, qs, w, k=k)
    assert torch.equal(res.idx, bi) and torch.equal(res.dists, bd)
