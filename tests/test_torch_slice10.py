"""K4's slots form (csrc/dtw_band.cu, ``dtw_band_slots_kernel``): its
on-card schedule emulated step by step on the CPU and held bit-equal to
the plain version (``ref.dtw_band_ref``), its choice by ``k4_form`` and
``k4_slots``, and the port's search at the paper's large windows (w = L
and w = 0.6 L) against the JAX engine.  No card is needed;
``tests/test_torch_gpu.py`` runs the kernel itself.

The slots form spreads the warp form's schedule (``tests/
test_torch_redesign.py``) over G warps a pair: lane ``lam = 32 w + l``
owns band slots ``[lam M, lam M + M)``; inside a warp the neighbour slot
comes by shuffle; across warps lane 0 publishes its slot 0 after each
even step and lane 31 its slot M - 1 after each odd step, and the next
step reads them (shared memory, one barrier a step).  Each lane keeps
windows of a and b in registers, moved by one each step pair with one
guarded load each.  A check takes the warp minima of the lanes' frontier
values and then their minimum over the G warps; K4 checks at the
``row_block_policy`` boundaries, K6 every step, poisoning before the step
publishes its edges.

The JAX side runs ``use_pallas=False``; DTW values agree to rtol 1e-5
(XLA contracts the cell update into an FMA on the CPU, the port does
not), ids and per-query ``n_dtw`` exactly.
"""

import numpy as np
import pytest
import torch

from repro.data import make_dataset as j_make_dataset
from repro.search import CascadeConfig as JCascadeConfig
from repro.search import EngineConfig as JEngineConfig
from repro.search import build_index as j_build_index
from repro.search import nn_search as j_nn_search
from repro.search.guards import GuardConfig
from repro_torch.core.dtw import _band_width, row_block_policy
from repro_torch.data import make_dataset
from repro_torch.kernels import ref
from repro_torch.kernels.dtw_band import (
    K4_FORMS,
    K4_SLOTS_ONE_WARP,
    K4_WARP_MAX_WB,
    dtw_band_route,
    k4_form,
    k4_slots,
    slots_warps,
)
from repro_torch.search import (
    CascadeConfig,
    EngineConfig,
    build_index,
    nn_search,
)

INF = np.float32(np.inf)


def _k4_slots(a, b, w, cutoff, m, row_block=None, per_step=False):
    """K4's (``per_step``: K6's) slots form with ``m`` slots a lane on
    (P, L) pairs, vectorised over pairs, lanes and a step's cells;
    returns (P,) float32."""
    P, L = a.shape
    wb = _band_width(L, w)
    G = slots_warps(wb, m)
    NL, H = 32 * G, m // 2
    D, last = 2 * L - 1, 2 * L - 2
    R = row_block if row_block is not None else row_block_policy(L)
    R = max(1, min(R, D))
    cut = np.broadcast_to(np.asarray(cutoff, np.float32), (P,)).copy()
    lam = np.arange(NL)
    base = lam * m
    lim = 2 * wb - base
    s = np.full((P, NL, m), INF, np.float32)
    s[:, wb // m, wb % m] = 0                 # the path's origin, S_{-2}
    el = s[:, ::32, 0].copy()                 # lane 0's slot 0, per warp
    er = s[:, 31::32, m - 1].copy()           # lane 31's slot M - 1
    f = np.full((2, P, NL), INF, np.float32)
    alive = np.ones(P, bool) if per_step else cut != -np.inf
    check_at = min(R - 1, D - 1)
    d0 = -(wb & 1)
    i0 = (d0 + base - wb) >> 1
    j0 = (d0 - base + wb) >> 1

    def load(x, idx):                         # load_or_zero
        ok = (idx >= 0) & (idx < L)
        return np.where(ok, x[:, np.clip(idx, 0, L - 1)], np.float32(0))

    tt = np.arange(H)
    av = load(a, i0[:, None] + np.arange(H + 1)).reshape(P, NL, H + 1)
    bv = load(b, j0[:, None] - tt).reshape(P, NL, H)
    inner = (lam % 32) != 0, (lam % 32) != 31
    warp = lam // 32

    def step(par, d):
        if par == 0:                          # shuffle up, or er[w - 1]
            nb = np.concatenate([np.full((P, 1), INF, np.float32),
                                 s[:, :-1, m - 1]], axis=1)
            cross = np.where(warp > 0, er[:, np.maximum(warp - 1, 0)], INF)
            nb = np.where(inner[0], nb, cross)
        else:                                 # shuffle down, or el[w + 1]
            nb = np.concatenate([s[:, 1:, 0],
                                 np.full((P, 1), INF, np.float32)], axis=1)
            cross = np.where(warp < G - 1,
                             el[:, np.minimum(warp + 1, G - 1)], INF)
            nb = np.where(inner[1], nb, cross)
        edge = d < wb or d >= last - wb
        lo = np.zeros(NL, int)
        hi = lim
        if edge:
            lo = max(0, wb - d, d + wb - last) - base
            hi = np.minimum(lim, min(d + wb, last - d + wb) - base)
        ms = par + 2 * tt
        ext = np.concatenate([nb[..., None], s, nb[..., None]], axis=2)
        best = np.minimum(np.minimum(ext[..., ms], ext[..., ms + 2]),
                          s[..., ms])
        diff = av[..., par + tt] - bv
        nd = (diff * diff + best).astype(np.float32)
        ok = (ms[None, :] >= lo[:, None]) & (ms[None, :] <= hi[:, None])
        s[..., ms] = np.where(ok, nd, s[..., ms])
        if edge:
            f[par] = np.where(ok, nd, INF).min(axis=2)

    def after(e, par):
        nonlocal check_at, el, er
        dead = np.zeros(P, bool)
        if per_step or e == check_at:
            if not per_step:
                check_at = min(check_at + R, D - 1)
            v = np.minimum(f[0], f[1])
            if wb <= e <= last - wb:
                v = s.min(axis=2)
            v = v.reshape(P, G, 32).min(axis=2).min(axis=1)
            dead = v > cut
            if per_step:
                s[dead] = INF
                f[:, dead] = INF
                dead[:] = False
        if par == 0:
            el = s[:, ::32, 0].copy()
        else:
            er = s[:, 31::32, m - 1].copy()
        return dead

    for d in range(d0, D, 2):
        na = load(a, i0 + 1 + H)
        nbv = load(b, j0 + 1)
        for par, e in ((0, d), (1, d + 1)):
            if 0 <= e < D:
                step(par, e)
                alive &= ~after(e, par)
        i0, j0 = i0 + 1, j0 + 1
        av = np.concatenate([av[..., 1:], na[..., None]], axis=2)
        bv = np.concatenate([nbv[..., None], bv[..., :-1]], axis=2)
    return np.where(alive, s[:, wb // m, wb % m], INF)


def _pairs(seed, P, L):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(P, L)).astype(np.float32),
            rng.normal(size=(P, L)).astype(np.float32))


# (P, L, w, m): wb in {256, 300, 511, 1023, 1599} at w = L and inside a
# longer series, at k4_slots's m (one warp a pair of 22-32 slots a lane up
# to wb = 511, then 32 slots a lane in 2 and 4 warps) and at another m
# that takes the band in one warp
SLOTS_CASES = [
    (4, 257, 257, None), (3, 600, 256, 32), (3, 301, 301, 24),
    (3, 700, 300, None), (2, 512, 512, None), (2, 900, 511, None),
    (2, 1024, 1024, None), (2, 1300, 1023, None), (1, 1600, 1600, None),
]


@pytest.mark.parametrize("P,L,w,m", SLOTS_CASES)
def test_k4_slots_schedule_bit_equal_to_the_plain_version(P, L, w, m):
    a, b = _pairs(P * 1000 + L + (m or 0), P, L)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    m = m or k4_slots(L, w)
    assert k4_form(L, w) == "slots"
    exact = ref.dtw_band_ref(ta, tb, w)
    np.testing.assert_array_equal(_k4_slots(a, b, w, np.inf, m),
                                  exact.numpy())
    # cutoffs that kill some pairs, an invalid (-inf) slot, row blocks of 7
    rng = np.random.default_rng(L)
    cut = (exact.numpy() * (0.8 + 0.4 * rng.random(P))).astype(np.float32)
    cut[0] = -np.inf
    for rb in (None, 7):
        want = ref.dtw_band_ref(ta, tb, w, torch.from_numpy(cut),
                                row_block=rb)
        got = _k4_slots(a, b, w, cut, m, rb)
        np.testing.assert_array_equal(got, want.numpy())
        assert np.isposinf(got[0])
    # K6: a check and poisoning every step
    np.testing.assert_array_equal(
        _k4_slots(a, b, w, cut, m, per_step=True),
        ref.dtw_band_ref(ta, tb, w, torch.from_numpy(cut),
                         row_block=1).numpy())


def test_k4_slots_schedule_abandons_mid_sweep():
    """Cutoffs at 0.6 of each pair's DTW: every pair dies at some row
    block of 16, in K4 and K6, at two geometries."""
    P, L, w = 3, 400, 300
    a, b = _pairs(5, P, L)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    exact = ref.dtw_band_ref(ta, tb, w).numpy()
    cut = (exact * np.float32(0.6)).astype(np.float32)
    want = ref.dtw_band_ref(ta, tb, w, torch.from_numpy(cut), row_block=16)
    assert np.isposinf(want.numpy()).all()
    for m in (k4_slots(L, w), 32):
        np.testing.assert_array_equal(
            _k4_slots(a, b, w, cut, m, row_block=16), want.numpy())
        np.testing.assert_array_equal(
            _k4_slots(a, b, w, cut, m, per_step=True), want.numpy())


@pytest.mark.parametrize("wb,form", [
    (0, "warp"), (K4_WARP_MAX_WB, "warp"), (K4_WARP_MAX_WB + 1, "slots"),
    (511, "slots"), (4095, "slots"), (14463, "slots")])
def test_k4_form_picks_the_slots_form_past_the_warp_form(wb, form):
    """``k4_form`` takes the slots form exactly for 255 < wb <= 14463
    (wb = 255 | 256 and 14463 | 14464 are its edges, past which
    ``dtw_band_route`` sends the band to K5, unchanged); the block form
    is never picked."""
    assert K4_FORMS == ("warp", "slots", "block")
    for L in (wb + 1, 2 * wb + 7):
        assert k4_form(L, wb) == form
        assert dtw_band_route(L, wb) == "resident"
    assert dtw_band_route(14464, 14464) == "resident"
    assert dtw_band_route(14465, 14465) == "stream"
    assert dtw_band_route(20000, 14464) == "stream"


@pytest.mark.parametrize("wb,m,warps", [
    (0, 22, 1), (51, 22, 1), (255, 22, 1),
    (256, 22, 1), (300, 22, 1), (351, 22, 1), (352, 24, 1), (511, 32, 1),
    (512, 32, 2), (1023, 32, 2), (3596, 32, 8), (8191, 32, 16),
    (8192, 32, 17), (14463, 32, 29)])
def test_k4_slots_geometry(wb, m, warps):
    """``k4_slots``: one warp a pair with the fewest even slots (at least
    22, also where the form runs only when forced, wb <= 255) up to
    wb = 511, then 32 slots a lane (16 warps, one block, at wb = 8191; a
    cluster of two blocks past that, 29 warps at wb = 14463): the
    geometries csrc/dtw_band.cu's slots_launch takes."""
    assert k4_slots(wb + 1, wb) == m and slots_warps(wb, m) == warps
    assert m in K4_SLOTS_ONE_WARP


# (P, L, w): the slots form forced at the warp form's bands (one warp of
# 22 slots a lane), from wb = 0 to 255
WARP_M_CASES = [(5, 33, 0), (5, 40, 31), (4, 100, 51), (3, 300, 127),
                (3, 256, 255)]


@pytest.mark.parametrize("P,L,w", WARP_M_CASES)
def test_k4_slots_schedule_at_the_warp_forms_m(P, L, w):
    """Where ``k4_form`` picks the warp form (wb <= 255) the slots form
    runs only when forced, in one warp: its schedule is bit-equal
    to the plain version there too, with cutoffs, row blocks of 7 and
    K6's per-step rule."""
    a, b = _pairs(7 * L + w, P, L)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    m = k4_slots(L, w)
    assert k4_form(L, w) == "warp" and slots_warps(_band_width(L, w), m) == 1
    exact = ref.dtw_band_ref(ta, tb, w)
    np.testing.assert_array_equal(_k4_slots(a, b, w, np.inf, m),
                                  exact.numpy())
    rng = np.random.default_rng(w)
    cut = (exact.numpy() * (0.6 + 0.6 * rng.random(P))).astype(np.float32)
    cut[-1] = -np.inf
    tcut = torch.from_numpy(cut)
    for rb in (None, 7):
        np.testing.assert_array_equal(
            _k4_slots(a, b, w, cut, m, rb),
            ref.dtw_band_ref(ta, tb, w, tcut, row_block=rb).numpy())
    np.testing.assert_array_equal(
        _k4_slots(a, b, w, cut, m, per_step=True),
        ref.dtw_band_ref(ta, tb, w, tcut, row_block=1).numpy())


@pytest.mark.parametrize("frac", [1.0, 0.6])
def test_nn_search_at_the_papers_large_windows_matches_jax(frac):
    """w = L and w = 0.6 L (Table III's widest windows) on a small store
    (L = 448, N = 96, Q = 8; wb = 447 and 268, both the slots form's on
    the card): ids and per-query n_dtw equal the JAX engine's, distances
    to rtol 1e-5.  Rounds of Q x 4 pairs keep each band step's tensors
    under torch's intra-op grain (32768 elements), so the plain DTW runs
    on one thread: the suite's parallel workers share the cores."""
    data = dict(n_classes=4, n_train_per_class=24, n_test_per_class=2,
                length=448, seed=3)
    ds = make_dataset(**data)
    jds = j_make_dataset(**data)
    np.testing.assert_array_equal(ds.x_train, jds.x_train)
    L = ds.length
    w = int(frac * L)
    assert k4_form(L, w) == "slots"
    cfg = EngineConfig(cascade=CascadeConfig(w=w, v=4), verify_chunk=4, k=1)
    res = nn_search(build_index(ds.x_train, w, ds.y_train, device="cpu"),
                    ds.x_test, cfg)
    jcfg = JEngineConfig(cascade=JCascadeConfig(w=w, v=4, use_pallas=False),
                         verify_chunk=4, k=1,
                         guards=GuardConfig(enabled=False))
    jres = j_nn_search(j_build_index(ds.x_train, w, ds.y_train, sketch=None),
                       ds.x_test, jcfg)
    np.testing.assert_array_equal(res.idx.numpy(), np.asarray(jres.idx))
    np.testing.assert_array_equal(res.n_dtw.numpy(), np.asarray(jres.n_dtw))
    np.testing.assert_allclose(res.dists.numpy(), np.asarray(jres.dists),
                               rtol=1e-5)
    assert 0 < int(res.n_dtw.min())
