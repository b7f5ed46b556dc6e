"""Long series under wide windows: the port's banded DTW (the plain
versions of K4, K5 and K6), its envelopes and its search at w = L, on the
CPU, against the JAX package's jnp functions (``repro.kernels.ref``,
``repro.core.dtw``, ``repro.kernels.ops.envelope_op``), never its
streaming kernel.

The same numpy inputs go to both packages.  Tolerance: DTW values agree
to rtol 1e-5 with identical +inf positions (XLA on the CPU contracts the
cell update into an FMA; the port keeps it unfused, as its kernels do);
the port's own routes (early exit on or off, any row block) are equal to
each other exactly; envelopes are exact.  On the card,
``tests/test_torch_gpu.py`` holds K5 and K6 bit-equal to these plain
versions.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import make_dataset as j_make_dataset
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.search import CascadeConfig as JCascadeConfig
from repro.search import EngineConfig as JEngineConfig
from repro.search import build_index as j_build_index
from repro.search import nn_search as j_nn_search
from repro.search.guards import GuardConfig
from repro_torch.data import make_dataset
from repro_torch.kernels import ops, ref
from repro_torch.kernels.dtw_band import (
    dtw_band_route,
    k5_cluster_size,
    k5_form,
)
from repro_torch.search import (
    CascadeConfig,
    EngineConfig,
    build_index,
    nn_search,
)

# the modules (repro.core and repro_torch.core export the function ``dtw``
# under the same name)
jdtw = importlib.import_module("repro.core.dtw")
dtw = importlib.import_module("repro_torch.core.dtw")

RTOL = 1e-5
# test_cutoff.py's sweep: (P, L, w, row_block)
EARLY_EXIT_SWEEP = [
    (9, 33, 8, 8), (130, 47, 11, 16), (5, 64, 16, 64), (12, 21, 5, 7),
    (8, 40, 10, 200),
]


def _pair(seed, P, L):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(P, L)).astype(np.float32),
            rng.normal(size=(P, L)).astype(np.float32))


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_array_equal(np.isposinf(got), np.isposinf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=RTOL)


def _mixed_cutoff(plain):
    """Even pairs abandon (half their DTW), odd pairs finish exactly."""
    P = plain.shape[0]
    return np.where(np.arange(P) % 2 == 0, plain * 0.5,
                    plain * 2.0 + 1.0).astype(np.float32)


@pytest.mark.parametrize("P,L", [(13, 129), (8, 96), (1, 40)])
@pytest.mark.parametrize("wsel", ["0", "1", "L/4", "L"])
@pytest.mark.parametrize("with_cutoff", [False, True])
def test_dtw_band_matches_jax_sweep(P, L, wsel, with_cutoff):
    """test_streaming.py's forced-streaming sweep: the port's DTW (the
    plain version K5 and K4 share) against JAX ``ref.dtw_band_ref`` and
    ``core.dtw.dtw_band_blocked``; the per-step route (K6's plain
    version) equal to it exactly."""
    w = {"0": 0, "1": 1, "L/4": L // 4, "L": L}[wsel]
    a, b = _pair(P * L + w, P, L)
    cut = None
    if with_cutoff:
        cut = _mixed_cutoff(np.asarray(jref.dtw_band_ref(jnp.asarray(a),
                                                         jnp.asarray(b), w)))
    jcut = None if cut is None else jnp.asarray(cut)
    tcut = None if cut is None else _t(cut)
    got = ops.dtw_band_op(_t(a), _t(b), w, tcut).numpy()
    want = np.asarray(jref.dtw_band_ref(jnp.asarray(a), jnp.asarray(b), w,
                                        jcut))
    _close(got, want)
    _close(got, np.asarray(jdtw.dtw_band_blocked(jnp.asarray(a),
                                                 jnp.asarray(b), w, jcut)))
    step = ops.dtw_band_op(_t(a), _t(b), w, tcut, early_exit=False)
    np.testing.assert_array_equal(step.numpy(), got)
    if with_cutoff:
        assert np.isposinf(got[0::2]).all() and np.isfinite(got[1::2]).all()


def test_lone_survivor_and_all_dead():
    """One live pair among abandoned ones keeps its exact value; a batch
    whose pairs all abandon returns +inf everywhere."""
    a, b = _pair(1, 16, 64)
    plain = np.asarray(jref.dtw_band_ref(jnp.asarray(a), jnp.asarray(b), 8))
    cut = (plain * 1e-3).astype(np.float32)
    cut[7] = np.inf
    got = ops.dtw_band_op(_t(a), _t(b), 8, _t(cut)).numpy()
    _close(got, np.asarray(jref.dtw_band_ref(
        jnp.asarray(a), jnp.asarray(b), 8, jnp.asarray(cut), row_block=8)))
    np.testing.assert_allclose(got[7], plain[7], rtol=RTOL)
    assert np.isposinf(np.delete(got, 7)).all()

    a, b = _pair(2, 8, 64)
    plain = np.asarray(jref.dtw_band_ref(jnp.asarray(a), jnp.asarray(b), 16))
    cut = (plain * 1e-3).astype(np.float32)
    got = ref.dtw_band_ref(_t(a), _t(b), 16, _t(cut), row_block=16).numpy()
    assert np.isposinf(got).all()
    _close(got, np.asarray(jref.dtw_band_ref(
        jnp.asarray(a), jnp.asarray(b), 16, jnp.asarray(cut), row_block=16)))


def test_row_block_is_result_invariant():
    a, b = _pair(3, 9, 80)
    plain = np.asarray(jdtw.dtw_band_blocked(jnp.asarray(a), jnp.asarray(b),
                                             12))
    cut = _t((plain * np.linspace(0.3, 3.0, 9)).astype(np.float32))
    outs = [ref.dtw_band_ref(_t(a), _t(b), 12, cut, row_block=rb).numpy()
            for rb in (1, 8, 32, None)]
    for o in outs[1:]:
        np.testing.assert_array_equal(o, outs[0])
    _close(outs[0], np.asarray(jdtw.dtw_band_blocked(
        jnp.asarray(a), jnp.asarray(b), 12, jnp.asarray(cut.numpy()))))


@pytest.mark.parametrize("L", [16384, 16392, 32768, 65536])
def test_dtw_band_op_at_long_lengths(L):
    """The lengths around JAX's old resident ceiling and L = 65536, at
    w = 1: uncut values and, in the same call, cutoffs under which pair 0
    finishes exactly and pair 1 abandons."""
    a, b = _pair(L, 2, L)
    want = np.asarray(jdtw.dtw_band_blocked(jnp.asarray(a), jnp.asarray(b),
                                            1))
    cut = np.array([np.inf, np.inf, want[0] * 2 + 1, want[1] * 0.5],
                   np.float32)
    got = ops.dtw_band_op(_t(np.concatenate([a, a])),
                          _t(np.concatenate([b, b])), 1, _t(cut)).numpy()
    _close(got[:2], want)
    want_c = np.asarray(jdtw.dtw_band_blocked(jnp.asarray(a), jnp.asarray(b),
                                              1, jnp.asarray(cut[2:])))
    _close(got[2:], want_c)
    assert np.isfinite(got[2]) and np.isposinf(got[3])


@pytest.mark.parametrize("P,L,w,R", EARLY_EXIT_SWEEP)
def test_early_exit_off_matches_jax_scalar_dtw(P, L, w, R):
    """``dtw_band_op(early_exit=False)`` (K6's plain version) against the
    JAX per-step scalar ``core.dtw.dtw``, vmapped over pairs with their
    cutoffs, and equal to ``early_exit=True`` and to any row block."""
    a, b = _pair(P + L, P, L)
    plain = np.asarray(jref.dtw_band_ref(jnp.asarray(a), jnp.asarray(b), w))
    cut = _mixed_cutoff(plain)
    got = ops.dtw_band_op(_t(a), _t(b), w, _t(cut), early_exit=False)
    want = jax.vmap(lambda x, y, c: jdtw.dtw(x, y, w, c))(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(cut))
    _close(got.numpy(), np.asarray(want))
    assert torch.equal(got, ops.dtw_band_op(_t(a), _t(b), w, _t(cut)))
    assert torch.equal(got, ref.dtw_band_ref(_t(a), _t(b), w, _t(cut),
                                             row_block=R))


@pytest.mark.parametrize("L", [65536, 65537])
def test_envelope_op_long_series_matches_jax(L):
    x = np.random.default_rng(L).normal(size=(2, L)).astype(np.float32)
    for w in (655, L):
        u, lo = ops.envelope_op(_t(x), w)
        ju, jl = jops.envelope_op(jnp.asarray(x), w)
        np.testing.assert_array_equal(u.numpy(), np.asarray(ju))
        np.testing.assert_array_equal(lo.numpy(), np.asarray(jl))


def test_dtw_module_functions_match_jax():
    """The rest of ``core/dtw.py`` against ``repro.core.dtw``:
    ``dtw_band_death_blocks``, ``tile_skip_rate``, ``dtw_batch``,
    ``dtw_pairs``, ``cost_matrix`` and ``dtw_envelope_bound_gap``."""
    L, w, R = 33, 8, 8
    a, b = _pair(5, 12, L)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    plain = np.asarray(jdtw.dtw_band_blocked(ja, jb, w))
    cut = (plain * np.linspace(0.2, 2.0, 12)).astype(np.float32)
    death = dtw.dtw_band_death_blocks(_t(a), _t(b), w, _t(cut), row_block=R)
    jdeath = jdtw.dtw_band_death_blocks(ja, jb, w, jnp.asarray(cut),
                                        row_block=R)
    np.testing.assert_array_equal(death.numpy(), np.asarray(jdeath))
    assert death.dtype == torch.int32
    assert 0 < int((death < death.max()).sum()) < 12     # some die early
    n_blocks = -(-(2 * L - 1) // R)
    for tile_p in (1, 4, 5):
        assert dtw.tile_skip_rate(death, n_blocks, tile_p) == \
            jdtw.tile_skip_rate(np.asarray(jdeath), n_blocks, tile_p)

    _close(dtw.dtw_batch(_t(a).reshape(3, 4, L), _t(b).reshape(3, 4, L),
                         w).numpy(),
           np.asarray(jdtw.dtw_batch(ja.reshape(3, 4, L), jb.reshape(3, 4, L),
                                     w)))
    _close(dtw.dtw_pairs(_t(a[:3]), _t(b[:5]), w).numpy(),
           np.asarray(jdtw.dtw_pairs(ja[:3], jb[:5], w)))
    for wc in (3, None):
        cm = dtw.cost_matrix(_t(a[0]), _t(b[0]), wc).numpy()
        _close(cm, np.asarray(jdtw.cost_matrix(ja[0], jb[0], wc)))
        _close(cm[-1, -1], float(dtw.dtw(_t(a[0]), _t(b[0]), wc)))
    lb = np.float32(plain[0] * 0.25)
    _close(dtw.dtw_envelope_bound_gap(_t(a[0]), _t(b[0]), torch.tensor(lb),
                                      w).numpy(),
           np.asarray(jdtw.dtw_envelope_bound_gap(ja[0], jb[0], lb, w)))
    same = dtw.dtw_envelope_bound_gap(_t(a[0]), _t(a[0]), torch.tensor(0.0), w)
    assert float(same) == 1.0


@pytest.mark.parametrize("L,w,route", [
    (512, 51, "resident"), (17984, 17984, "stream"),
    (14464, 14464, "resident"), (14465, 14465, "stream"),   # wb 14463/14464
    (20000, 14463, "resident"), (20000, 14464, "stream"),
    (65536, None, "stream"), (16, 0, "resident")])
def test_dtw_band_route(L, w, route):
    assert dtw_band_route(L, w) == route


def test_nn_search_full_window_long_series_matches_jax():
    """w = L on a store of longer series (L = 1024, N = 32, Q = 2):
    neighbour ids and per-query n_dtw equal JAX's, distances to rtol."""
    data = dict(n_classes=2, n_train_per_class=16, n_test_per_class=1,
                length=1024, seed=7)
    ds = make_dataset(**data)
    jds = j_make_dataset(**data)
    np.testing.assert_array_equal(ds.x_train, jds.x_train)
    L = ds.length
    cfg = EngineConfig(cascade=CascadeConfig(w=L, v=4), verify_chunk=4, k=1)
    res = nn_search(build_index(ds.x_train, L, ds.y_train, device="cpu"),
                    ds.x_test, cfg)
    jcfg = JEngineConfig(cascade=JCascadeConfig(w=L, v=4, use_pallas=False),
                         verify_chunk=4, k=1,
                         guards=GuardConfig(enabled=False))
    jres = j_nn_search(j_build_index(ds.x_train, L, ds.y_train, sketch=None),
                       ds.x_test, jcfg)
    np.testing.assert_array_equal(res.idx.numpy(), np.asarray(jres.idx))
    np.testing.assert_array_equal(res.n_dtw.numpy(), np.asarray(jres.n_dtw))
    _close(res.dists.numpy(), np.asarray(jres.dists))
    assert 0 < int(res.n_dtw.min())


# ---- K5's on-chip forms (csrc/dtw_band_stream.cu), emulated -------------
# Only a card runs K5's forms (a) "rows" and (b) "cluster"; on the CPU,
# _k5_rows and _k5_slices repeat their designs in float32 numpy, so
# the arguments that make the kernels bit-equal to the plain version are
# held here; tests/test_torch_gpu.py holds the kernels.
#
# Form (a): thread g owns rows g K .. g K + K - 1 and computes column
# j = tau - g K of them at step tau, top to bottom, so every thread works
# on anti-diagonals tau .. tau + K - 1; its first row takes D(r - 1, j)
# from thread g - 1's last row K steps before (a delay line) and
# D(r - 1, j - 1) from the step before that, and a virtual D(-1, -1) = 0
# starts the path.  Boundary b (anti-diagonal d_b) gathers the minimum of
# its cells as they are computed and is decided after the step when its
# last cell is done, at most d_b.


def _boundaries(L, R):
    D = 2 * L - 1
    return [min((b + 1) * R - 1, D - 1) for b in range(-(-D // R))]


def _done_step(d, L, wb, K):
    """The step after which every cell of anti-diagonal d is done: cell
    (r, d - r) is computed at step d - r % K."""
    rmin = max(0, d - (L - 1), (d - wb + 1) // 2)
    rmax = min(L - 1, d, (d + wb) // 2)
    if d < 0 or rmin > rmax:
        return -1
    return d if -(-rmin // K) * K <= rmax else d - rmin % K


def _k5_rows(a, b, w, cutoff, row_block, T, K):
    P, L = a.shape
    wb = dtw._band_width(L, w)
    R = max(1, min(row_block, 2 * L - 1))
    bounds = _boundaries(L, R)
    bidx = {d: i for i, d in enumerate(bounds)}
    tau_b = [max(_done_step(d - 1, L, wb, K), _done_step(d, L, wb, K))
             for d in bounds]
    cut = np.broadcast_to(np.asarray(cutoff, np.float32), (P,))
    inf = np.float32(np.inf)
    g = np.arange(T)
    rows = g[:, None] * K + np.arange(K)[None, :]
    av = a[:, np.minimum(rows, L - 1)]
    left = np.full((P, T, K), inf, np.float32)
    diag_in = np.full((P, T), inf, np.float32)
    diag_in[:, 0] = 0                       # the virtual D(-1, -1)
    n_steps = (L - 1) + (L - 1) // K * K + 1
    lasts = np.full((n_steps, P, T), inf, np.float32)
    fm = np.full((P, len(bounds)), inf, np.float32)
    dead = cut == -np.inf
    decided = np.full((P, len(bounds)), np.nan, np.float32)
    val = np.full(P, inf, np.float32)
    for tau in range(n_steps):
        j = tau - g * K
        bj = b[:, np.clip(j, 0, L - 1)]
        up_in = np.full((P, T), inf, np.float32)
        if tau >= K:
            up_in[:, 1:] = lasts[tau - K][:, :-1]
        up, diag = up_in, diag_in
        for k in range(K):
            r = g * K + k
            valid = (j >= 0) & (j < L) & (r < L) & (np.abs(r - j) <= wb)
            diff = av[:, :, k] - bj
            best = np.minimum(np.minimum(left[:, :, k], diag), up)
            nd = np.where(valid, diff * diff + best, inf).astype(np.float32)
            for t in np.nonzero(valid)[0]:
                for dd in (r[t] + j[t], r[t] + j[t] + 1):
                    if dd in bidx:
                        fm[:, bidx[dd]] = np.minimum(fm[:, bidx[dd]],
                                                     nd[:, t])
                if r[t] == L - 1 and j[t] == L - 1:
                    val = nd[:, t].copy()
            diag = left[:, :, k].copy()
            left[:, :, k] = nd
            up = nd
        lasts[tau] = up
        diag_in = up_in
        for i, tb in enumerate(tau_b):
            if tb == tau:
                dead = dead | (fm[:, i] > cut)
                decided[:, i] = fm[:, i]
    # no cell of a boundary came after its decision, and each boundary's
    # cells lie within K + 1 anti-diagonals of the step that decides it
    np.testing.assert_array_equal(decided, fm)
    assert all(d - K <= tb <= d for d, tb in zip(bounds, tau_b))
    return np.where(dead, inf, val)


# Form (b): one buffer per pair holding S_{d-1} and S_{d-2} interleaved by
# slot parity, cut into n slices with the two slice-edge reads taken from
# the neighbouring slice and the frontier minimum taken over all slices at
# the row-block boundaries.


def _k5_slices(a, b, w, cutoff, row_block, n):
    """K5's one-buffer sweep over ``n`` slices: ``(values, frontier)``,
    ``frontier[:, t]`` the minimum of S_d and S_{d-1} at row-block
    boundary t (``+inf`` after a pair's abandon)."""
    P, L = a.shape
    wb = dtw._band_width(L, w)
    S = -(-(2 * wb + 1) // n)
    S += S & 1
    H = S // 2
    D = 2 * L - 1
    last = 2 * L - 2
    R = max(1, min(row_block, D))
    cut = np.broadcast_to(np.asarray(cutoff, np.float32), (P,))
    buf = np.full((P, n, S), np.inf, np.float32)
    dead = cut == -np.inf
    fprev = np.full(P, np.inf, np.float32)
    front = []
    for d in range(D):
        k_lo = max(0, wb - d, d + wb - last)
        k_hi = min(2 * wb, d + wb, last - d + wb)
        k_lo += (d + k_lo - wb) & 1
        par = k_lo & 1
        fcur = np.full(P, np.inf, np.float32)
        for r in range(n):
            k0 = r * S
            k1 = min(k0 + S, 2 * wb + 1)
            kb = max(k_lo, k0)
            kb += (kb - k_lo) & 1
            ks = np.arange(kb, min(k_hi, k1 - 1) + 1, 2)
            if ks.size == 0:
                continue
            m = (ks - k0) >> 1
            diff = a[:, (d + ks - wb) >> 1] - b[:, (d - ks + wb) >> 1]
            cost = diff * diff
            own = buf[:, r, par * H + m]
            if d == 0:
                best = np.zeros_like(cost)
            else:
                oth = (par ^ 1) * H
                left = np.where(ks > k0, buf[:, r, oth + m - 1 + par],
                                buf[:, max(r - 1, 0), S - 1:])
                right = np.where(ks + 1 < k0 + S, buf[:, r, oth + m + par],
                                 buf[:, min(r + 1, n - 1), :1])
                left = np.where(ks > 0, left, np.float32(np.inf))
                right = np.where(ks < 2 * wb, right, np.float32(np.inf))
                best = np.minimum(np.minimum(left, right), own)
            nd = (cost + best).astype(np.float32)
            buf[:, r, par * H + m] = nd
            fcur = np.minimum(fcur, nd.min(axis=1))
        if (d + 1) % R == 0 or d == D - 1:
            fm = np.minimum(fcur, fprev)
            front.append(np.where(dead, np.float32(np.inf), fm))
            dead = dead | (fm > cut)
        fprev = fcur
    r, kk = divmod(wb, S)
    vals = buf[:, r, (kk & 1) * H + (kk >> 1)]
    return np.where(dead, np.float32(np.inf), vals), np.stack(front, 1)


def _abandon_cutoffs(front, plain):
    """Cutoffs that abandon pairs 0, 1, 2 at the first, a middle and the
    last row block where the frontier grows (it passes a cutoff first at
    block t, as frontier minima never decrease along the sweep; two
    boundaries one anti-diagonal apart can share their minimum), let pair
    3 finish and mark pair 4 an invalid slot (-inf)."""
    n_blocks = front.shape[1]
    targets = [0, n_blocks // 2, n_blocks - 1]
    cut = np.empty(plain.shape[0], np.float32)
    for p, t in enumerate(targets):
        while t > 0 and not front[p, t] > front[p, t - 1]:
            t -= 1
        targets[p] = t
        cut[p] = front[p, 0] * 0.5 if t == 0 else front[p, t - 1]
        assert front[p, t] > cut[p]
    assert targets[0] < targets[1] < targets[2]
    cut[3] = plain[3] * 2
    cut[4] = -np.inf
    return cut, targets


@pytest.mark.parametrize("n", [2, 3, 8])
@pytest.mark.parametrize("wsel", ["0", "1", "L/4", "L"])
def test_k5_cluster_sweep_is_bit_equal_to_the_plain_version(n, wsel):
    """Form (b) of K5 (n = 2, 3, 8 slices, some empty at small w),
    emulated at odd L = 39 with row blocks of 8 (10 blocks), without
    cutoffs and with cutoffs that abandon pairs at the first, a middle
    and the last row block (and a -inf slot): bit-equal to
    ``ref.dtw_band_ref`` and ``core.dtw.dtw_band_blocked``, same +inf
    positions."""
    P, L, R = 5, 39, 8
    w = {"0": 0, "1": 1, "L/4": L // 4, "L": L}[wsel]
    a, b = _pair(40 + n, P, L)
    plain = ref.dtw_band_ref(_t(a), _t(b), w, row_block=R).numpy()
    got, front = _k5_slices(a, b, w, np.inf, R, n)
    np.testing.assert_array_equal(got, plain)
    assert front.shape[1] == 10
    cut, targets = _abandon_cutoffs(front, plain)
    want = ref.dtw_band_ref(_t(a), _t(b), w, _t(cut), row_block=R).numpy()
    np.testing.assert_array_equal(
        want, dtw.dtw_band_blocked(_t(a), _t(b), w, _t(cut),
                                   row_block=R).numpy())
    death = dtw.dtw_band_death_blocks(_t(a), _t(b), w, _t(cut),
                                      row_block=R).numpy()
    np.testing.assert_array_equal(death[:3], targets)
    got_c, _ = _k5_slices(a, b, w, cut, R, n)
    np.testing.assert_array_equal(np.isposinf(got_c), np.isposinf(want))
    np.testing.assert_array_equal(got_c, want)
    assert np.isposinf(got_c[[0, 1, 2, 4]]).all() and got_c[3] == plain[3]


@pytest.mark.parametrize("T,K,R", [(8, 5, 8), (16, 3, 1), (4, 10, 3)])
@pytest.mark.parametrize("wsel", ["0", "1", "L/4", "L"])
def test_k5_rows_sweep_is_bit_equal_to_the_plain_version(T, K, R, wsel):
    """Form (a) of K5 emulated at odd L = 39 (T threads of K rows, one
    idle thread at least), row blocks of 8, 1 (every anti-diagonal a
    boundary) and 3, without cutoffs and with cutoffs that abandon pairs
    at the first, a middle and the last row block (and a -inf slot):
    bit-equal to ``ref.dtw_band_ref``, same +inf positions, every
    boundary decided only after its last cell and by its own
    anti-diagonal's step."""
    P, L = 5, 39
    w = {"0": 0, "1": 1, "L/4": L // 4, "L": L}[wsel]
    a, b = _pair(60 + K, P, L)
    plain = ref.dtw_band_ref(_t(a), _t(b), w, row_block=R).numpy()
    np.testing.assert_array_equal(_k5_rows(a, b, w, np.inf, R, T, K), plain)
    _, front = _k5_slices(a, b, w, np.inf, R, 2)
    cut, targets = _abandon_cutoffs(front, plain)
    want = ref.dtw_band_ref(_t(a), _t(b), w, _t(cut), row_block=R).numpy()
    death = dtw.dtw_band_death_blocks(_t(a), _t(b), w, _t(cut),
                                      row_block=R).numpy()
    np.testing.assert_array_equal(death[:3], targets)
    got = _k5_rows(a, b, w, cut, R, T, K)
    np.testing.assert_array_equal(np.isposinf(got), np.isposinf(want))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("L,w,form,n", [
    (14465, 14465, "rows", 2),              # wb 14464: just over K4
    (17984, None, "rows", 2),               # the long path
    (20480, None, "rows", 2),               # 512 threads of 40 rows
    (20481, None, "cluster", 2),            # the (a)/(b) edge
    (28929, None, "cluster", 2),            # 2 wb + 1 past one block
    (65536, 65536, "cluster", 3),           # 524 KB of band state
    (231424, None, "cluster", 8),           # wb 231423: 8 blocks
    (231425, None, "scratch", 9),           # past a portable cluster
    (300000, 20000, "cluster", 2), (300000, 240000, "scratch", 9)])
def test_k5_form_at_its_boundaries(L, w, form, n):
    assert dtw_band_route(L, w) == "stream"
    assert k5_form(L, w) == form
    assert k5_cluster_size(L, w) == n
