"""K2's full form (csrc/lb_enhanced.cu, ``lb_enhanced_full_kernel``) and
the unstaged search (``CascadeConfig(staged=False)``, the dense plan's
``enhanced_dense`` tier), on the CPU against the JAX package and the
port's plain versions.

- The full form emulated block by block in float32: output tiles of 128
  queries x 64 candidates; the bridge ``[nb, L - nb)`` walked in chunks
  of 32 columns from column nb, each chunk's terms summed in column order
  into a partial added to the tile's running sum, a chunk whose tile
  holds an envelope element with ``!(lo <= u)`` taking the reference's
  arithmetic (K8's body, ``kg_tile`` of csrc/lb_keogh.cuh); the bands
  summed as the bands form sums them (least |q - c| per band, squared
  once, left then right bands from zero, then left + right); one add of
  bands and bridge; a dead candidate ``-inf`` down its column and an
  all-dead 64-candidate tile skipped.  It agrees with
  ``lb_enhanced_pallas`` in interpret mode and with
  ``ref.lb_enhanced_ref`` to rtol 1e-5, atol 1e-6 (the bridge's sum runs
  in another order than the plain version's reduction) over nb in
  {0, 1, 4, 8, 9, L / 2} and ragged Q, C and L, NaN where the plain
  version has NaN; its bands part is bit-equal to the plain bands (the
  bands form), and at nb = 0 it is the K8 emulation of
  ``tests/test_torch_slice8.py`` bit for bit.
- ``nn_search`` with ``staged=False`` against the JAX engine with
  ``staged=False, use_pallas=False`` (guards off on the JAX side, as in
  ``tests/test_torch_search.py``): neighbour ids and per-query ``n_dtw``
  equal at w = 0.1 L and w = L, and with the sketch tier under a
  build-time store mask; ids and distances equal the staged search's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.lb_enhanced import lb_enhanced_pallas
from repro.search import CascadeConfig as JCascadeConfig
from repro.search import EngineConfig as JEngineConfig
from repro.search import build_index as j_build_index
from repro.search import nn_search as j_nn_search
from repro.search import planner as j_planner
from repro.search.guards import GuardConfig as JGuardConfig
from repro_torch.core.lower_bounds import _n_bands
from repro_torch.data import make_dataset
from repro_torch.kernels import ref
from repro_torch.search import CascadeConfig, EngineConfig, build_index
from repro_torch.search import nn_search
from repro_torch.search.planner import plan_cache_clear
from test_torch_slice8 import _clamp_terms, _k8_kernel, _ref_terms

TQ, TC, KC = 128, 64, 32
_INF = float("inf")


def _bands(q, c, nb):
    """The bands form's arithmetic in float32 from the 2 nb band columns:
    ``(Q, L) x (C, L) -> (Q, C)``."""
    L = q.shape[1]
    qv = q[:, None, :]
    cv = c[None, :, :]
    left = torch.zeros((q.shape[0], c.shape[0]))
    right = torch.zeros_like(left)
    for bi in range(nb):
        m = (qv[..., bi] - cv[..., bi]).abs()
        for j in range(bi):
            m = torch.minimum(m, torch.minimum(
                (qv[..., j] - cv[..., bi]).abs(),
                (qv[..., bi] - cv[..., j]).abs()))
        left = left + m * m
    for bi in range(nb):
        i = L - 1 - bi
        m = (qv[..., i] - cv[..., i]).abs()
        for t in range(1, bi + 1):
            m = torch.minimum(m, torch.minimum(
                (qv[..., i + t] - cv[..., i]).abs(),
                (qv[..., i] - cv[..., i + t]).abs()))
        right = right + m * m
    return left + right


def _k2_full(q, c, u, lo, w, v, live=None):
    """csrc/lb_enhanced.cu's full form emulated in float32, tile by tile
    (module docstring)."""
    Q, L = q.shape
    C = c.shape[0]
    nb = _n_bands(L, w, v)
    bands = _bands(q, c, nb)
    out = torch.empty((Q, C))
    for q0 in range(0, Q, TQ):
        for c0 in range(0, C, TC):
            cs = slice(c0, c0 + TC)
            if live is not None and not bool(live[cs].any()):
                out[q0:q0 + TQ, cs] = -_INF          # an all-dead tile
                continue
            qt = q[q0:q0 + TQ, None, :]
            ut, lt = u[None, cs], lo[None, cs]
            bridge = torch.zeros((qt.shape[0], ut.shape[1]))
            for k0 in range(nb, L - nb, KC):
                ks = slice(k0, min(k0 + KC, L - nb))
                bad = bool((~(lt[..., ks] <= ut[..., ks])).any())
                terms = (_ref_terms if bad else _clamp_terms)(
                    qt[..., ks], ut[..., ks], lt[..., ks])
                part = torch.zeros_like(bridge)
                for k in range(terms.shape[-1]):
                    part = part + terms[..., k]
                bridge = bridge + part
            tile = bands[q0:q0 + TQ, cs] + bridge
            if live is not None:
                tile = torch.where(live[cs], tile, -_INF)
            out[q0:q0 + TQ, cs] = tile
    return out


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert np.array_equal(np.isnan(got), np.isnan(want))
    assert np.array_equal(np.isneginf(got), np.isneginf(want))
    ok = np.isfinite(want)
    np.testing.assert_allclose(got[ok], want[ok], rtol=1e-5, atol=1e-6)


def _inputs(seed, Q, C, L, w):
    rng = np.random.default_rng(seed)
    q = (rng.normal(size=(Q, L)).cumsum(1)).astype(np.float32)
    c = (rng.normal(size=(C, L)).cumsum(1)).astype(np.float32)
    u, lo = ref.envelope_ref(torch.from_numpy(c), w)
    return torch.from_numpy(q), torch.from_numpy(c), u, lo


def _live(seed, C):
    live = np.random.default_rng(seed).random(C) > 0.3
    live[:TC] = False                            # an all-dead tile
    if C > TC + 6:
        live[TC + 6] = True
    return torch.from_numpy(live)


# Q, C, L, w, v: nb = 4 (two query tiles, three candidate tiles, a ragged
# last chunk), nb = 1 (Q < 8), nb = 9 (the generic bands), nb = 8 = L / 2
# (an empty bridge, C < 64), nb = 0 (pure Keogh); each one JAX compilation
JAX_CASES = [(130, 150, 100, 10, 4), (5, 70, 66, 1, 4), (40, 129, 97, 20, 9),
             (7, 60, 16, 16, 8), (20, 100, 45, 8, 0)]


@pytest.mark.parametrize("Q,C,L,w,v", JAX_CASES)
def test_full_form_emulated_matches_jax_and_plain(Q, C, L, w, v):
    q, c, u, lo = _inputs(Q + C + L, Q, C, L, w)
    got = _k2_full(q, c, u, lo, w, v)
    want = np.asarray(lb_enhanced_pallas(
        jnp.array(q.numpy()), jnp.array(c.numpy()), jnp.array(u.numpy()),
        jnp.array(lo.numpy()), w, v, interpret=True))
    _close(got, want)
    _close(got, ref.lb_enhanced_ref(q, c, u, lo, w, v))


def test_full_form_emulated_live_matches_jax_and_plain():
    """The live mask with an all-dead first tile: dead columns -inf in
    all three, the tile skipped in the emulation."""
    Q, C, L, w, v = JAX_CASES[0]
    q, c, u, lo = _inputs(7, Q, C, L, w)
    live = _live(8, C)
    got = _k2_full(q, c, u, lo, w, v, live=live)
    assert torch.isneginf(got[:, :TC]).all()
    want = np.asarray(lb_enhanced_pallas(
        jnp.array(q.numpy()), jnp.array(c.numpy()), jnp.array(u.numpy()),
        jnp.array(lo.numpy()), w, v, live=jnp.array(live.numpy()),
        interpret=True))
    _close(got, want)
    _close(got, ref.lb_enhanced_ref(q, c, u, lo, w, v, live=live))


# the plain version only: nb = L / 2 at odd L (one bridge column), nb = 1
# at w = 1, L = 17984 (UEA EigenWorms), a lone query
PLAIN_CASES = JAX_CASES + [(6, 64, 17, 17, 9), (3, 70, 33, 1, 4),
                           (4, 70, 17984, 179, 4), (1, 65, 40, 40, 4)]


@pytest.mark.parametrize("Q,C,L,w,v", PLAIN_CASES)
def test_full_form_emulated_on_odd_envelopes_matches_plain(Q, C, L, w, v):
    """lo > u at a cell and along a run, +-inf bounds and a NaN: the
    chunks that hold them take the reference's arithmetic, NaN where the
    plain version has NaN; with and without the live mask."""
    q, c, u, lo = _inputs(L + 1, Q, C, L, w)
    u, lo = u.clone(), lo.clone()
    u[1, L // 2] = lo[1, L // 2] - 3.0
    lo[2, 1:L - 1] = u[2, 1:L - 1] + 0.5
    u[3, :] = _INF
    lo[4, :L // 2] = -_INF
    lo[C - 1, L // 3] = float("nan")
    for live in (None, _live(L, C)):
        want = ref.lb_enhanced_ref(q, c, u, lo, w, v, live=live)
        _close(_k2_full(q, c, u, lo, w, v, live=live), want)
    nb = _n_bands(L, w, v)
    if nb <= L // 3 < L - nb:                    # the NaN is bridged
        assert torch.isnan(ref.lb_enhanced_ref(q, c, u, lo, w, v)[:, C - 1]
                           ).all()


@pytest.mark.parametrize("Q,C,L,w,v", PLAIN_CASES)
def test_full_form_bands_part_and_nb0_bit_equal(Q, C, L, w, v):
    """The emulation's bands are the plain bands bit for bit (the bands
    form's arithmetic); with infinite envelopes every bridge term is 0 and
    the whole form is its bands; at V = 0 it is the K8 emulation."""
    q, c, u, lo = _inputs(L + 2, Q, C, L, w)
    nb = _n_bands(L, w, v)
    plain = ref.lb_enhanced_ref(q, c, None, None, w, v, bands_only=True)
    assert torch.equal(_bands(q, c, nb), plain)
    inf = torch.full_like(c, _INF)
    assert torch.equal(_k2_full(q, c, inf, -inf, w, v), plain)
    assert torch.equal(_k2_full(q, c, u, lo, w, 0), _k8_kernel(q, u, lo))


# ---------------------------------------------------------------------------
# the unstaged search against the JAX engine
# ---------------------------------------------------------------------------

SEARCH = dict(n_classes=3, n_train_per_class=32, n_test_per_class=6,
              length=48, seed=21)
_J_NO_GUARDS = JGuardConfig(enabled=False)


@pytest.fixture(scope="module")
def ds():
    return make_dataset(**SEARCH)


@pytest.mark.parametrize("frac", [0.1, 1.0])
def test_unstaged_nn_search_matches_jax(ds, frac):
    """w = 0.1 L and w = L: ids and per-query n_dtw equal to JAX's
    unstaged engine, distances within rtol 1e-5; ids and distances equal
    to the port's staged search."""
    w = int(frac * ds.length)
    idx = build_index(ds.x_train, w, ds.y_train, device="cpu")
    jidx = j_build_index(ds.x_train, w, ds.y_train, sketch=None)
    cfg = EngineConfig(cascade=CascadeConfig(w=w, v=4, staged=False,
                                             candidate_chunk=16),
                       verify_chunk=4, k=1)
    jcfg = JEngineConfig(cascade=JCascadeConfig(
        w=w, v=4, staged=False, use_pallas=False, candidate_chunk=16),
        verify_chunk=4, k=1, guards=_J_NO_GUARDS)
    res = nn_search(idx, ds.x_test, cfg)
    jres = j_nn_search(jidx, jnp.asarray(ds.x_test), jcfg)
    np.testing.assert_array_equal(res.idx.numpy(), np.asarray(jres.idx))
    np.testing.assert_array_equal(res.n_dtw.numpy(), np.asarray(jres.n_dtw))
    np.testing.assert_allclose(res.dists.numpy(), np.asarray(jres.dists),
                               rtol=1e-5)
    staged = nn_search(idx, ds.x_test, EngineConfig(
        cascade=CascadeConfig(w=w, v=4, candidate_chunk=16), verify_chunk=4,
        k=1))
    assert torch.equal(staged.idx, res.idx)
    assert torch.equal(staged.dists, res.dists)


def test_unstaged_sketch_search_under_a_build_time_mask_matches_jax():
    """``use_sketch`` with ``staged=False`` on a store masked at build time
    (the mask needs the staged calibration): the same live mask as JAX's,
    and ids and per-query n_dtw equal to JAX's unstaged engine."""
    rng = np.random.default_rng(5)
    N, L, w = 96, 64, 16
    store = np.cumsum(rng.normal(size=(N, L)), axis=1).astype(np.float32)
    q = np.cumsum(rng.normal(size=(10, L)), axis=1).astype(np.float32)
    cal = EngineConfig(cascade=CascadeConfig(w=w, use_sketch=True), k=1,
                       auto_plan=True)
    jcal = JEngineConfig(cascade=JCascadeConfig(w=w, use_sketch=True,
                                                use_pallas=False),
                         k=1, auto_plan=True, guards=_J_NO_GUARDS)
    plan_cache_clear()
    j_planner.plan_cache_clear()
    try:
        idx = build_index(store, w, device="cpu", calibrate=cal, mask=True)
        jidx = j_build_index(store, w, calibrate=jcal, mask=True)
        assert idx.live is not None and not bool(idx.live.all())
        np.testing.assert_array_equal(idx.live.numpy(),
                                      np.asarray(jidx.live))
        res = nn_search(idx, q, EngineConfig(cascade=CascadeConfig(
            w=w, use_sketch=True, staged=False), k=1))
        jres = j_nn_search(jidx, jnp.asarray(q), JEngineConfig(
            cascade=JCascadeConfig(w=w, use_sketch=True, staged=False,
                                   use_pallas=False),
            k=1, guards=_J_NO_GUARDS))
        np.testing.assert_array_equal(res.idx.numpy(), np.asarray(jres.idx))
        np.testing.assert_array_equal(res.n_dtw.numpy(),
                                      np.asarray(jres.n_dtw))
        staged = nn_search(idx, q, cal)
        assert torch.equal(staged.idx, res.idx)
        assert torch.equal(staged.dists, res.dists)
    finally:
        plan_cache_clear()
        j_planner.plan_cache_clear()
