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
from repro_torch.core import dtw
from repro_torch.data import make_dataset
from repro_torch.kernels import ops, ref
from repro_torch.kernels.dtw_band import dtw_band_route
from repro_torch.search import (
    CascadeConfig,
    EngineConfig,
    build_index,
    nn_search,
)

# the module (repro.core exports the function ``dtw`` under the same name)
jdtw = importlib.import_module("repro.core.dtw")

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
