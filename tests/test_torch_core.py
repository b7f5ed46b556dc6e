"""The port's plain PyTorch core (``repro_torch.core``) against the JAX
package's ``repro.core`` and the loop-based oracles in
``repro/core/oracle.py``, over w in {0, 1, L/4, L} at an odd length.

Tolerances: envelopes are exact (max and min).  The bounds agree with the
JAX versions to rtol 1e-6 (bands: XLA may reassociate the short band sum)
or 1e-5 (L-term sums).  Banded DTW agrees to rtol 1e-5: XLA on the CPU
contracts the cell update ``cost + best`` into a fused multiply-add,
while the port keeps it unfused, as its CUDA kernel does.  The float64
oracles agree to rtol 1e-4 (float32 accumulation over L cells).
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import distances as jdist
from repro.core import envelopes as jenv
from repro.core import lower_bounds as jlb
from repro.core import oracle
from repro.core.dtw import dtw_band_blocked as j_dtw_band_blocked
from repro.core.dtw import row_block_policy as j_row_block_policy
from repro_torch.core import distances, envelopes, lower_bounds

# the module (repro_torch.core exports the function ``dtw`` under the same
# name, as repro.core does)
dtw = importlib.import_module("repro_torch.core.dtw")

L = 33
WS = [0, 1, L // 4, L]


def _series(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def test_znorm_matches_jax():
    x = _series(0, 6, L) * 3.0 + 1.5
    got = distances.znorm(_t(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jdist.znorm(jnp.asarray(x))),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("w", WS + [3 * L])
def test_envelope_matches_jax_and_oracle(w):
    b = _series(1, 5, L)
    u, lo = envelopes.envelope(_t(b), w)
    ju, jl = jenv.envelope(jnp.asarray(b), w)
    np.testing.assert_array_equal(u.numpy(), np.asarray(ju))
    np.testing.assert_array_equal(lo.numpy(), np.asarray(jl))
    for row in range(b.shape[0]):
        ou, ol = oracle.envelope(b[row], w)
        np.testing.assert_array_equal(u[row].numpy(), ou.astype(np.float32))
        np.testing.assert_array_equal(lo[row].numpy(), ol.astype(np.float32))


@pytest.mark.parametrize("L_", [1, 2, 33, 64, 100, 512, 4097])
def test_row_block_policy_matches_jax(L_):
    assert dtw.row_block_policy(L_) == j_row_block_policy(L_)


@pytest.mark.parametrize("w", WS + [None])
def test_dtw_matches_jax_and_oracle(w):
    a, b = _series(2, 6, L), _series(3, 6, L)
    got = dtw.dtw_band_blocked(_t(a), _t(b), w).numpy()
    want = np.asarray(j_dtw_band_blocked(jnp.asarray(a), jnp.asarray(b),
                                            w))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    for p in range(a.shape[0]):
        scalar = dtw.dtw(_t(a[p]), _t(b[p]), w)
        assert scalar.item() == got[p]          # same arithmetic, same value
        assert scalar.item() == pytest.approx(oracle.dtw(a[p], b[p], w),
                                              rel=1e-4)


@pytest.mark.parametrize("w", WS)
@pytest.mark.parametrize("row_block", [None, 7])
def test_dtw_cutoff_abandons_like_jax(w, row_block):
    """Pairs whose frontier passes their cutoff return +inf on the same
    pairs as the JAX rule; the rest keep their exact values, and a -inf
    cutoff always kills."""
    P = 12
    a, b = _series(4, P, L), _series(5, P, L)
    exact = dtw.dtw_band_blocked(_t(a), _t(b), w).numpy()
    rng = np.random.default_rng(6)
    cut = (exact * rng.uniform(0.5, 1.5, size=P)).astype(np.float32)
    cut[::5] = -np.inf
    got = dtw.dtw_band_blocked(_t(a), _t(b), w, _t(cut),
                               row_block=row_block).numpy()
    want = np.asarray(j_dtw_band_blocked(
        jnp.asarray(a), jnp.asarray(b), w, jnp.asarray(cut),
        row_block=row_block))
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    assert np.isinf(got[::5]).all()
    live = ~np.isinf(got)
    assert live.any() and not live.all()
    np.testing.assert_array_equal(got[live], exact[live])
    np.testing.assert_allclose(got[live], want[live], rtol=1e-5)


@pytest.mark.parametrize("w", WS)
def test_lower_bounds_match_jax_and_oracle(w):
    v = 4
    P = 8
    a, b = _series(7, P, L), _series(8, P, L)
    ta, tb = _t(a), _t(b)
    u, lo = envelopes.envelope(tb, w)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    ju, jl = jenv.envelope(jb, w)
    assert lower_bounds._n_bands(L, w, v) == jlb._n_bands(L, w, v)
    np.testing.assert_allclose(lower_bounds.lb_kim(ta, tb).numpy(),
                               np.asarray(jlb.lb_kim(ja, jb)), rtol=1e-6)
    np.testing.assert_allclose(
        lower_bounds.lb_keogh_env(ta, u, lo).numpy(),
        np.asarray(jlb.lb_keogh_env(ja, ju, jl)), rtol=1e-5, atol=1e-6)
    bands = lower_bounds.lb_enhanced_bands(ta, tb, w, v).numpy()
    for p in range(P):
        np.testing.assert_allclose(
            bands[p], float(jlb.lb_enhanced_bands(ja[p], jb[p], w, v)),
            rtol=1e-6)
        np.testing.assert_allclose(
            bands[p], oracle.lb_enhanced_bands(a[p], b[p], w, v), rtol=1e-5,
            atol=1e-6)
    enh = lower_bounds.lb_enhanced_env(ta, tb, u, lo, w, v).numpy()
    d = dtw.dtw_band_blocked(ta, tb, w).numpy()
    for p in range(P):
        np.testing.assert_allclose(
            enh[p], float(jlb.lb_enhanced_env(ja[p], jb[p], ju[p], jl[p], w,
                                              v)), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(enh[p], oracle.lb_enhanced(a[p], b[p],
                                                              w, v),
                                   rtol=1e-4, atol=1e-5)
    assert (enh <= d * (1 + 1e-5) + 1e-6).all()      # admissible
    mat = lower_bounds.lb_enhanced_matrix(ta, tb, u, lo, w, v).numpy()
    np.testing.assert_allclose(
        mat, np.asarray(jlb.lb_enhanced_matrix(ja, jb, ju, jl, w, v)),
        rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.diag(mat), enh, rtol=1e-5, atol=1e-6)
