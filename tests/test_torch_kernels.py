"""The port's kernel layer on the CPU: each plain version in
``repro_torch.kernels.ref`` against ``repro.kernels.ref`` and against the
JAX Pallas kernel through ``repro.kernels.ops`` (interpret mode on the
CPU), covering ``live``, ``bands_only``, ``cutoff`` and ``perm`` /
``tile_p``; and the device dispatch of ``repro_torch.kernels.ops``.

Tolerances: envelopes are exact; the LB_ENHANCED forms agree to rtol
1e-5, atol 1e-6 (their L-term sums run in another order) with the same
-inf positions; banded DTW agrees to rtol 1e-5 with the same +inf
positions (XLA contracts the cell update into an FMA, the port does not).
The CUDA kernels themselves are held against these plain versions on the
card by tests/test_torch_gpu.py and chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import _build, ops, ref, tiling
from repro_torch.kernels.dtw_band import dtw_band_cuda
from repro_torch.kernels.envelope import envelope_cuda
from repro_torch.kernels.lb_enhanced import lb_enhanced_cuda
from repro_torch.kernels.lb_enhanced_pairwise import lb_enhanced_pairwise_cuda

L = 33
WS = [0, 1, L // 4, L]


def _series(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _same_infs(got, want):
    np.testing.assert_array_equal(np.isposinf(got), np.isposinf(want))
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    return np.isfinite(want)


@pytest.mark.parametrize("w", WS)
def test_envelope_ref_matches_jax_ref_and_pallas(w):
    b = _series(0, 5, L)
    u, lo = ref.envelope_ref(_t(b), w)
    for ju, jl in (jref.envelope_ref(jnp.asarray(b), w),
                   jops.envelope_op(jnp.asarray(b), w)):
        np.testing.assert_array_equal(u.numpy(), np.asarray(ju))
        np.testing.assert_array_equal(lo.numpy(), np.asarray(jl))


# (w, bands_only, with_live): every w of the sweep, each flag both ways
LB_CASES = [(0, False, False), (1, True, True), (L // 4, False, True),
            (L // 4, True, False), (L, False, False), (L, True, True)]


@pytest.mark.parametrize("w,bands_only,with_live", LB_CASES)
def test_lb_enhanced_ref_matches_jax(w, bands_only, with_live):
    """Cross-block (Q, C) bounds at a ragged C = 37; with ``live`` about
    a third of the candidates, the first 8 among them, are dead."""
    Q, C, v = 3, 37, 4
    q, c = _series(1, Q, L), _series(2, C, L)
    u, lo = ref.envelope_ref(_t(c), w)
    live = None
    if with_live:
        live = np.random.default_rng(3).uniform(size=C) > 0.3
        live[:8] = False
    got = ref.lb_enhanced_ref(_t(q), _t(c), u, lo, w, v,
                              live=None if live is None else _t(live),
                              bands_only=bands_only).numpy()
    jargs = (jnp.asarray(q), jnp.asarray(c), jnp.asarray(u.numpy()),
             jnp.asarray(lo.numpy()), w, v)
    jlive = None if live is None else jnp.asarray(live)
    for want in (jref.lb_enhanced_ref(*jargs, live=jlive,
                                      bands_only=bands_only),
                 jops.lb_enhanced_op(*jargs, live=jlive,
                                     bands_only=bands_only)):
        want = np.asarray(want)
        fin = _same_infs(got, want)
        np.testing.assert_allclose(got[fin], want[fin], rtol=1e-5,
                                   atol=1e-6)
    if with_live:
        assert np.isneginf(got[:, ~live]).all()


@pytest.mark.parametrize("w,bands_only,with_live", LB_CASES)
def test_lb_enhanced_pairwise_ref_matches_jax(w, bands_only, with_live):
    """Packed (P,) bounds at a ragged P = 21; with ``live`` about a third
    of the slots, the first 8 among them, are dead."""
    P, v = 21, 4
    q, c = _series(4, P, L), _series(5, P, L)
    u, lo = ref.envelope_ref(_t(c), w)
    live = None
    if with_live:
        live = np.random.default_rng(6).uniform(size=P) > 0.3
        live[:8] = False
    got = ref.lb_enhanced_pairwise_ref(
        _t(q), _t(c), u, lo, w, v, live=None if live is None else _t(live),
        bands_only=bands_only).numpy()
    jargs = (jnp.asarray(q), jnp.asarray(c), jnp.asarray(u.numpy()),
             jnp.asarray(lo.numpy()), w, v)
    jlive = None if live is None else jnp.asarray(live)
    for want in (jref.lb_enhanced_pairwise_ref(*jargs, live=jlive,
                                               bands_only=bands_only),
                 jops.lb_enhanced_pairwise_op(*jargs, live=jlive,
                                              bands_only=bands_only)):
        want = np.asarray(want)
        fin = _same_infs(got, want)
        np.testing.assert_allclose(got[fin], want[fin], rtol=1e-5,
                                   atol=1e-6)
    # the pairwise bound is the diagonal of the cross-block one
    cross = ref.lb_enhanced_ref(_t(q), _t(c), u, lo, w, v,
                                bands_only=bands_only).numpy()
    fin = np.isfinite(got)
    np.testing.assert_allclose(got[fin], np.diag(cross)[fin], rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("w", WS)
def test_dtw_band_ref_matches_jax_with_cutoff_and_perm(w):
    """Cutoffs that kill some pairs (and -inf ones, the engine's invalid
    slots), against the JAX reference and Pallas kernel; ``perm`` and
    ``tile_p`` change nothing."""
    P = 20
    a, b = _series(7, P, L), _series(8, P, L)
    ta, tb = _t(a), _t(b)
    exact = ref.dtw_band_ref(ta, tb, w).numpy()
    cut = (exact * np.random.default_rng(9).uniform(0.5, 1.5, size=P)
           ).astype(np.float32)
    cut[::6] = -np.inf
    perm = np.random.default_rng(10).permutation(P)
    got = ref.dtw_band_ref(ta, tb, w, _t(cut)).numpy()
    assert np.isinf(got).any() and np.isfinite(got).any()
    for variant in (
            ref.dtw_band_ref(ta, tb, w, _t(cut), perm=_t(perm)),
            ref.dtw_band_ref(ta, tb, w, _t(cut), tile_p=8),
            ops.dtw_band_op(ta, tb, w, _t(cut), perm=_t(perm), tile_p=16)):
        np.testing.assert_array_equal(variant.numpy(), got)
    jargs = (jnp.asarray(a), jnp.asarray(b), w, jnp.asarray(cut))
    for want in (jref.dtw_band_ref(*jargs),
                 jops.dtw_band_op(*jargs, perm=jnp.asarray(perm), tile_p=8)):
        want = np.asarray(want)
        fin = _same_infs(got, want)
        np.testing.assert_allclose(got[fin], want[fin], rtol=1e-5)
    # the uncut reference path is the JAX scalar DTW, vmapped
    np.testing.assert_allclose(
        exact, np.asarray(jref.dtw_band_ref(jnp.asarray(a), jnp.asarray(b),
                                            w)), rtol=1e-5)


def test_ops_on_cpu_run_the_plain_versions():
    q, c = _t(_series(11, 4, L)), _t(_series(12, 6, L))
    w, v = 5, 4
    u, lo = ops.envelope_op(c, w)
    ru, rlo = ref.envelope_ref(c, w)
    assert torch.equal(u, ru) and torch.equal(lo, rlo)
    u1, lo1 = ops.envelope_op(c[0], w)                 # a single series
    assert torch.equal(u1, ru[0]) and torch.equal(lo1, rlo[0])
    assert torch.equal(ops.lb_enhanced_op(q, c, u, lo, w, v, bands_only=True),
                       ref.lb_enhanced_ref(q, c, u, lo, w, v,
                                           bands_only=True))
    qq = q.repeat(2, 1)[:6]
    assert torch.equal(ops.lb_enhanced_pairwise_op(qq, c, u, lo, w, v),
                       ref.lb_enhanced_pairwise_ref(qq, c, u, lo, w, v))
    assert torch.equal(ops.dtw_band_op(qq, c, w), ref.dtw_band_ref(qq, c, w))
    assert sum(_build.counts().values()) == 0        # no kernel launched


def test_kernel_wrappers_refuse_cpu_tensors_and_other_devices():
    x = torch.zeros(4, 16)
    with pytest.raises(ValueError, match="CUDA"):
        envelope_cuda(x, 2)
    with pytest.raises(ValueError, match="CUDA"):
        lb_enhanced_cuda(x, x, x, x, 2, 4)
    with pytest.raises(ValueError, match="CUDA"):
        lb_enhanced_pairwise_cuda(x, x, x, x, 2, 4)
    with pytest.raises(ValueError, match="CUDA"):
        dtw_band_cuda(x, x, 2)
    meta = torch.empty(4, 16, device="meta")
    with pytest.raises(RuntimeError, match="no kernel route"):
        ops.dtw_band_op(meta, meta, 2)


def test_pair_perm_round_trip():
    perm = torch.tensor([3, 0, 2, 1])
    x = torch.arange(4.0)
    (px,) = tiling.permute_pairs(perm, x)
    assert torch.equal(tiling.unpermute_pairs(perm, px * 2), x * 2)
    # a scalar cutoff stays legal under perm
    out = tiling.apply_pair_perm(lambda a, b, c: a.sum(1) + c, perm,
                                 torch.ones(4, 3), torch.ones(4, 3), 1.5)
    assert torch.equal(out, torch.full((4,), 4.5))


def test_launch_counters_reset_and_read():
    counts = _build.counts()
    assert set(counts) == {"envelope", "lb_enhanced", "lb_enhanced_full",
                           "lb_enhanced_pairwise",
                           "dtw_band", "dtw_band_slots", "dtw_band_block",
                           "dtw_band_stream", "dtw_band_stream_cluster",
                           "dtw_band_stream_scratch", "dtw_band_step",
                           "dtw_band_step_slots", "dtw_band_step_block",
                           "sketch_bound", "lb_keogh",
                           "flash_attention", "flash_attention_f32",
                           "mamba_scan", "mamba_scan_wide"}
    _build.COUNTS["dtw_band"] += 3
    assert _build.counts()["dtw_band"] == 3
    _build.reset_counts()
    assert sum(_build.counts().values()) == 0


def test_build_key_covers_every_source():
    key = _build.build_key()
    assert len(key) == 16 and key == _build.build_key()
    names = {p.name for p in _build._sources()}
    assert names == {"envelope.cu", "lb_enhanced.cu",
                     "lb_enhanced_pairwise.cu", "dtw_band.cu",
                     "dtw_band_stream.cu", "sketch.cu", "lb_keogh.cu",
                     "flash_attention.cu", "mamba_scan.cu"}
