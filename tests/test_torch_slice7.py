"""The cross-block tiers' dispatch, K2's bands-only arithmetic and K9's
wide form, on the CPU against the JAX package and the port's plain
versions.

- ``bands_prefilter`` and ``enhanced_all_pairs`` equal
  ``repro.search.cascade``'s (jnp references, ``use_pallas=False``) at
  candidate chunks below, at and past the store size, with and without a
  ``live`` mask, to ``tests/test_torch_kernels.py``'s rtol 1e-5, atol
  1e-6 (XLA reassociates the band sum, ~1 ulp, and the full tier's O(L)
  bridge sums run in another order), with the same -inf positions; the
  port's bands tier is bit-equal across chunk sizes.
- ``_chunked_columns`` makes one call over the whole store on the kernel
  route and ``ceil(N / candidate_chunk)`` calls on the plain route, with
  the same matrix (the route predicate is patched: no card is needed).
- K2's bands form (csrc/lb_enhanced.cu, ``lbb_bands``) emulated in numpy
  float32 from its staged columns: least |q - c| per band, squared once,
  summed in the fixed order; bit-equal to ``ref.lb_enhanced_ref``.
- ``ref.flash_attention_ref`` equals the Pallas kernel in interpret mode
  at head dims 320 and 512 (the JAX test's rtol 2e-3, atol 2e-3), and a
  two-pass evaluation tile by tile in float64 (a max and sum pass, then
  p = exp(s - m) per key tile; the arithmetic of an earlier K9 form for
  wide heads, independent of the plain version's online softmax) equals
  it to rtol 1e-5, atol 1e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention_pallas
from repro.search import CascadeConfig as JCascadeConfig
from repro.search import build_index as j_build_index
from repro.search import cascade as j_cascade
from repro_torch.core.lower_bounds import _n_bands
from repro_torch.data import make_dataset
from repro_torch.kernels import ref
from repro_torch.search import CascadeConfig, build_index
from repro_torch.search import cascade

L = 41
W = 10
DATA = dict(n_classes=4, n_train_per_class=160, n_test_per_class=2,
            length=L, seed=9)


@pytest.fixture(scope="module")
def stores():
    ds = make_dataset(**DATA)
    idx = build_index(ds.x_train, W, ds.y_train, device="cpu")
    jidx = j_build_index(ds.x_train, W, ds.y_train, sketch=None)
    live = np.random.default_rng(4).random(idx.n) > 0.4
    live[:40] = False                    # a run of dead candidates
    live[100:140] = False
    live[120] = True                     # a lone survivor
    return ds, idx, jidx, live


@pytest.mark.parametrize("tier", ["bands_prefilter", "enhanced_all_pairs"])
@pytest.mark.parametrize("chunk", [8, 512, 1024])
@pytest.mark.parametrize("with_live", [False, True])
def test_cross_block_tiers_match_jax(stores, tier, chunk, with_live):
    ds, idx, jidx, live = stores
    q = ds.x_test.astype(np.float32)
    cfg = CascadeConfig(w=W, v=4, candidate_chunk=chunk)
    jcfg = JCascadeConfig(w=W, v=4, candidate_chunk=chunk, use_pallas=False)
    got = getattr(cascade, tier)(
        torch.from_numpy(q), idx, cfg,
        live=torch.from_numpy(live) if with_live else None).numpy()
    want = np.asarray(getattr(j_cascade, tier)(
        jnp.asarray(q), jidx, jcfg,
        live=jnp.asarray(live) if with_live else None))
    assert got.shape == (q.shape[0], idx.n)
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-5, atol=1e-6)
    if tier == "bands_prefilter":
        whole = cascade.bands_prefilter(
            torch.from_numpy(q), idx,
            CascadeConfig(w=W, v=4, candidate_chunk=idx.n),
            live=torch.from_numpy(live) if with_live else None).numpy()
        np.testing.assert_array_equal(got, whole)


@pytest.mark.parametrize("on_kernel_route", [False, True])
@pytest.mark.parametrize("chunk", [8, 100, 640, 4096])
def test_chunked_columns_calls_per_route(stores, monkeypatch,
                                         on_kernel_route, chunk):
    """One call over the store on the kernel route, ``ceil(N / chunk)`` on
    the plain route; the same matrix either way."""
    ds, idx, _, live = stores
    q = torch.from_numpy(ds.x_test.astype(np.float32))
    calls = []

    def counting(qq, c, u, lo, w, v, *, live=None, bands_only=False):
        calls.append(c.shape[0])
        return ref.lb_enhanced_ref(qq, c, u, lo, w, v, live=live,
                                   bands_only=bands_only)

    cfg = CascadeConfig(w=W, v=4, candidate_chunk=chunk)
    want = cascade.bands_prefilter(q, idx, cfg, live=torch.from_numpy(live))
    monkeypatch.setattr(cascade, "_kernel_route",
                        lambda qq, c: on_kernel_route)
    monkeypatch.setattr(CascadeConfig, "lb_fn", lambda self: counting)
    got = cascade.bands_prefilter(q, idx, cfg, live=torch.from_numpy(live))
    n_calls = 1 if on_kernel_route else -(-idx.n // min(chunk, idx.n))
    assert len(calls) == n_calls and sum(calls) == idx.n
    assert torch.equal(got, want)


def test_kernel_route_predicate():
    q = torch.zeros(2, 8)
    assert not cascade._kernel_route(q, CascadeConfig(w=2))
    assert not cascade._kernel_route(q, CascadeConfig(w=2, use_kernels=False))


def _k2_bands(q, c, nb):
    """K2's staged bands form in numpy float32: columns [0, nb) and
    [L - nb, L) of each row, band bi the least |q - c| of its arm cells
    squared once, left then right bands summed in order from zero."""
    L = q.shape[1]
    cols = list(range(nb)) + list(range(L - nb, L))
    qv = q[:, None, cols]                       # (Q, 1, 2 nb)
    cv = c[None, :, cols]                       # (1, C, 2 nb)
    f32 = np.float32

    def cell(a, b):
        return np.abs(np.subtract(a, b, dtype=f32))

    def band_sum(idxs):
        s = np.zeros(qv.shape[0:1] + cv.shape[1:2], f32)
        for i, others in idxs:
            m = cell(qv[..., i], cv[..., i])
            for j in others:
                m = np.minimum(m, np.minimum(cell(qv[..., j], cv[..., i]),
                                             cell(qv[..., i], cv[..., j])))
            s = np.add(s, np.multiply(m, m, dtype=f32), dtype=f32)
        return s

    left = band_sum([(bi, range(bi)) for bi in range(nb)])
    right = band_sum([(2 * nb - 1 - bi, range(2 * nb - bi, 2 * nb))
                      for bi in range(nb)])
    return np.add(left, right, dtype=f32)


@pytest.mark.parametrize("L,w,v", [(512, 51, 4), (33, 8, 4), (64, 64, 8),
                                   (9, 9, 4), (24, 3, 4), (40, 1, 4),
                                   (31, 31, 5), (17984, 17984, 4)])
def test_k2_bands_form_bit_equal_to_plain(L, w, v):
    rng = np.random.default_rng(L + w + v)
    q = rng.normal(size=(7, L)).astype(np.float32)
    c = rng.normal(size=(45, L)).astype(np.float32)
    q[0, :] = c[3, :]                            # a zero bound
    nb = _n_bands(L, w, v)
    want = ref.lb_enhanced_ref(torch.from_numpy(q), torch.from_numpy(c),
                               None, None, w, v, bands_only=True).numpy()
    np.testing.assert_array_equal(_k2_bands(q, c, nb), want)
    assert want[0, 3] == 0.0


def _k9_wide(q, k, v, causal, window, cap, tile_q_rows=64, tile_k=32):
    """A two-pass attention, tile by tile in float64: rows folded per kv head
    (row r = query q0 + r / g, head hk g + r % g), key tiles outside the
    causal wedge or the window skipped; pass 1 takes each row's running
    max and sum over the key tiles, pass 2 recomputes the scores and
    accumulates exp(s - m) v with the final m, divided by max(l, 1e-30)."""
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    g = Hq // Hkv
    tq = tile_q_rows // g
    neg = -2.3819763e38
    out = np.zeros((B, Sq, Hq, D))
    for b in range(B):
        for hk in range(Hkv):
            for q0 in range(0, Sq, tq):
                nq = min(tq, Sq - q0)
                qs = [(q0 + r // g, hk * g + r % g) for r in range(nq * g)]
                qm = np.stack([q[b, i, h] for i, h in qs]) * D ** -0.5
                kbeg = max(0, q0 - window + 1) if window else 0
                kbeg = kbeg // tile_k * tile_k
                kend = min(Skv, q0 + nq) if causal else Skv

                def scores(k0):
                    kk = k[b, k0:k0 + tile_k, hk]
                    s = qm @ kk.T
                    if cap:
                        s = cap * np.tanh(s / cap)
                    qi = np.array([i for i, _ in qs])[:, None]
                    dp = qi - np.arange(k0, k0 + kk.shape[0])[None, :]
                    ok = np.ones_like(dp, dtype=bool)
                    if causal:
                        ok &= dp >= 0
                    if window:
                        ok &= dp < window
                    return np.where(ok, s, neg)

                m = np.full(len(qs), neg)
                lsum = np.zeros(len(qs))
                for k0 in range(kbeg, kend, tile_k):
                    s = scores(k0)
                    m_new = np.maximum(m, s.max(axis=1))
                    lsum = lsum * np.exp(m - m_new) + np.exp(
                        s - m_new[:, None]).sum(axis=1)
                    m = m_new
                acc = np.zeros((len(qs), D))
                for k0 in range(kbeg, kend, tile_k):
                    p = np.exp(scores(k0) - m[:, None])
                    acc += p @ v[b, k0:k0 + tile_k, hk]
                o = acc / np.maximum(lsum, 1e-30)[:, None]
                for r, (i, h) in enumerate(qs):
                    out[b, i, h] = o[r]
    return out


# B, Sq, Skv, Hq, Hkv, D, causal, window, cap: g in {1, 4}, causal and
# not, window, cap, ragged and unequal Sq / Skv
WIDE_CASES = [
    (1, 24, 24, 4, 4, 320, True, None, None),
    (1, 20, 20, 8, 2, 512, True, 8, 50.0),
    (1, 16, 24, 4, 1, 320, False, None, 30.0),
    (2, 17, 17, 2, 2, 512, True, 5, None),
    (1, 70, 70, 4, 1, 320, False, 40, None),
]


@pytest.mark.parametrize("B,Sq,Skv,Hq,Hkv,D,causal,window,cap", WIDE_CASES)
def test_flash_attention_ref_wide_head_dim_matches_jax(B, Sq, Skv, Hq, Hkv,
                                                       D, causal, window,
                                                       cap):
    rng = np.random.default_rng(Sq * 7 + D)
    q = rng.normal(size=(B, Sq, Hq, D)).astype(np.float32)
    k = rng.normal(size=(B, Skv, Hkv, D)).astype(np.float32)
    v = rng.normal(size=(B, Skv, Hkv, D)).astype(np.float32)
    got = ref.flash_attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), causal, window, cap,
                                  kv_chunk=8).numpy()
    pallas = flash_attention_pallas(jnp.array(q), jnp.array(k), jnp.array(v),
                                    causal=causal, window=window,
                                    score_cap=cap, tile_q=8, tile_k=8,
                                    interpret=True)
    np.testing.assert_allclose(got, np.asarray(pallas), rtol=2e-3, atol=2e-3)
    wide = _k9_wide(q.astype(np.float64), k.astype(np.float64),
                    v.astype(np.float64), causal, window, cap)
    np.testing.assert_allclose(wide, got, rtol=1e-5, atol=1e-6)
