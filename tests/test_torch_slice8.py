"""K8's clamp form, K9's split-D wide form and K10's wide-state form,
emulated on the CPU and held against the JAX package and the port's plain
versions.

- K8 (csrc/lb_keogh.cu): a term ``d = q - min(max(q, lo), u)``, ``d * d``,
  is bit-equal to the reference's ``over^2 + under^2`` wherever
  ``lo <= u``, ties and infinite envelopes included (``torch.fmax`` /
  ``torch.fmin`` drop a NaN as CUDA's ``fmaxf`` / ``fminf`` do).  The
  kernel emulated block by block (128 x 64 output tiles, 32-column chunks,
  a chunk's vote on ``!(lo <= u)`` routing it to the reference's
  arithmetic, a partial per chunk) agrees with the plain version and with
  ``lb_keogh_pallas`` in interpret mode to rtol 1e-5, atol 1e-6 (its sum
  over L runs in another order), NaN where they have NaN; without the
  vote, ``lo > u`` and NaN envelopes give other values.
- K9's split-D f32-arithmetic form (csrc/flash_attention.cu,
  ``fw::flash_f32_kernel``, one cluster of ceil(D / 128) blocks)
  emulated in float32: partial scores per 128-column slice of D, summed
  in rank order, the cap, the masks and the online softmax over key tiles
  of 64, against ``flash_attention_pallas`` in interpret mode at D = 64
  (one block), 200 and 256 (two) and 320 and 512 to rtol 1e-4, atol 1e-5,
  and the port's ``flash_attention_op`` on the CPU beside them.
- K10: the port's ``mamba_scan_op`` on the CPU at N = 320 against
  ``mamba_scan_pallas`` in interpret mode (``tests/test_torch_lm_kernels
  .py``'s rtol 1e-3, atol 1e-4: XLA contracts the update into FMAs and
  its exp differs in the last bits), and the wide-state form's passes of
  256 states, each step's sum carried through y, bit-equal to
  ``ref.mamba_scan_ref``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention_pallas
from repro.kernels.lb_keogh import lb_keogh_pallas
from repro.kernels.mamba_scan import mamba_scan_pallas
from repro_torch.kernels import ops, ref

NEG = -2.3819763e38                     # the kernels' masked score


def _clamp_terms(q, u, lo):
    """K8's clamp form, term by term: ``(Q, 1, K) x (1, C, K)``."""
    d = q - torch.fmin(torch.fmax(q, lo), u)
    return d * d


def _ref_terms(q, u, lo):
    over = torch.clamp(q - u, min=0.0)
    under = torch.clamp(lo - q, min=0.0)
    return over * over + under * under


def _k8_kernel(q, u, lo, vote=True):
    """csrc/lb_keogh.cu emulated in float32: output tiles of 128 queries x
    64 candidates, L in chunks of 32 columns, each chunk's terms summed in
    column order into a partial added to the running sum; a chunk whose
    tile holds an envelope element with ``!(lo <= u)`` takes the
    reference's arithmetic (``vote=False``: never)."""
    Q, L = q.shape
    C = u.shape[0]
    out = torch.zeros((Q, C), dtype=torch.float32)
    for q0 in range(0, Q, 128):
        for c0 in range(0, C, 64):
            qt = q[q0:q0 + 128, None, :]
            ut, lt = u[None, c0:c0 + 64], lo[None, c0:c0 + 64]
            acc = torch.zeros((qt.shape[0], ut.shape[1]))
            for k0 in range(0, L, 32):
                ks = slice(k0, k0 + 32)
                bad = vote and bool((~(lt[..., ks] <= ut[..., ks])).any())
                terms = (_ref_terms if bad else _clamp_terms)(
                    qt[..., ks], ut[..., ks], lt[..., ks])
                part = torch.zeros_like(acc)
                for k in range(terms.shape[-1]):
                    part = part + terms[..., k]
                acc = acc + part
            out[q0:q0 + 128, c0:c0 + 64] = acc
    return out


def _close(got, want, rtol, atol):
    got, want = np.asarray(got), np.asarray(want)
    assert np.array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    np.testing.assert_allclose(got[ok], want[ok], rtol=rtol, atol=atol)


def test_k8_clamp_term_is_the_reference_term_where_lo_le_u():
    rng = np.random.default_rng(81)
    inf = np.float32(np.inf)
    # envelopes: random, ties (lo == u), zero width at 0 and -0, and
    # infinite bounds; queries at, between, above and below them
    los = list((rng.normal(size=40) * 10.0 ** rng.integers(
        -3, 4, size=40)).astype(np.float32))
    widths = list((np.abs(rng.normal(size=40))
                   * 10.0 ** rng.integers(-3, 3, size=40)).astype(np.float32))
    env = [(lo, lo + w) for lo, w in zip(los, widths)]
    env += [(np.float32(1.5), np.float32(1.5)), (np.float32(-0.0),
                                                 np.float32(0.0)),
            (-inf, inf), (-inf, np.float32(2.0)), (np.float32(-2.0), inf),
            (-inf, -inf), (inf, inf)]
    lo = np.array([e[0] for e in env], dtype=np.float32)
    u = np.array([e[1] for e in env], dtype=np.float32)
    assert (lo <= u).all()
    qs = np.concatenate([
        (rng.normal(size=200) * 10.0 ** rng.integers(
            -3, 4, size=200)).astype(np.float32),
        lo[np.isfinite(lo)], u[np.isfinite(u)],
        np.nextafter(u[np.isfinite(u)], np.float32(inf)),
        np.nextafter(lo[np.isfinite(lo)], np.float32(-inf)),
        np.float32([0.0, -0.0, 1.5])]).astype(np.float32)
    q_t = torch.from_numpy(qs)[:, None]
    u_t, lo_t = torch.from_numpy(u)[None], torch.from_numpy(lo)[None]
    got, want = _clamp_terms(q_t, u_t, lo_t), _ref_terms(q_t, u_t, lo_t)
    assert torch.isfinite(want).any() and (want > 0).any()
    assert torch.equal(torch.isinf(got), torch.isinf(want))
    assert torch.equal(got, want)          # bit for bit (-0 == 0)


def test_k8_vote_routes_bad_envelopes_to_the_reference_arithmetic():
    rng = np.random.default_rng(82)
    Q, C, L, w = 20, 70, 100, 5
    q = torch.from_numpy(rng.normal(size=(Q, L)).astype(np.float32))
    c = torch.from_numpy(rng.normal(size=(C, L)).astype(np.float32))
    u, lo = ref.envelope_ref(c, w)
    u, lo = u.clone(), lo.clone()
    u[3, 40:45] = lo[3, 40:45] - 2.0       # lo > u: both excesses count
    lo[66, 70] = float("nan")              # in the second candidate tile
    want = ref.lb_keogh_ref(q, u, lo)
    assert torch.isnan(want[:, 66]).all() and not torch.isnan(want[:, 3]).any()
    _close(_k8_kernel(q, u, lo), want, 1e-5, 1e-6)
    # without the vote the clamp form takes one excess of a lo > u term
    # and drops the NaN
    blind = _k8_kernel(q, u, lo, vote=False)
    assert not torch.isnan(blind).any()
    assert not torch.allclose(blind[:, 3], want[:, 3], rtol=1e-3)
    ok = torch.ones(C, dtype=torch.bool)
    ok[[3, 66]] = False
    _close(blind[:, ok], want[:, ok], 1e-5, 1e-6)


def test_k8_emulated_kernel_matches_jax_on_random_walks():
    """Two query tiles, two candidate tiles, a ragged last chunk and
    random walks of scale ~100; the port's ``lb_keogh_op`` beside it."""
    rng = np.random.default_rng(83)
    Q, C, L, w = 130, 70, 100, 7
    q = (rng.normal(size=(Q, L)).cumsum(1) * 10).astype(np.float32)
    c = (rng.normal(size=(C, L)).cumsum(1) * 10).astype(np.float32)
    u, lo = ref.envelope_ref(torch.from_numpy(c), w)
    want = np.asarray(lb_keogh_pallas(jnp.array(q), jnp.array(u.numpy()),
                                      jnp.array(lo.numpy()), interpret=True))
    assert np.abs(want).max() > 1e4
    qt = torch.from_numpy(q)
    _close(_k8_kernel(qt, u, lo), want, 1e-5, 1e-6)
    _close(ops.lb_keogh_op(qt, u, lo), want, 1e-5, 1e-6)


def _k9_split(q, k, v, causal, window, cap):
    """csrc/flash_attention.cu's f32-arithmetic form in float32: query tiles
    of 64 folded rows, key tiles of 64 from the first one a tile needs,
    partial scores over 128-column slices of D summed in rank order, the
    cap before the masks, the online softmax, l floored at 1e-30."""
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    g = Hq // Hkv
    tq = 64 // g
    qf = q.float() * D ** -0.5
    out = torch.empty_like(q)
    for b in range(B):
        for hk in range(Hkv):
            for q0 in range(0, Sq, tq):
                nq = min(tq, Sq - q0)
                qi = torch.arange(q0, q0 + nq).repeat_interleave(g)
                heads = torch.arange(hk * g, hk * g + g).repeat(nq)
                qr = qf[b, qi, heads]                       # (rows, D)
                m = torch.full((len(qi),), NEG)
                lsum = torch.zeros(len(qi))
                acc = torch.zeros(len(qi), D)
                kbeg = max(0, q0 - window + 1) if window else 0
                kend = min(Skv, q0 + nq) if causal else Skv
                for k0 in range(kbeg // 64 * 64, kend, 64):
                    kj = torch.arange(k0, min(k0 + 64, Skv))
                    kt, vt = k[b, kj, hk].float(), v[b, kj, hk].float()
                    s = qr[:, :128] @ kt[:, :128].T
                    for d0 in range(128, D, 128):
                        s = s + qr[:, d0:d0 + 128] @ kt[:, d0:d0 + 128].T
                    if cap:
                        s = cap * torch.tanh(s / cap)
                    dp = qi[:, None] - kj[None, :]
                    ok = torch.ones_like(dp, dtype=torch.bool)
                    if causal:
                        ok &= dp >= 0
                    if window:
                        ok &= dp < window
                    s = torch.where(ok, s, torch.tensor(NEG))
                    m_new = torch.maximum(m, s.max(dim=1).values)
                    p = torch.exp(s - m_new[:, None])
                    alpha = torch.exp(m - m_new)
                    lsum = lsum * alpha + p.sum(dim=1)
                    acc = acc * alpha[:, None] + p @ vt
                    m = m_new
                out[b, qi, heads] = (acc / torch.clamp(lsum, min=1e-30)[:,
                                                                       None]
                                     ).to(q.dtype)
    return out


@pytest.mark.parametrize("D,causal,window,cap", [(320, True, None, 50.0),
                                                 (512, True, 24, None),
                                                 (64, True, None, 30.0),
                                                 (200, False, None, 50.0),
                                                 (256, True, 24, None)])
def test_k9_split_d_wide_form_matches_jax(D, causal, window, cap):
    """One to four blocks of 128 columns (the last of D = 200 holds 72, of
    D = 320 64), g = 2, two query tiles (the second ragged) and a window
    that skips key tiles."""
    rng = np.random.default_rng(D)
    B, S, Hq, Hkv = 1, 70, 4, 2
    q = rng.normal(size=(B, S, Hq, D)).astype(np.float32)
    k = rng.normal(size=(B, S, Hkv, D)).astype(np.float32)
    v = rng.normal(size=(B, S, Hkv, D)).astype(np.float32)
    want = np.asarray(flash_attention_pallas(
        jnp.array(q), jnp.array(k), jnp.array(v), causal=causal,
        window=window, score_cap=cap, tile_q=8, tile_k=16, interpret=True))
    qt, kt, vt = (torch.from_numpy(x) for x in (q, k, v))
    np.testing.assert_allclose(_k9_split(qt, kt, vt, causal, window, cap),
                               want, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(
        ops.flash_attention_op(qt, kt, vt, causal, window, cap), want,
        rtol=1e-4, atol=1e-5)


def _scan_inputs(B, S, C, N, seed):
    rng = np.random.default_rng(seed)
    delta = (rng.random(size=(B, S, C)) * 0.1).astype(np.float32)
    u = rng.normal(size=(B, S, C)).astype(np.float32)
    A = (-rng.random(size=(C, N)) * 3).astype(np.float32)
    Bm = rng.normal(size=(B, S, N)).astype(np.float32)
    Cm = rng.normal(size=(B, S, N)).astype(np.float32)
    h0 = rng.normal(size=(B, C, N)).astype(np.float32)
    return delta, u, A, Bm, Cm, h0


def test_mamba_scan_op_past_256_states_matches_jax():
    args = _scan_inputs(2, 12, 6, 320, 84)
    calls = ops.OP_CALLS["mamba_scan"]
    y, h = ops.mamba_scan_op(*(torch.from_numpy(a) for a in args))
    assert ops.OP_CALLS["mamba_scan"] == calls + 1
    py, ph = mamba_scan_pallas(*(jnp.array(a) for a in args), tile_c=6,
                               tile_s=4, interpret=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(py), rtol=1e-3,
                               atol=1e-4)
    np.testing.assert_allclose(h.numpy(), np.asarray(ph), rtol=1e-3,
                               atol=1e-4)


def _k10_wide(delta, u, A, Bm, Cm, h0, per_pass=256):
    """csrc/mamba_scan.cu's wide-state form: one pass over the sequence
    per 256 states, each step's sum starting from y as the last pass left
    it; each product and sum rounded on its own."""
    Bsz, S, C = delta.shape
    N = A.shape[1]
    y = torch.zeros((Bsz, S, C))
    hT = torch.empty_like(h0)
    for nb in range(0, N, per_pass):
        ns = slice(nb, min(nb + per_pass, N))
        h = h0[:, :, ns].clone()
        for t in range(S):
            dt = delta[:, t]
            a = torch.exp(dt[:, :, None] * A[None, :, ns])
            h = a * h + (dt * u[:, t])[:, :, None] * Bm[:, t, None, ns]
            acc = y[:, t].clone()
            for n in range(h.shape[2]):
                acc = acc + h[:, :, n] * Cm[:, t, nb + n, None]
            y[:, t] = acc
        hT[:, :, ns] = h
    return y, hT


@pytest.mark.parametrize("N", [257, 600])
def test_k10_wide_state_passes_bit_equal_to_plain(N):
    args = [torch.from_numpy(a) for a in _scan_inputs(2, 9, 5, N, N)]
    y, h = _k10_wide(*args)
    ry, rh = ref.mamba_scan_ref(*args)
    assert torch.equal(y, ry) and torch.equal(h, rh)
