"""The on-card schedules of K4's warp form (csrc/dtw_band.cu) and of K10
(csrc/mamba_scan.cu), emulated step by step on the CPU and held bit-equal
to the plain versions the kernels are held to on the card
(``ref.dtw_band_ref``, ``ref.mamba_scan_ref``), as
``tests/test_torch_long.py`` emulates K5's on-chip forms.  No card is
needed; ``tests/test_torch_gpu.py`` runs the kernels themselves.

- K4 warp form: lane l owns band slots ``[l M, l M + M)``; the anti-
  diagonal loop runs in even/odd pairs, each step updating one parity of
  slots with one neighbour taken from the next lane (the shuffle);
  corner steps write only the slots in ``[k_lo(d), k_hi(d)]`` and track
  the minimum of what they wrote, interior steps every slot up to 2 wb;
  the frontier at a check is the xor-butterfly warp minimum of the lanes'
  slots (interior) or of their tracked minima (corners).  Equal to the
  plain version exactly, with cutoffs, -inf slots and row blocks, and for
  K6's per-step form.
- K10: a group of G lanes per (batch row, channel), lane k holding the
  8 consecutive states from ``8 k``; the group is skewed one step a
  lane, and lane k adds its 8 products, in n order, onto the running sum
  of the step that lane k - 1 passed it (the shuffle) -- so y[t] is the
  plain version's n-ordered sum.  Equal to the plain version exactly for
  N in {1, 15, 16, 17, 48, 64, 65, 256}.  The ``exp`` values are the
  plain version's own (the kernel and the plain version agree on
  ``expf`` on the card; here the point is the order of the products and
  sums).
"""

import numpy as np
import pytest
import torch

from repro_torch.core.dtw import _band_width, row_block_policy
from repro_torch.kernels import ref
from repro_torch.kernels.dtw_band import K4_WARP_MAX_WB, k4_form
from repro_torch.kernels.mamba_scan import MAX_STATE

INF = np.float32(np.inf)


def _lanes_m(wb):
    """The kernel's slots per lane: the fewest of 2, 4, 8, 16 whose 32
    lanes hold the 2 wb + 1 slots."""
    return next(m for m in (2, 4, 8, 16) if 32 * m >= 2 * wb + 1)


def _warp_min(v):
    """The kernel's xor butterfly over the 32 lanes (last axis)."""
    lane = np.arange(32)
    for o in (16, 8, 4, 2, 1):
        v = np.minimum(v, v[..., lane ^ o])
    assert (v == v[..., :1]).all()
    return v[..., 0]


def _k4_warp(a, b, w, cutoff, row_block=None, per_step=False):
    """K4's (``per_step``: K6's) warp form on (P, L) pairs, vectorised
    over pairs; returns (P,) float32."""
    P, L = a.shape
    wb = _band_width(L, w)
    M = _lanes_m(wb)
    D, last = 2 * L - 1, 2 * L - 2
    R = row_block if row_block is not None else row_block_policy(L)
    R = max(1, min(R, D))
    cut = np.broadcast_to(np.asarray(cutoff, np.float32), (P,)).copy()
    lane = np.arange(32)
    base = lane * M
    lim = 2 * wb - base
    s = np.full((P, 32, M), INF, np.float32)
    s[:, wb // M, wb % M] = 0                 # the path's origin, S_{-2}
    f = np.full((2, P, 32), INF, np.float32)
    done = cut == -np.inf if not per_step else np.zeros(P, bool)
    out = np.full(P, INF, np.float32)
    alive = ~done
    check_at = min(R - 1, D - 1)
    d0 = -(wb & 1)
    i0 = (d0 + base - wb) >> 1                # the two lane pointers
    j0 = (d0 - base + wb) >> 1

    def step(par, d, i0, j0):
        if par == 0:                          # __shfl_up_sync by one
            nb = np.concatenate([np.full((P, 1), INF, np.float32),
                                 s[:, :-1, M - 1]], axis=1)
        else:                                 # __shfl_down_sync by one
            nb = np.concatenate([s[:, 1:, 0],
                                 np.full((P, 1), INF, np.float32)], axis=1)
        edge = d < wb or d >= last - wb
        lo = np.zeros(32, int)
        hi = lim
        if edge:
            lo = max(0, wb - d, d + wb - last) - base
            hi = np.minimum(lim, min(d + wb, last - d + wb) - base)
        fm = np.full((P, 32), INF, np.float32)
        for t in range(M // 2):
            m = par + 2 * t
            ok = (m >= lo) & (m <= hi)
            left = nb if m == 0 else s[:, :, m - 1]
            right = nb if m == M - 1 else s[:, :, m + 1]
            best = np.minimum(np.minimum(left, right), s[:, :, m])
            ia = np.clip(i0 + par + t, 0, L - 1)
            jb = np.clip(j0 - t, 0, L - 1)
            diff = a[:, ia] - b[:, jb]
            nd = (diff * diff + best).astype(np.float32)
            s[:, :, m] = np.where(ok, nd, s[:, :, m])
            fm = np.where(ok, np.minimum(fm, nd), fm)
        if edge:
            f[par] = fm

    def dead_after(e):
        nonlocal check_at
        if not per_step:
            if e != check_at:
                return np.zeros(P, bool)
            check_at = min(check_at + R, D - 1)
        v = np.minimum(f[0], f[1])
        if wb <= e <= last - wb:
            v = s.min(axis=2)
        dead = _warp_min(v) > cut
        if per_step:
            s[dead] = INF
            f[:, dead] = INF
            return np.zeros(P, bool)
        return dead

    for d in range(d0, D, 2):
        for par, e in ((0, d), (1, d + 1)):
            if 0 <= e < D:
                step(par, e, i0, j0)
                alive &= ~dead_after(e)
        i0, j0 = i0 + 1, j0 + 1
    owner = s[:, wb // M, wb % M]
    return np.where(alive, owner, out)


def _pairs(seed, P, L):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(P, L)).astype(np.float32),
            rng.normal(size=(P, L)).astype(np.float32))


# (P, L, w, row_block): the GPU sweep's shapes, odd and even wb, and wb at
# each M's edge and at the warp form's edge (255 | 256 is the slots form)
K4_CASES = [
    (7, 33, 0, None), (7, 33, 1, None), (7, 33, 8, 7), (5, 33, 33, None),
    (6, 100, 25, None), (3, 1, 0, None), (4, 2, 5, None),
    (4, 64, 31, 5), (4, 65, 32, None), (3, 130, 63, None),
    (3, 130, 64, 9), (2, 260, 127, None), (2, 260, 128, None),
    (2, 300, 255, None), (2, 256, 300, 16), (3, 513, 51, None),
]


@pytest.mark.parametrize("P,L,w,row_block", K4_CASES)
def test_k4_warp_schedule_bit_equal_to_the_plain_version(P, L, w,
                                                         row_block):
    a, b = _pairs(P * 1000 + L, P, L)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    assert k4_form(L, w) == "warp" and _band_width(L, w) <= K4_WARP_MAX_WB
    exact = ref.dtw_band_ref(ta, tb, w)
    np.testing.assert_array_equal(_k4_warp(a, b, w, np.inf), exact.numpy())
    # cutoffs that kill some pairs, and an invalid (-inf) slot
    rng = np.random.default_rng(L)
    cut = (exact.numpy() * (0.5 + rng.random(P))).astype(np.float32)
    cut[0] = -np.inf
    want = ref.dtw_band_ref(ta, tb, w, torch.from_numpy(cut),
                            row_block=row_block)
    got = _k4_warp(a, b, w, cut, row_block)
    np.testing.assert_array_equal(got, want.numpy())
    assert np.isposinf(got[0])
    # K6: the same schedule with a check and poisoning every step
    step = _k4_warp(a, b, w, cut, per_step=True)
    np.testing.assert_array_equal(
        step, ref.dtw_band_ref(ta, tb, w, torch.from_numpy(cut),
                               row_block=1).numpy())


def test_k4_form_edge():
    """The warp form takes bands of up to 2 * 255 + 1 = 511 slots, 16 a
    lane; wider bands go to the slots form."""
    assert K4_WARP_MAX_WB == 255
    assert k4_form(1000, 255) == "warp" and k4_form(1000, 256) == "slots"
    assert k4_form(200, 1000) == "warp"       # wb = L - 1 = 199
    assert k4_form(512, 51) == "warp" and _lanes_m(51) == 4
    assert _lanes_m(154) == 16 and _lanes_m(31) == 2 and _lanes_m(32) == 4


def _k10_geometry(N):
    """The kernel's (G lanes a group, NS states a lane) for N states: 8
    states a lane, G = N / 8 rounded up to a power of two."""
    G = next(g for g in (1, 2, 4, 8, 16, 32) if 8 * g >= N)
    return G, 8


def _k10_schedule(delta, u, A, Bm, Cm, h0):
    """K10's skewed group schedule on CPU tensors."""
    Bsz, S, C = delta.shape
    N = A.shape[1]
    G, NS = _k10_geometry(N)
    Np = G * NS
    # the plain version's exp values, per step, padded with exp(0 A) = 1
    E = torch.ones((S, Bsz, C, Np))
    for t in range(S):
        E[t, :, :, :N] = torch.exp(delta[:, t][:, :, None] * A)
    du = delta * u
    Bp = torch.zeros((Bsz, S, Np))
    Cp = torch.zeros((Bsz, S, Np))
    Bp[:, :, :N], Cp[:, :, :N] = Bm, Cm
    h = torch.zeros((Bsz, C, Np))
    h[:, :, :N] = h0
    y = torch.full((Bsz, S, C), float("nan"))
    acc = torch.zeros((Bsz, C, G))               # lane k's running sum
    for s in range(S + G - 1):
        prev = acc.clone()                       # __shfl_up_sync by one
        acc[:, :, 1:] = prev[:, :, :-1]
        acc[:, :, 0] = 0
        for k in range(G):
            t = s - k
            if not 0 <= t < S:
                continue
            for n in range(k * NS, k * NS + NS):
                h[:, :, n] = (E[t][:, :, n] * h[:, :, n]
                              + du[:, t] * Bp[:, t, None, n])
                acc[:, :, k] = acc[:, :, k] + h[:, :, n] * Cp[:, t, None, n]
            if k == G - 1:
                y[:, t] = acc[:, :, k]
    return y, h[:, :, :N]


@pytest.mark.parametrize("N", [1, 15, 16, 17, 48, 64, 65, 256])
def test_k10_lane_split_schedule_bit_equal_to_the_plain_version(N):
    assert N <= MAX_STATE
    g = torch.Generator().manual_seed(N)
    Bsz, S, C = 2, 37, 5
    delta = torch.rand(Bsz, S, C, generator=g) * 0.1
    u = torch.randn(Bsz, S, C, generator=g)
    A = -torch.rand(C, N, generator=g) * 3
    Bm, Cm = (torch.randn(Bsz, S, N, generator=g) for _ in range(2))
    h0 = torch.randn(Bsz, C, N, generator=g)
    y, hT = _k10_schedule(delta, u, A, Bm, Cm, h0)
    ry, rh = ref.mamba_scan_ref(delta, u, A, Bm, Cm, h0)
    assert torch.equal(y, ry) and torch.equal(hT, rh)


def test_k10_state_limit():
    assert MAX_STATE == 256
