"""K9's f32-arithmetic form (csrc/flash_attention.cu,
``fw::flash_f32_kernel``), emulated on the CPU and held against the JAX
package and the port's plain version, and the choice of K9's form.

- The split of D: ``n_ch = ceil(D / 128)`` chunks, ``n_g = ceil(n_ch /
  16)`` column groups (the grid's z), ``n_c = ceil(n_ch / n_g)`` blocks a
  cluster; block r of group z owns output chunk ``z n_c + r`` (none past
  ``n_ch``) and sums partial scores over chunks ``r, r + n_c, ...`` in
  that order, the partials summed across the cluster in rank order.  Every
  chunk is owned once and scored once a group, and each score is computed
  ``n_g <= ceil(D / 1024)`` times.
- That partition emulated in float32 (query tiles of 64 folded rows, key
  tiles of 64, the cap before the masks, the online softmax, l floored at
  1e-30; each row's softmax, which the kernel runs on the row's owning
  block for the cluster, taken once), with every group's scores checked
  bit-equal to the others', at
  D = 1100 and 2048 (one cluster of 9 and of 16 blocks) and at D = 1100
  with clusters of at most 8 and 4 blocks (2 groups of 5, one block
  owning no columns, and 3 groups of 3: the form past D = 2048 at a size
  the CPU runs), against ``flash_attention_pallas`` in
  interpret mode and ``ref.flash_attention_ref`` to ``K9_TOL["float32"]``
  (rtol 1e-4, atol 1e-5).  Two JAX compilations (one Pallas call per head
  dim).
- ``k9_form`` over dtype x D: ``"bf16"`` only for bfloat16 up to
  ``MAX_HEAD_DIM``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention_pallas
from repro_torch.kernels import _build, ref
from repro_torch.kernels.flash_attention import MAX_HEAD_DIM, k9_form

NEG = -2.3819763e38                     # the kernels' masked score
DS, BK, ROWS = 128, 64, 64              # chunk columns, tile keys and rows


def _split(D, max_cluster=16):
    """``(n_ch, n_g, n_c)`` as ``fw::split_d``."""
    nch = -(-D // DS)
    ng = -(-nch // max_cluster)
    return nch, ng, -(-nch // ng)


def _score_chunks(rank, nc, nch):
    return list(range(rank, nch, nc))


def _k9_f32_form(q, k, v, causal, window, cap, max_cluster=16):
    """csrc/flash_attention.cu's f32-arithmetic form in float32, block by
    block: per (batch, kv head, query tile) each group's cluster sums its
    blocks' partial scores in rank order; the groups' scores must be
    bit-equal; each block accumulates its own output chunk."""
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    g = Hq // Hkv
    tq = ROWS // g
    nch, ng, nc = _split(D, max_cluster)
    qf = q.float() * D ** -0.5
    out = torch.full_like(q, float("nan"))
    for b in range(B):
        for hk in range(Hkv):
            for q0 in range(0, Sq, tq):
                nq = min(tq, Sq - q0)
                qi = torch.arange(q0, q0 + nq).repeat_interleave(g)
                heads = torch.arange(hk * g, hk * g + g).repeat(nq)
                qr = qf[b, qi, heads]                       # (rows, D)
                kbeg = max(0, q0 - window + 1) if window else 0
                kend = min(Skv, q0 + nq) if causal else Skv
                first = {}                  # group 0's scores by key tile
                for z in range(ng):
                    m = torch.full((len(qi),), NEG)
                    lsum = torch.zeros(len(qi))
                    acc = {}
                    for k0 in range(kbeg // BK * BK, kend, BK):
                        kj = torch.arange(k0, min(k0 + BK, Skv))
                        kt = k[b, kj, hk].float()
                        parts = []
                        for r in range(nc):
                            p = torch.zeros(len(qi), len(kj))
                            for c in _score_chunks(r, nc, nch):
                                cs = slice(c * DS, (c + 1) * DS)
                                p = p + qr[:, cs] @ kt[:, cs].T
                            parts.append(p)
                        s = parts[0]
                        for p in parts[1:]:
                            s = s + p
                        if cap:
                            s = cap * torch.tanh(s / cap)
                        dp = qi[:, None] - kj[None, :]
                        ok = torch.ones_like(dp, dtype=torch.bool)
                        if causal:
                            ok &= dp >= 0
                        if window:
                            ok &= dp < window
                        s = torch.where(ok, s, torch.tensor(NEG))
                        # every group computes the same scores
                        assert torch.equal(first.setdefault(k0, s), s)
                        m_new = torch.maximum(m, s.max(dim=1).values)
                        p = torch.exp(s - m_new[:, None])
                        alpha = torch.exp(m - m_new)
                        lsum = lsum * alpha + p.sum(dim=1)
                        m = m_new
                        for r in range(nc):
                            oc = z * nc + r
                            if oc >= nch:       # a block owning no columns
                                continue
                            cs = slice(oc * DS, (oc + 1) * DS)
                            vt = v[b, kj, hk, cs].float()
                            acc[oc] = (acc.get(oc, 0.0) * alpha[:, None]
                                       + p @ vt)
                    den = torch.clamp(lsum, min=1e-30)[:, None]
                    for oc, a in acc.items():
                        out[b, qi, heads, oc * DS:(oc + 1) * DS] = (
                            a / den).to(q.dtype)
    return out


@pytest.mark.parametrize("D", [64, 200, 256, 1100, 2048, 2100, 4100, 20000])
@pytest.mark.parametrize("max_cluster", [4, 8, 16])
def test_k9_split_covers_every_chunk(D, max_cluster):
    nch, ng, nc = _split(D, max_cluster)
    assert nc <= max_cluster and ng * nc >= nch
    owned = [z * nc + r for z in range(ng) for r in range(nc)
             if z * nc + r < nch]
    assert sorted(owned) == list(range(nch))
    scored = sorted(c for r in range(nc) for c in _score_chunks(r, nc, nch))
    assert scored == list(range(nch))
    # each score is computed once a group, ng times in all
    assert max(len(_score_chunks(r, nc, nch)) for r in range(nc)) == ng
    if max_cluster == 16:
        assert ng <= -(-D // 1024) and ng == -(-D // 2048)
        assert nc == {64: 1, 200: 2, 256: 2, 1100: 9, 2048: 16}.get(D, nc)


# B, Sq, Skv, Hq, Hkv, D, causal, window, cap
CASES = [(1, 40, 40, 4, 2, 1100, True, 24, 50.0),
         (1, 30, 45, 2, 1, 2048, False, None, None)]


@pytest.mark.parametrize("B,Sq,Skv,Hq,Hkv,D,causal,window,cap", CASES)
def test_k9_f32_form_partition_matches_jax(B, Sq, Skv, Hq, Hkv, D, causal,
                                           window, cap):
    rng = np.random.default_rng(D)
    q = rng.normal(size=(B, Sq, Hq, D)).astype(np.float32)
    k = rng.normal(size=(B, Skv, Hkv, D)).astype(np.float32)
    v = rng.normal(size=(B, Skv, Hkv, D)).astype(np.float32)
    want = np.asarray(flash_attention_pallas(
        jnp.array(q), jnp.array(k), jnp.array(v), causal=causal,
        window=window, score_cap=cap, tile_q=8, tile_k=16, interpret=True))
    qt, kt, vt = (torch.from_numpy(x) for x in (q, k, v))
    plain = ref.flash_attention_ref(qt, kt, vt, causal, window, cap)
    np.testing.assert_allclose(plain, want, rtol=1e-4, atol=1e-5)
    # one cluster over D; then, at D = 1100, 2 groups of 5 blocks and 3
    # of 3
    for max_cluster in (16, 8, 4) if D == 1100 else (16,):
        got = _k9_f32_form(qt, kt, vt, causal, window, cap, max_cluster)
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(got, plain, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [1, 64, 96, 100, 200, 256, 257, 1100, 4100])
def test_k9_form_by_dtype_and_head_dim(dtype, D):
    want = "bf16" if dtype == torch.bfloat16 and D <= 256 else "f32"
    assert MAX_HEAD_DIM == 256
    assert k9_form(dtype, D) == want


def test_k9_counts_and_entries_are_the_two_forms():
    assert {n for n in _build.COUNTS if n.startswith("flash")} == {
        "flash_attention", "flash_attention_f32"}
    assert {n for n in _build._SIGNATURES if n.startswith("flash")} == {
        "flash_attention_bf16_launch", "flash_attention_cuda_cores_launch",
        "flash_attention_cuda_cores_occupancy"}
