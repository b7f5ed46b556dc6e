"""The LM substrate's kernel plain versions and layers in the port
against the JAX package, on the CPU.

Plain K9 (``kernels.ref.flash_attention_ref``, the online softmax over KV
chunks) is held against the Pallas kernel in interpret mode and against
``repro.models.attention.flash_attention``, at the JAX test's tolerance
(rtol 2e-3, atol 2e-3: the Pallas kernel's tile order differs).  Plain
K10 (``kernels.ref.mamba_scan_ref``, the time-ordered recurrence) and the
port's chunked scan are held against ``mamba_scan_pallas`` in interpret
mode and ``repro.models.mamba._chunked_selective_scan`` at
``tests/test_mamba.py``'s tolerance (rtol 1e-3, atol 1e-4).  Inputs are
numpy arrays made from a seed and given to both packages.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention_pallas
from repro.kernels.mamba_scan import mamba_scan_pallas
from repro.models import attention as j_attention
from repro.models import layers as j_layers
from repro.models import mamba as j_mamba
from repro_torch.kernels import _build, ops, ref
from repro_torch.models import layers, mamba


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


# the five shapes of tests/test_kernels.py::test_flash_attention_kernel,
# then gemma2-2b's geometry (D = 256, g = 2, cap 50, window), ragged S
# with a window smaller than S, and Sq != Skv
FLASH_CASES = [
    (2, 32, 32, 4, 2, 8, True, None, None),
    (1, 48, 48, 6, 1, 8, True, None, None),
    (2, 33, 33, 4, 4, 8, False, None, None),
    (1, 64, 64, 2, 2, 8, True, 16, None),
    (1, 32, 32, 2, 2, 8, True, None, 30.0),
    (1, 40, 40, 4, 2, 256, True, 16, 50.0),
    (2, 37, 37, 4, 2, 16, True, 5, None),
    (1, 20, 33, 4, 2, 16, False, None, 30.0),
]


@pytest.mark.parametrize("B,Sq,Skv,Hq,Hkv,D,causal,window,cap", FLASH_CASES)
def test_flash_attention_ref_matches_jax(B, Sq, Skv, Hq, Hkv, D, causal,
                                         window, cap):
    rng = np.random.default_rng(Sq * 100 + D)
    q = rng.normal(size=(B, Sq, Hq, D)).astype(np.float32)
    k = rng.normal(size=(B, Skv, Hkv, D)).astype(np.float32)
    v = rng.normal(size=(B, Skv, Hkv, D)).astype(np.float32)
    got = ref.flash_attention_ref(_t(q), _t(k), _t(v), causal, window, cap,
                                  kv_chunk=8).numpy()
    pallas = flash_attention_pallas(jnp.array(q), jnp.array(k), jnp.array(v),
                                    causal=causal, window=window,
                                    score_cap=cap, tile_q=8, tile_k=8,
                                    interpret=True)
    np.testing.assert_allclose(got, np.asarray(pallas), rtol=2e-3, atol=2e-3)
    pq = jnp.broadcast_to(jnp.arange(Sq)[None], (B, Sq))
    pk = jnp.broadcast_to(jnp.arange(Skv)[None], (B, Skv))
    chunked = j_attention.flash_attention(
        jnp.array(q), jnp.array(k), jnp.array(v), pq, pk, causal=causal,
        window=window, score_cap=cap, kv_chunk=8)
    np.testing.assert_allclose(got, np.asarray(chunked), rtol=2e-3,
                               atol=2e-3)


@pytest.mark.parametrize("window", [None, 4])
def test_flash_attention_over_a_cache_matches_jax(window):
    """Explicit positions and a valid mask (a prefill into a longer cache
    and a decode step), as ``attn_apply`` calls it."""
    rng = np.random.default_rng(3)
    B, Hq, Hkv, D, Smax = 2, 4, 2, 16, 20
    for S, start in ((12, 0), (1, 12)):
        q = rng.normal(size=(B, S, Hq, D)).astype(np.float32)
        k = rng.normal(size=(B, Smax, Hkv, D)).astype(np.float32)
        v = rng.normal(size=(B, Smax, Hkv, D)).astype(np.float32)
        q_pos = np.broadcast_to(np.arange(start, start + S)[None], (B, S))
        kv_pos = np.broadcast_to(np.arange(Smax)[None], (B, Smax))
        valid = np.broadcast_to((np.arange(Smax) < start + S)[None],
                                (B, Smax))
        got = ref.flash_attention_ref(
            _t(q), _t(k), _t(v), True, window, 30.0, q_pos=_t(q_pos),
            kv_pos=_t(kv_pos), kv_valid=_t(valid), kv_chunk=8).numpy()
        want = j_attention.flash_attention(
            jnp.array(q), jnp.array(k), jnp.array(v), jnp.array(q_pos),
            jnp.array(kv_pos), window=window, score_cap=30.0,
            kv_valid=jnp.array(valid), kv_chunk=8)
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5,
                                   atol=1e-6)



# ---- K9's bf16 form (csrc/flash_attention.cu, flash_fwd_wgmma), emulated
# Only a card runs it; on the CPU, _k9_tensor_core repeats its
# arithmetic in f32 torch -- blocks of 128 folded rows, key tiles of 64
# (zero-filled past Skv), tiles outside the causal wedge or the window
# skipped, S = Q K^T from the bf16 inputs with the scale applied after the
# product, the cap as 1 - 2 / (1 + 2^(2 y log2 e)), masked scores at the
# finite _NEG, the online softmax with l summing the f32 P, and P rounded
# to bf16 for the PV product -- and is held against the Pallas kernel in
# interpret mode on the same bf16 inputs at K9's bf16 tolerance.

_LOG2E = 1.4426950408889634
_NEG = -2.3819763e38


def _k9_tensor_core(q, k, v, causal, window, cap):
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    g = Hq // Hkv
    tq = 128 // g
    pad = (-Skv) % 64
    kf = torch.nn.functional.pad(k.float(), (0, 0, 0, 0, 0, pad))
    vf = torch.nn.functional.pad(v.float(), (0, 0, 0, 0, 0, pad))
    out = torch.zeros(B, Sq, Hq, D)
    for b in range(B):
        for hk in range(Hkv):
            for q0 in range(0, Sq, tq):
                nq = min(tq, Sq - q0)
                Q = q[b, q0:q0 + nq, hk * g:(hk + 1) * g].float()
                Q = Q.reshape(nq * g, D)
                qi = torch.arange(q0, q0 + nq).repeat_interleave(g)
                kbeg, kend = 0, Skv
                if causal:
                    kend = min(Skv, q0 + nq)
                if window is not None:
                    kbeg = max(0, q0 - window + 1)
                m = torch.full((nq * g,), _NEG)
                l = torch.zeros(nq * g)
                acc = torch.zeros(nq * g, D)
                for k0 in range(kbeg // 64 * 64, kend, 64):
                    kj = torch.arange(k0, k0 + 64)
                    s = (Q @ kf[b, k0:k0 + 64, hk].T) * D ** -0.5
                    if cap is not None:
                        s = cap * (1 - 2 / (1 + torch.exp2(
                            s * (2 * _LOG2E / cap))))
                    ok = (kj < Skv)[None, :].expand(nq * g, 64)
                    if causal:
                        ok = ok & (kj[None, :] <= qi[:, None])
                    if window is not None:
                        ok = ok & (qi[:, None] - kj[None, :] < window)
                    s = torch.where(ok, s, torch.tensor(_NEG))
                    mx = torch.maximum(m, s.amax(1))
                    alpha = torch.exp2((m - mx) * _LOG2E)
                    p = torch.exp2((s - mx[:, None]) * _LOG2E)
                    l = l * alpha + p.sum(1)
                    acc = (acc * alpha[:, None]
                           + p.bfloat16().float() @ vf[b, k0:k0 + 64, hk])
                    m = mx
                o = acc / l.clamp_min(1e-30)[:, None]
                out[b, q0:q0 + nq, hk * g:(hk + 1) * g] = o.reshape(nq, g, D)
    return out.bfloat16()


# gemma2-2b's geometry (D = 256, g = 2, cap 50, a window, several query
# blocks and key tiles), g = 8 at D = 96 with ragged S and a cap, and
# g = 1 at D = 64 without the causal mask, Sq != Skv
K9_TC_CASES = [
    (1, 200, 200, 4, 2, 256, True, 96, 50.0),
    (2, 33, 33, 16, 2, 96, True, None, 30.0),
    (1, 70, 150, 2, 2, 64, False, None, None),
    (1, 130, 130, 8, 4, 128, True, None, None),
]


@pytest.mark.parametrize("B,Sq,Skv,Hq,Hkv,D,causal,window,cap", K9_TC_CASES)
def test_k9_tensor_core_arithmetic_matches_pallas(B, Sq, Skv, Hq, Hkv, D,
                                                  causal, window, cap):
    rng = np.random.default_rng(Sq + D)
    q, k, v = (rng.normal(size=shape).astype(np.float32) for shape in
               ((B, Sq, Hq, D), (B, Skv, Hkv, D), (B, Skv, Hkv, D)))
    qb, kb, vb = (_t(x).bfloat16() for x in (q, k, v))
    got = _k9_tensor_core(qb, kb, vb, causal, window, cap).float().numpy()
    pallas = flash_attention_pallas(
        *(jnp.array(x.float().numpy(), dtype=jnp.bfloat16)
          for x in (qb, kb, vb)),
        causal=causal, window=window, score_cap=cap, tile_q=32, tile_k=32,
        interpret=True)
    np.testing.assert_allclose(got, np.asarray(pallas, dtype=np.float32),
                               rtol=1e-2, atol=1e-2)
    # the plain version, in f32 with f32 P, within the same tolerance
    plain = ref.flash_attention_ref(qb, kb, vb, causal, window, cap)
    np.testing.assert_allclose(got, plain.float().numpy(), rtol=1e-2,
                               atol=1e-2)


# S and C are multiples of no tile; h0 is nonzero
SCAN_CASES = [(2, 37, 70, 4, 16, 8), (1, 33, 6, 4, 4, 16),
              (2, 50, 33, 16, 8, 16), (3, 9, 12, 8, 12, 8)]


def _scan_inputs(B, S, C, N, seed):
    rng = np.random.default_rng(seed)
    delta = np.abs(rng.normal(size=(B, S, C))).astype(np.float32)
    u = rng.normal(size=(B, S, C)).astype(np.float32)
    A = -np.abs(rng.normal(size=(C, N))).astype(np.float32)
    Bm = rng.normal(size=(B, S, N)).astype(np.float32)
    Cm = rng.normal(size=(B, S, N)).astype(np.float32)
    h0 = rng.normal(size=(B, C, N)).astype(np.float32)
    return delta, u, A, Bm, Cm, h0


@pytest.mark.parametrize("B,S,C,N,tc,ts", SCAN_CASES)
def test_mamba_scan_ref_matches_jax(B, S, C, N, tc, ts):
    args = _scan_inputs(B, S, C, N, S + C)
    y, h = ref.mamba_scan_ref(*map(_t, args))
    jargs = [jnp.array(a) for a in args]
    py, ph = mamba_scan_pallas(*jargs, tile_c=tc, tile_s=ts, interpret=True)
    cy, ch = j_mamba._chunked_selective_scan(*jargs, chunk=8)
    for want_y, want_h in ((py, ph), (cy, ch)):
        np.testing.assert_allclose(y.numpy(), np.asarray(want_y), rtol=1e-3,
                                   atol=1e-4)
        np.testing.assert_allclose(h.numpy(), np.asarray(want_h), rtol=1e-3,
                                   atol=1e-4)


@pytest.mark.parametrize("chunk", [1, 5, 8, 64])
def test_chunked_selective_scan_matches_jax_and_the_recurrence(chunk):
    args = _scan_inputs(2, 37, 10, 4, chunk)
    y, h = mamba._chunked_selective_scan(*map(_t, args), chunk=chunk)
    jy, jh = j_mamba._chunked_selective_scan(*[jnp.array(a) for a in args],
                                             chunk=chunk)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-3,
                               atol=1e-4)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), rtol=1e-3,
                               atol=1e-4)
    ry, rh = ref.mamba_scan_ref(*map(_t, args))
    torch.testing.assert_close(y, ry, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(h, rh, rtol=1e-4, atol=1e-5)


def test_lm_ops_on_cpu_run_the_plain_versions_and_count_calls():
    _build.reset_counts()
    for name in ops.OP_CALLS:
        ops.OP_CALLS[name] = 0
    rng = np.random.default_rng(0)
    q = _t(rng.normal(size=(1, 9, 4, 8)).astype(np.float32))
    k = _t(rng.normal(size=(1, 9, 2, 8)).astype(np.float32))
    out = ops.flash_attention_op(q, k, k, True, 4, 20.0)
    assert torch.equal(out, ref.flash_attention_ref(q, k, k, True, 4, 20.0))
    args = list(map(_t, _scan_inputs(1, 7, 5, 4, 1)))
    y, h = ops.mamba_scan_op(*args)
    ry, rh = ref.mamba_scan_ref(*args)
    assert torch.equal(y, ry) and torch.equal(h, rh)
    assert ops.OP_CALLS == {"flash_attention": 1, "mamba_scan": 1}
    assert sum(_build.counts().values()) == 0        # no kernel launched


def test_lm_kernel_wrappers_refuse_cpu_tensors():
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.mamba_scan import mamba_scan_cuda

    x = torch.zeros(1, 4, 2, 8)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_cuda(x, x, x)
    args = list(map(_t, _scan_inputs(1, 3, 2, 4, 0)))
    with pytest.raises(ValueError, match="CUDA"):
        mamba_scan_cuda(*args)


def test_layers_match_jax():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 7, 4, 16)).astype(np.float32)
    pos = np.broadcast_to(np.arange(3, 10)[None], (2, 7)).astype(np.int32)
    np.testing.assert_allclose(
        layers.apply_rope(_t(x), _t(pos), 1e4).numpy(),
        np.asarray(j_layers.apply_rope(jnp.array(x), jnp.array(pos), 1e4)),
        rtol=1e-5, atol=1e-5)
    h = rng.normal(size=(2, 7, 16)).astype(np.float32)
    scale = rng.normal(size=(16,)).astype(np.float32)
    np.testing.assert_allclose(
        layers.rms_norm(_t(h), _t(scale), 1e-5).numpy(),
        np.asarray(j_layers.rms_norm(jnp.array(h), jnp.array(scale), 1e-5)),
        rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        layers.softcap(_t(h) * 40, 30.0).numpy(),
        np.asarray(j_layers.softcap(jnp.array(h) * 40, 30.0)),
        rtol=1e-5, atol=1e-5)
    for act in ("gelu", "silu"):
        p = {"wi": rng.normal(size=(16, 24)).astype(np.float32),
             "wo": rng.normal(size=(24, 16)).astype(np.float32)}
        if act == "silu":
            p["wg"] = rng.normal(size=(16, 24)).astype(np.float32)
        got = layers.mlp_apply({k: _t(a) for k, a in p.items()}, _t(h), act)
        want = j_layers.mlp_apply({k: jnp.array(a) for k, a in p.items()},
                                  jnp.array(h), act)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-4)


def test_causal_conv_with_a_cache_tail_matches_jax():
    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, 9, 5)).astype(np.float32)
    w = rng.normal(size=(4, 5)).astype(np.float32)
    b = rng.normal(size=(5,)).astype(np.float32)
    prev = rng.normal(size=(2, 3, 5)).astype(np.float32)
    for pv in (None, prev):
        got = mamba._causal_conv(_t(x), _t(w), _t(b),
                                 None if pv is None else _t(pv))
        want = j_mamba._causal_conv(jnp.array(x), jnp.array(w), jnp.array(b),
                                    None if pv is None else jnp.array(pv))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-6)
