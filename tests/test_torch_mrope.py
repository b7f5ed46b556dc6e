"""The port's M-RoPE, vision-prefix and audio-frame inputs against the JAX
package, on the CPU, and every configuration through the port's ``LM``.

``models.layers.apply_mrope`` against JAX's on random (B, 3, S) position
streams.  Reduced qwen2-vl-72b (GQA with ``qkv_bias``, M-RoPE sections
(2, 3, 3)) with ``vision_embeds`` over its first 4 positions and
Qwen2-VL-style streams (the patches of a 2 x 2 grid at t = 0, then text
at t = h = w from 2): a full-cache prefill (logits and caches) and a
``DecodeSession`` prefill into a longer cache followed by three steps.
Reduced hubert-xlarge (non-causal, frames in, ``in_norm``, an untied
head): a full-cache prefill, ``loss_fn`` and its gradients, and
``decode_step`` raising ``ValueError`` as JAX's does.  Weights are
carried from JAX ``LM.init`` by ``models.lm_params_from_numpy``; f32
compute and cache on both sides, the JAX side ``attn_impl="pallas"``
(interpret mode), the port's ``"kernel"`` route (the plain versions on
the CPU).  Every configuration of ``configs/`` constructs, initialises
in JAX's tree and shapes, and carries across at ``reduced()`` size.

Tolerances: ``apply_mrope`` rtol 1e-6, atol 1e-6 (the same f32 sin, cos
and products); logits, caches and step logits rtol 1e-4, atol 1e-4
(``tests/test_torch_lm.py``'s); the loss rtol 1e-5 and its gradients
rtol 1e-4, atol 1e-5 (``tests/test_torch_moe.py``'s).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCHS as J_ARCHS
from repro.configs.registry import reduced as j_reduced
from repro.models.layers import apply_mrope as j_apply_mrope
from repro.models.model import LM as JLM
from repro.serve import DecodeSession as JDecodeSession
from repro_torch.configs import ARCHS, reduced
from repro_torch.kernels import ops
from repro_torch.models import (LM, apply_mrope, lm_caches_from_numpy,
                                lm_params_from_numpy)
from repro_torch.models.layers import apply_rope
from repro_torch.serve import DecodeSession
from repro_torch.train.trainer import value_and_grad
from repro_torch.tree import tree_leaves

VLM, AUDIO = "qwen2-vl-72b", "hubert-xlarge"
B, S, STEPS = 2, 24, 3


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("sections,D", [((2, 3, 3), 16), ((16, 24, 24), 128),
                                        ((1, 0, 3), 8)])
def test_apply_mrope_matches_jax(sections, D):
    rng = np.random.default_rng(D)
    x = rng.normal(size=(2, 7, 3, D)).astype(np.float32)
    pos = rng.integers(0, 500, size=(2, 3, 7)).astype(np.int32)
    want = j_apply_mrope(jnp.array(x), jnp.array(pos), sections, 1e6)
    got = apply_mrope(torch.from_numpy(x), torch.from_numpy(pos), sections,
                      1e6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    # text tokens (t == h == w) rotate as 1-D RoPE
    same = np.broadcast_to(pos[:, :1], pos.shape).copy()
    torch.testing.assert_close(
        apply_mrope(torch.from_numpy(x), torch.from_numpy(same), sections),
        apply_rope(torch.from_numpy(x), torch.from_numpy(same[:, 0])),
        rtol=0, atol=0)
    with pytest.raises(ValueError, match="sum to D/2"):
        apply_mrope(torch.from_numpy(x), torch.from_numpy(pos), (1, 1, 1))


def _jax_model(name):
    return JLM(cfg=j_reduced(J_ARCHS[name]), remat=False,
               compute_dtype=jnp.float32, cache_dtype=jnp.float32,
               attn_impl="pallas", ssm_impl="pallas")


def _port_model(name):
    return LM(reduced(ARCHS[name]), compute_dtype=torch.float32,
              cache_dtype=torch.float32, attn_impl="kernel",
              ssm_impl="kernel")


@pytest.fixture(scope="module")
def jax_params():
    return {name: _jax_model(name).init(jax.random.PRNGKey(0))
            for name in (VLM, AUDIO)}


def _port_params(name, jax_params):
    return lm_params_from_numpy(reduced(ARCHS[name]), _np(jax_params[name]),
                                device="cpu")


def _vlm_batch():
    """Tokens, 4 patch embeddings over the first 4 positions, and the
    (B, 3, S) streams: patches of a 2 x 2 grid at t = 0, text after."""
    cfg = reduced(ARCHS[VLM])
    rng = np.random.default_rng(1)
    P = cfg.vision_prefix
    grid = int(P ** 0.5)
    t = np.concatenate([np.zeros(P), grid + np.arange(S - P)])
    h = np.concatenate([np.arange(P) // grid, grid + np.arange(S - P)])
    w = np.concatenate([np.arange(P) % grid, grid + np.arange(S - P)])
    pos = np.broadcast_to(np.stack([t, h, w])[None], (B, 3, S))
    return {
        "tokens": rng.integers(0, cfg.vocab, size=(B, S)).astype(np.int32),
        "vision_embeds": rng.normal(size=(B, P, cfg.d_model)).astype(
            np.float32),
        "positions": np.ascontiguousarray(pos).astype(np.int32)}


def _audio_batch():
    cfg = reduced(ARCHS[AUDIO])
    rng = np.random.default_rng(2)
    return {"frames": rng.normal(size=(B, S, cfg.d_model)).astype(np.float32),
            "labels": rng.integers(0, cfg.vocab, size=(B, S)).astype(
                np.int32)}


def _jnp(batch):
    return {k: jnp.array(v) for k, v in batch.items()}


def _assert_caches_close(name, caches, jc):
    want = lm_caches_from_numpy(reduced(ARCHS[name]), _np(jc), device="cpu")
    assert len(caches) == len(want)
    for got_c, want_c in zip(caches, want):
        assert set(got_c) == set(want_c)
        for key in got_c:
            np.testing.assert_allclose(got_c[key].numpy(),
                                       want_c[key].numpy(), rtol=1e-4,
                                       atol=1e-4)


@pytest.mark.parametrize("name", [VLM, AUDIO])
def test_full_cache_prefill_matches_jax(name, jax_params):
    """The prefill whose attention is K9's op in every layer."""
    batch = _vlm_batch() if name == VLM else {"frames": _audio_batch()[
        "frames"]}
    jm = _jax_model(name)
    jl, jc, _ = jax.jit(lambda p, b: jm.prefill(p, b))(jax_params[name],
                                                      _jnp(batch))
    for key in ops.OP_CALLS:
        ops.OP_CALLS[key] = 0
    logits, caches, idx = _port_model(name).prefill(
        _port_params(name, jax_params),
        {k: torch.from_numpy(v) for k, v in batch.items()})
    assert idx == S
    assert ops.OP_CALLS["flash_attention"] == reduced(ARCHS[name]).n_layers
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), rtol=1e-4,
                               atol=1e-4)
    _assert_caches_close(name, caches, jc)


def test_vlm_decode_session_matches_jax(jax_params):
    """A prefill into a cache of S + 3 (the plain attention, masks on the
    temporal stream) and three steps at M-RoPE positions (B, 3, 1) =
    the cache index, fed JAX's greedy tokens."""
    batch = _vlm_batch()
    jsess = JDecodeSession(_jax_model(VLM), jax_params[VLM], S + STEPS)
    sess = DecodeSession(_port_model(VLM), _port_params(VLM, jax_params),
                         S + STEPS)
    jl = jsess.prefill(_jnp(batch))
    tl = sess.prefill({k: torch.from_numpy(v) for k, v in batch.items()})
    for _ in range(STEPS):
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                                   atol=1e-4)
        tok = jnp.argmax(jl, -1)[:, None].astype(jnp.int32)
        jl = jsess.step(tok)
        tl = sess.step(torch.from_numpy(np.array(tok)))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                               atol=1e-4)
    assert sess.index == int(jsess.index) == S + STEPS
    _assert_caches_close(VLM, sess.caches, jsess.caches)


def test_audio_loss_fn_and_gradients_match_jax(jax_params):
    batch = _audio_batch()
    jm = _jax_model(AUDIO)
    (jloss, jmet), jg = jax.jit(jax.value_and_grad(
        lambda p, b: jm.loss_fn(p, b), has_aux=True))(jax_params[AUDIO],
                                                      _jnp(batch))
    (loss, met), grads = value_and_grad(_port_model(AUDIO),
                                        _port_params(AUDIO, jax_params),
                                        batch)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(met["ce"].item(), float(jmet["ce"]),
                               rtol=1e-5)
    assert met["aux"].item() == float(jmet["aux"]) == 0.0
    want = lm_params_from_numpy(reduced(ARCHS[AUDIO]), _np(jg), device="cpu")
    gl, wl = tree_leaves(grads), tree_leaves(want)
    assert len(gl) == len(wl)
    for g, w in zip(gl, wl):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-5)


def test_audio_has_no_decode_step(jax_params):
    with pytest.raises(ValueError, match="no decode step"):
        _jax_model(AUDIO).decode_step({}, {}, jnp.zeros((1, 1), jnp.int32),
                                      jnp.int32(0))
    with pytest.raises(ValueError, match="no decode step"):
        _port_model(AUDIO).decode_step({}, [], torch.zeros(1, 1), 0)
    params = _port_params(AUDIO, jax_params)
    assert "in_norm" in params and "head" in params and "embed" not in params


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_every_config_constructs_initialises_and_carries(name):
    """``LM(reduced(cfg)).init`` has the JAX ``LM.init`` tree (shapes from
    ``jax.eval_shape``, carried across by ``lm_params_from_numpy``), all
    f32, and runs a prefill of its inputs to finite logits."""
    cfg = reduced(ARCHS[name])
    shapes = jax.eval_shape(JLM(cfg=j_reduced(J_ARCHS[name])).init,
                            jax.random.PRNGKey(0))
    want = lm_params_from_numpy(
        cfg, jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes),
        device="cpu")
    model = LM(cfg, compute_dtype=torch.float32)
    got = model.init(torch.Generator().manual_seed(0), device="cpu")
    flat_got = jax.tree_util.tree_flatten_with_path(got)[0]
    flat_want = dict(jax.tree_util.tree_flatten_with_path(want)[0])
    assert len(flat_got) == len(flat_want)
    for path, t in flat_got:
        assert t.shape == flat_want[path].shape and t.dtype == torch.float32
    gen = torch.Generator().manual_seed(1)
    if cfg.embed_inputs:
        batch = {"tokens": torch.randint(0, cfg.vocab, (2, 8), generator=gen)}
    else:
        batch = {"frames": torch.randn(2, 8, cfg.d_model, generator=gen)}
    if cfg.vision_prefix:
        batch["vision_embeds"] = torch.randn(2, cfg.vision_prefix,
                                             cfg.d_model, generator=gen)
        batch["positions"] = torch.arange(8).expand(2, 3, 8)
    logits, _, _ = model.prefill(got, batch)
    assert logits.shape == (2, cfg.vocab) and torch.isfinite(logits).all()


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_init_in_a_compute_dtype_is_compute_params_of_init(name):
    """``LM.init(dtype=bfloat16)``, which casts each part as it is drawn
    (the card builds a served model so), is ``compute_params`` of the f32
    ``LM.init`` from the same generator seed, leaf for leaf and bit for
    bit."""
    model = LM(reduced(ARCHS[name]))
    want = model.compute_params(
        model.init(torch.Generator().manual_seed(3), device="cpu"))
    got = model.init(torch.Generator().manual_seed(3), device="cpu",
                     dtype=torch.bfloat16)
    flat_got = jax.tree_util.tree_flatten_with_path(got)[0]
    flat_want = jax.tree_util.tree_flatten_with_path(want)[0]
    assert [p for p, _ in flat_got] == [p for p, _ in flat_want]
    for (path, g), (_, w) in zip(flat_got, flat_want):
        assert g.dtype == w.dtype and torch.equal(g, w), path
    assert any(t.dtype == torch.bfloat16 for _, t in flat_got)
