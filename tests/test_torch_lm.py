"""The port's LM serving slice against the JAX package, on the CPU.

Weights come from JAX ``LM.init(PRNGKey(0))`` through
``models.lm_params_from_numpy``.  The reduced gemma2-2b (window 8, so the
24-token prompts cross it; softcaps, GQA, tanh-GELU, tied embeddings) and
falcon-mamba-7b run with f32 compute and cache on both sides; the JAX
side routes through its Pallas kernels in interpret mode
(``attn_impl="pallas"``, ``ssm_impl="pallas"``), the port through its K9
and K10 ops (``"kernel"``), which run their plain versions on the CPU.

Tolerances: prefill logits and filled caches rtol 1e-4, atol 1e-4 (f32;
the softmax and scan sums run in other orders); greedy tokens equal; the
bf16 prefill at ``tests/test_serve.py``'s rtol 3e-2, atol 3e-2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCHS as J_ARCHS
from repro.configs.registry import reduced as j_reduced
from repro.models.model import LM as JLM
from repro.serve import greedy_decode as j_greedy_decode
from repro_torch.configs import ARCHS, reduced
from repro_torch.kernels import ops
from repro_torch.models import LM, lm_caches_from_numpy, lm_params_from_numpy
from repro_torch.serve import DecodeSession, greedy_decode

MODELS = ["gemma2-2b", "falcon-mamba-7b"]
B, S, STEPS = 2, 24, 4


def _jax_model(name, dtype=jnp.float32):
    return JLM(cfg=j_reduced(J_ARCHS[name]), remat=False,
               compute_dtype=dtype, cache_dtype=dtype, attn_impl="pallas",
               ssm_impl="pallas")


def _port_model(name, dtype=torch.float32, impl="kernel"):
    return LM(reduced(ARCHS[name]), compute_dtype=dtype, cache_dtype=dtype,
              attn_impl="kernel" if impl == "kernel" else "chunked",
              ssm_impl="kernel" if impl == "kernel" else "scan")


@pytest.fixture(scope="module")
def jax_params():
    return {name: _jax_model(name).init(jax.random.PRNGKey(0))
            for name in MODELS}


@pytest.fixture(scope="module")
def prompt():
    rng = np.random.default_rng(0)
    return rng.integers(0, 256, size=(B, S)).astype(np.int32)


def _port_params(name, jax_params):
    return lm_params_from_numpy(reduced(ARCHS[name]),
                                jax.tree.map(np.asarray, jax_params[name]),
                                device="cpu")


def _reset_calls():
    for name in ops.OP_CALLS:
        ops.OP_CALLS[name] = 0


@pytest.mark.parametrize("name", MODELS)
def test_prefill_logits_and_caches_match_jax(name, jax_params, prompt):
    jm = _jax_model(name)
    jl, jc, jidx = jax.jit(lambda p, b: jm.prefill(p, b))(
        jax_params[name], {"tokens": jnp.array(prompt)})
    params = _port_params(name, jax_params)
    logits, caches, idx = _port_model(name).prefill(
        params, {"tokens": torch.from_numpy(prompt)})
    assert idx == int(jidx) == S
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), rtol=1e-4,
                               atol=1e-4)
    want = lm_caches_from_numpy(reduced(ARCHS[name]),
                                jax.tree.map(np.asarray, jc), device="cpu")
    assert len(caches) == len(want) == reduced(ARCHS[name]).n_layers
    for got_c, want_c in zip(caches, want):
        assert set(got_c) == set(want_c)
        for key in got_c:
            np.testing.assert_allclose(got_c[key].numpy(),
                                       want_c[key].numpy(), rtol=1e-4,
                                       atol=1e-4)


@pytest.mark.parametrize("name", MODELS)
def test_greedy_decode_tokens_equal_jax(name, jax_params, prompt):
    want = j_greedy_decode(_jax_model(name), jax_params[name],
                           jnp.array(prompt), STEPS)
    got = greedy_decode(_port_model(name), _port_params(name, jax_params),
                        torch.from_numpy(prompt), STEPS)
    assert got.shape == (B, STEPS) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("name", MODELS)
def test_session_step_matches_full_cache_prefill(name, jax_params, prompt):
    """The first decoded step's logits equal a full-cache prefill of
    prompt + token (the property of tests/test_serve.py)."""
    model = _port_model(name)
    params = _port_params(name, jax_params)
    sess = DecodeSession(model, params, max_len=S + 1)
    tok = torch.argmax(sess.prefill({"tokens": torch.from_numpy(prompt)}),
                       -1)[:, None]
    step = sess.step(tok)
    full = torch.cat([torch.from_numpy(prompt).long(), tok], dim=1)
    want, _, _ = model.prefill(params, {"tokens": full})
    torch.testing.assert_close(step, want, rtol=1e-4, atol=1e-4)


def test_bf16_gemma2_prefill_matches_jax(jax_params, prompt):
    name = "gemma2-2b"
    jm = _jax_model(name, jnp.bfloat16)
    jl, _, _ = jax.jit(lambda p, b: jm.prefill(p, b))(
        jax_params[name], {"tokens": jnp.array(prompt)})
    logits, caches, _ = _port_model(name, torch.bfloat16).prefill(
        _port_params(name, jax_params), {"tokens": torch.from_numpy(prompt)})
    assert caches[0]["k"].dtype == torch.bfloat16
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), rtol=3e-2,
                               atol=3e-2)


@pytest.mark.parametrize("name,op", [("gemma2-2b", "flash_attention"),
                                     ("falcon-mamba-7b", "mamba_scan")])
def test_kernel_routing_read_from_op_calls(name, op, jax_params, prompt):
    """S > 1 under "kernel" calls the op once per layer; a decode step
    never does; greedy_decode's prefill (cache S + n) runs K9's op 0
    times and K10's once per layer; the plain impls never call it."""
    n_layers = reduced(ARCHS[name]).n_layers
    params = _port_params(name, jax_params)
    tokens = torch.from_numpy(prompt)
    model = _port_model(name)
    _reset_calls()
    _, caches, idx = model.prefill(params, {"tokens": tokens})
    assert ops.OP_CALLS[op] == n_layers
    _reset_calls()
    sess = DecodeSession(model, params, max_len=S + 2)
    sess.prefill({"tokens": tokens})
    prefill_calls = ops.OP_CALLS[op]
    sess.step(tokens[:, :1])
    assert ops.OP_CALLS[op] == prefill_calls
    _reset_calls()
    greedy_decode(model, params, tokens, 3)
    assert ops.OP_CALLS[op] == (0 if op == "flash_attention" else n_layers)
    assert prefill_calls == ops.OP_CALLS[op]
    _reset_calls()
    _port_model(name, impl="plain").prefill(params, {"tokens": tokens})
    assert sum(ops.OP_CALLS.values()) == 0


def test_params_unstack_into_layer_order(jax_params):
    """Layer i of the port is ``scan[i % 2][i // 2]`` of gemma2's period-2
    layout (local, global)."""
    name = "gemma2-2b"
    params = _port_params(name, jax_params)
    scan = jax_params[name]["scan"]
    for i, layer in enumerate(params["layers"]):
        want = np.asarray(scan[i % 2]["attn"]["wq"][i // 2])
        np.testing.assert_array_equal(layer["attn"]["wq"].numpy(), want)
    assert "head" not in params                      # tied embeddings


@pytest.mark.parametrize("name", MODELS)
def test_init_follows_the_jax_initialisers(name, jax_params):
    """Same tree, shapes and dtypes as the carried JAX parameters; the
    lecun matrices have variance ~1/fan_in and stay within two
    deviations; the Mamba constants are JAX's."""
    cfg = reduced(ARCHS[name])
    got = LM(cfg).init(torch.Generator().manual_seed(0), device="cpu")
    want = _port_params(name, jax_params)
    flat_got = jax.tree_util.tree_flatten_with_path(got)[0]
    flat_want = dict(jax.tree_util.tree_flatten_with_path(want)[0])
    assert len(flat_got) == len(flat_want)
    for path, t in flat_got:
        assert t.shape == flat_want[path].shape and t.dtype == torch.float32
    wo = got["layers"][0]["mlp" if name == "gemma2-2b" else "mamba"]
    w = wo["wo" if name == "gemma2-2b" else "out_proj"]
    bound = 2 * (1 / w.shape[0]) ** 0.5 / 0.87962566103423978
    assert w.abs().max() <= bound + 1e-6
    assert abs(w.var().item() * w.shape[0] - 1.0) < 0.1
    if name == "falcon-mamba-7b":
        m = got["layers"][0]["mamba"]
        # log(1..N): the two libraries' logs may differ in the last bit
        np.testing.assert_allclose(
            m["A_log"].numpy(), np.asarray(jax_params[name]["scan"][0]
                                           ["mamba"]["A_log"][0]),
            rtol=1e-6, atol=0)
        assert torch.all(m["dt_bias"] == -4.6) and torch.all(m["D"] == 1.0)


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without a card")
    with pytest.raises(RuntimeError, match="CUDA"):
        LM(reduced(ARCHS["gemma2-2b"])).init()


@pytest.mark.parametrize("batch", [1, 2])
@pytest.mark.parametrize("impl", ["kernel", "plain"])
def test_mamba_caches_own_their_storage(batch, impl, jax_params, prompt):
    """The state and conv tail a prefill leaves in the cache are copies:
    a view would keep a whole (B, T, C, N) scan chunk or the (B, S + 3,
    C) conv input alive per layer (tens of GB at falcon-mamba-7b's
    width)."""
    name = "falcon-mamba-7b"
    _, caches, _ = _port_model(name, impl=impl).prefill(
        _port_params(name, jax_params),
        {"tokens": torch.from_numpy(prompt[:batch])})
    for cache in caches:
        for t in cache.values():
            assert t.untyped_storage().nbytes() == t.numel() * t.element_size()
