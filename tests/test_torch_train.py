"""The port's training path against the JAX package, on the CPU.

Numpy inputs made from a seed go through both packages: the token
pipeline (bit-equal batches), gradient compression, AdamW and Adafactor,
checkpoints, K9's and K10's autograd Functions (the plain version
forward on a CPU tensor, the plain version's backward), the chunked
cross-entropy, and the train step on reduced gemma2-2b and
falcon-mamba-7b in f32 compute: the JAX side ``LM(remat=False,
attn_impl="pallas", ssm_impl="pallas")`` through ``make_train_step``
(Pallas in interpret mode, its ``custom_vjp`` backward), the port's
kernel route from the same JAX ``init_state`` carried across by
``models.train_state_from_numpy``.

Tolerances: batches bit-equal; compressed gradients bit-equal; the
optimizers rtol 1e-5, atol 1e-7 over three steps (their f32 scalars and
update order are the reference's; sums run in another order); the K9
Function's gradients rtol 2e-3, atol 2e-3 and K10's rtol 1e-3, atol 1e-4
(``tests/test_kernels.py``'s gradient tolerances); the cross-entropy's
value rtol 1e-5 and gradients rtol 1e-4, atol 1e-6; train-step losses
rtol 1e-4 and the state (parameters, optimizer moments, compression
error) rtol 1e-4, atol 1e-5 after three steps; with compression, all but
at most one element in a thousand of a leaf (see
``_assert_state_close``).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCHS as J_ARCHS
from repro.configs.registry import reduced as j_reduced
from repro.data.tokens import TokenPipeline as JTokenPipeline
from repro.distributed import CompressionConfig as JCompressionConfig
from repro.distributed import compress_grads as j_compress_grads
from repro.kernels.ops import flash_attention_op as j_flash_attention_op
from repro.kernels.ops import mamba_scan_op as j_mamba_scan_op
from repro.models.layers import chunked_cross_entropy as j_chunked_ce
from repro.models.model import LM as JLM
from repro.train import OptConfig as JOptConfig
from repro.train import init_state as j_init_state
from repro.train import make_train_step as j_make_train_step
from repro.train import opt_init as j_opt_init
from repro.train import opt_update as j_opt_update
from repro_torch.configs import ARCHS, reduced
from repro_torch.data import TokenPipeline
from repro_torch.distributed import CompressionConfig, compress_grads
from repro_torch.kernels import ops, ref
from repro_torch.models import LM, lm_params_from_numpy, train_state_from_numpy
from repro_torch.models.layers import chunked_cross_entropy
from repro_torch.models.mamba import _chunked_selective_scan
from repro_torch.train import (
    OptConfig,
    TrainState,
    init_state,
    latest_step,
    make_train_step,
    opt_init,
    opt_update,
    restore_checkpoint,
    save_checkpoint,
)
from repro_torch.train.optimizer import clip_by_global_norm
from repro_torch.train.trainer import reference_view, value_and_grad
from repro_torch.tree import Stacked, tree_leaves

MODELS = ["gemma2-2b", "falcon-mamba-7b"]
B, S, STEPS = 2, 24, 3
OPT = dict(lr=1e-3, warmup=2)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# token pipeline
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cursor", [0, 3, 17])
def test_token_batches_bit_equal_jax(cursor):
    got = TokenPipeline(257, 3, 40, seed=5, cursor=cursor).next_batch()
    want = JTokenPipeline(257, 3, 40, seed=5, cursor=cursor).next_batch()
    assert set(got) == set(want) == {"tokens", "labels"}
    for key in got:
        assert got[key].dtype == want[key].dtype
        np.testing.assert_array_equal(got[key], want[key])


def test_token_pipeline_state_restore_round_trip():
    pipe = TokenPipeline(64, 2, 8, seed=1)
    pipe.next_batch()
    saved = pipe.state()
    want = pipe.next_batch()
    other = TokenPipeline(64, 2, 8, seed=1)
    other.restore(saved)
    np.testing.assert_array_equal(other.next_batch()["tokens"],
                                  want["tokens"])
    assert other.state() == {"seed": 1, "cursor": 2}


# ---------------------------------------------------------------------------
# gradient compression
# ---------------------------------------------------------------------------

def test_compress_grads_bit_equal_jax():
    """A stacked leaf (one scale over its layers), a plain one, a small
    one passing through; error feedback carried over two calls."""
    rng = np.random.default_rng(0)
    layers = [rng.normal(size=(32, 48)).astype(np.float32) for _ in range(3)]
    flat = (rng.normal(size=(64, 80)) * 3).astype(np.float32)
    small = rng.normal(size=(16,)).astype(np.float32)
    layers[1] *= 10
    jg = {"s": jnp.stack(layers), "w": jnp.array(flat), "n": jnp.array(small)}
    tg = {"s": Stacked([_t(x) for x in layers]), "w": _t(flat),
          "n": _t(small)}
    jcfg, tcfg = JCompressionConfig(min_size=1000), CompressionConfig(
        min_size=1000)
    jerr = jax.tree.map(jnp.zeros_like, jg)
    terr = {"s": torch.zeros(3, 32, 48), "w": torch.zeros(64, 80),
            "n": torch.zeros(16)}
    for _ in range(2):
        jc, jerr = j_compress_grads(jg, jerr, jcfg)
        tc, terr = compress_grads(tg, terr, tcfg)
        assert isinstance(tc["s"], Stacked)
        np.testing.assert_array_equal(tc["s"].stack().numpy(),
                                      np.asarray(jc["s"]))
        for key in ("w", "n"):
            np.testing.assert_array_equal(tc[key].numpy(),
                                          np.asarray(jc[key]))
        for key in jerr:
            np.testing.assert_array_equal(terr[key].numpy(),
                                          np.asarray(jerr[key]))
    # the small leaf passes through with zero error
    np.testing.assert_array_equal(tc["n"].numpy(), small)
    assert not terr["n"].any()


def test_compression_error_feedback_invariant():
    rng = np.random.default_rng(1)
    g = {"w": _t(rng.normal(size=(64, 64)).astype(np.float32))}
    cfg = CompressionConfig(bits=8, min_size=16)
    comp, new_err = compress_grads(g, {"w": torch.zeros(64, 64)}, cfg)
    # compressed + error == original: nothing is lost
    torch.testing.assert_close(comp["w"] + new_err["w"], g["w"], rtol=1e-5,
                               atol=1e-6)
    scale = g["w"].abs().max().item() / 127.0
    assert new_err["w"].abs().max().item() <= scale * 0.5 + 1e-6
    _, none = compress_grads(g, None, CompressionConfig(error_feedback=False,
                                                        min_size=16))
    assert none is None


def test_compression_small_leaves_pass_through():
    g = {"w": torch.randn(8, 8, generator=torch.Generator().manual_seed(2))}
    comp, err = compress_grads(g, {"w": torch.zeros(8, 8)},
                               CompressionConfig(min_size=1 << 20))
    assert torch.equal(comp["w"], g["w"]) and not err["w"].any()


# ---------------------------------------------------------------------------
# optimizers
# ---------------------------------------------------------------------------

def _opt_trees(rng):
    """The same tree in both layouts: a stacked group of 2-D and of 1-D
    layer leaves (as the reference's scanned layers), a matrix, a vector
    and a 3-D leaf."""
    mats = [rng.normal(size=(6, 5)).astype(np.float32) for _ in range(3)]
    vecs = [rng.normal(size=(5,)).astype(np.float32) for _ in range(3)]
    m = rng.normal(size=(7, 4)).astype(np.float32)
    v = rng.normal(size=(9,)).astype(np.float32)
    t3 = rng.normal(size=(2, 3, 4)).astype(np.float32)
    jt = {"scan": [{"w": jnp.stack(mats), "n": jnp.stack(vecs)}],
          "m": jnp.array(m), "v": jnp.array(v), "t3": jnp.array(t3)}
    tt = {"scan": [{"w": Stacked([_t(x) for x in mats]),
                    "n": Stacked([_t(x) for x in vecs])}],
          "m": _t(m), "v": _t(v), "t3": _t(t3)}
    return jt, tt


def _assert_tree_close(got, want, rtol, atol):
    gl, wl = tree_leaves(got), jax.tree.leaves(want)
    assert len(gl) == len(wl)
    for g, w in zip(gl, wl):
        g = g.stack() if isinstance(g, Stacked) else g
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=rtol,
                                   atol=atol)


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_opt_update_matches_jax(name):
    rng = np.random.default_rng(3)
    jp, tp = _opt_trees(rng)
    kw = dict(name=name, lr=0.05, warmup=2, grad_clip=0.5)
    jcfg, tcfg = JOptConfig(**kw), OptConfig(**kw)
    jst, tst = j_opt_init(jp, jcfg), opt_init(tp, tcfg)
    _assert_tree_close(tst, jst, 0, 0)
    for step in range(3):
        jg, tg = _opt_trees(rng)
        jp, jst = j_opt_update(jp, jg, jst, jcfg, jnp.int32(step))
        tp, tst = opt_update(tp, tg, tst, tcfg, step)
        _assert_tree_close(tp, jp, 1e-5, 1e-7)
        _assert_tree_close(tst, jst, 1e-5, 1e-7)


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_optimizer_minimises_quadratic(name):
    cfg = OptConfig(name=name, lr=0.1, weight_decay=0.0, warmup=1)
    target = torch.tensor([[1.0, -2.0], [3.0, 0.5]])
    params = {"w": torch.zeros(2, 2)}
    state = opt_init(params, cfg)
    for step in range(200):
        params, state = opt_update(params, {"w": 2 * (params["w"] - target)},
                                   state, cfg, step)
    assert torch.sum((params["w"] - target) ** 2).item() < 1e-2, name


def test_grad_clipping():
    g = {"a": torch.full((10,), 100.0)}
    clipped, norm = clip_by_global_norm(g, 1.0)
    assert norm.item() > 1.0
    assert np.isclose(torch.linalg.norm(clipped["a"]).item(), 1.0, rtol=1e-5)
    assert torch.equal(g["a"], torch.full((10,), 100.0))   # not modified


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def test_checkpoint_roundtrip(tmp_path):
    state = TrainState(step=7, params={"w": torch.arange(6.0).reshape(2, 3),
                                       "layers": [{"b": torch.ones(2)}]},
                       opt={"mu": torch.full((3,), 0.5)})
    d = str(tmp_path / "ckpt")
    save_checkpoint(d, 7, state, extra={"data_cursor": 123})
    like = TrainState(step=0, params={"w": torch.zeros(2, 3),
                                      "layers": [{"b": torch.zeros(2)}]},
                      opt={"mu": torch.zeros(3)})
    restored, extra = restore_checkpoint(d, like, device="cpu")
    assert restored.step == 7 and extra["data_cursor"] == 123
    assert torch.equal(restored.params["w"], torch.arange(6.0).reshape(2, 3))
    assert torch.equal(restored.params["layers"][0]["b"], torch.ones(2))
    assert torch.equal(restored.opt["mu"], torch.full((3,), 0.5))
    with pytest.raises(ValueError, match="mismatch"):
        restore_checkpoint(d, {"w": torch.zeros(2, 3)}, device="cpu")


def test_checkpoint_atomicity_no_tmp_left(tmp_path):
    d = str(tmp_path / "ckpt")
    save_checkpoint(d, 1, {"x": torch.ones(3)})
    assert not any(f.endswith(".tmp") for f in os.listdir(d))
    assert latest_step(d) == 1


def test_checkpoint_retention(tmp_path):
    d = str(tmp_path / "ckpt")
    for s in range(6):
        save_checkpoint(d, s, {"x": torch.full((2,), float(s))}, keep=3)
    assert sorted(int(f.split("_")[1]) for f in os.listdir(d)) == [3, 4, 5]
    assert latest_step(d) == 5


def test_checkpoint_restore_specific_step(tmp_path):
    d = str(tmp_path / "ckpt")
    for s in (1, 2):
        save_checkpoint(d, s, {"x": torch.full((2,), float(s))}, keep=5)
    restored, _ = restore_checkpoint(d, {"x": torch.zeros(2)}, step=1,
                                     device="cpu")
    assert torch.equal(restored["x"], torch.ones(2))


def test_restore_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without a card")
    d = str(tmp_path / "ckpt")
    save_checkpoint(d, 1, {"x": torch.ones(3)})
    with pytest.raises(RuntimeError, match="CUDA"):
        restore_checkpoint(d, {"x": torch.zeros(3)})


# ---------------------------------------------------------------------------
# K9 and K10 under autograd
# ---------------------------------------------------------------------------

FLASH_CASES = {
    "gqa_window_cap": dict(Hq=4, Hkv=2, causal=True, window=5, cap=20.0),
    "mha_causal": dict(Hq=2, Hkv=2, causal=True, window=None, cap=None),
    "noncausal": dict(Hq=4, Hkv=1, causal=False, window=None, cap=30.0),
}


def _flash_inputs(seed, Hq, Hkv, Sq=16, D=8):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(2, Sq, H, D)).astype(np.float32)
            for H in (Hq, Hkv, Hkv)]


def _torch_grads(fn, arrays):
    xs = [_t(a).requires_grad_() for a in arrays]
    out = fn(*xs)
    loss = sum(torch.sum(o * o) if i == 0 else torch.sum(o)
               for i, o in enumerate(out if isinstance(out, tuple)
                                     else (out,)))
    return torch.autograd.grad(loss, xs)


@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_function_grads_match_plain_autograd(case):
    c = FLASH_CASES[case]
    xs = _flash_inputs(0, c["Hq"], c["Hkv"])
    args = (c["causal"], c["window"], c["cap"])
    got = _torch_grads(lambda q, k, v: ops.flash_attention_op(q, k, v,
                                                              *args), xs)
    want = _torch_grads(lambda q, k, v: ref.flash_attention_ref(
        q, k, v, *args, kv_chunk=8), xs)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=2e-3, atol=2e-3)


def test_flash_function_grads_match_jax():
    c = FLASH_CASES["gqa_window_cap"]
    xs = _flash_inputs(1, c["Hq"], c["Hkv"])
    args = (c["causal"], c["window"], c["cap"])
    want = jax.grad(lambda q, k, v: jnp.sum(
        j_flash_attention_op(q, k, v, *args) ** 2), argnums=(0, 1, 2))(
        *map(jnp.array, xs))
    got = _torch_grads(lambda q, k, v: ops.flash_attention_op(q, k, v,
                                                              *args), xs)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-3,
                                   atol=2e-3)


def _scan_inputs(seed, Bs=1, Sq=16, C=4, N=4):
    rng = np.random.default_rng(seed)
    return [np.abs(rng.normal(size=(Bs, Sq, C))).astype(np.float32),
            rng.normal(size=(Bs, Sq, C)).astype(np.float32),
            -np.abs(rng.normal(size=(C, N))).astype(np.float32),
            rng.normal(size=(Bs, Sq, N)).astype(np.float32),
            rng.normal(size=(Bs, Sq, N)).astype(np.float32),
            rng.normal(size=(Bs, C, N)).astype(np.float32)]


@pytest.mark.parametrize("plain", ["step_by_step", "chunked"])
def test_mamba_function_grads_match_plain_autograd(plain):
    xs = _scan_inputs(2)
    want_fn = (ref.mamba_scan_ref if plain == "step_by_step" else
               lambda *a: _chunked_selective_scan(*a, chunk=8))
    got = _torch_grads(ops.mamba_scan_op, xs)
    want = _torch_grads(want_fn, xs)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-3, atol=1e-4)


def test_mamba_function_grads_match_jax():
    xs = _scan_inputs(3, Bs=2, Sq=20, C=6, N=4)

    def jloss(*a):
        y, h = j_mamba_scan_op(*a)
        return jnp.sum(y * y) + jnp.sum(h)

    want = jax.grad(jloss, argnums=tuple(range(6)))(*map(jnp.array, xs))
    got = _torch_grads(ops.mamba_scan_op, xs)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-3,
                                   atol=1e-4)


def test_ops_route_through_the_functions_only_under_grad(monkeypatch):
    """Without a gradient to record, the ops call the kernel (here its
    plain version) directly, as serving does; OP_CALLS counts each
    forward on either route."""
    def refuse(*a):
        raise AssertionError("the autograd Function ran without grad")

    xs = [_t(a) for a in _flash_inputs(4, 2, 1)]
    monkeypatch.setattr(ops._FlashAttention, "apply", refuse)
    monkeypatch.setattr(ops._MambaScan, "apply", refuse)
    for name in ops.OP_CALLS:
        ops.OP_CALLS[name] = 0
    ops.flash_attention_op(*xs)
    with torch.no_grad():
        ops.flash_attention_op(*(x.requires_grad_() for x in xs))
        ops.mamba_scan_op(*(_t(a).requires_grad_() for a in _scan_inputs(5)))
    assert ops.OP_CALLS == {"flash_attention": 2, "mamba_scan": 1}


# ---------------------------------------------------------------------------
# chunked cross-entropy
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("chunk,cap", [(8, 30.0), (32, None)])
def test_chunked_cross_entropy_matches_jax(chunk, cap):
    rng = np.random.default_rng(6)
    Bs, Sq, D, V = 2, 21, 16, 40                  # S not a multiple of 8
    x = rng.normal(size=(Bs, Sq, D)).astype(np.float32)
    w = rng.normal(size=(D, V)).astype(np.float32)
    labels = rng.integers(0, V, size=(Bs, Sq)).astype(np.int32)
    mask = rng.random(size=(Bs, Sq)) > 0.2

    def jloss(xx, ww):
        return j_chunked_ce(xx, ww, jnp.array(labels), chunk=chunk,
                            final_softcap_val=cap, mask=jnp.array(mask))

    jv, (jgx, jgw) = jax.value_and_grad(jloss, argnums=(0, 1))(
        jnp.array(x), jnp.array(w))
    tx, tw = _t(x).requires_grad_(), _t(w).requires_grad_()
    tv = chunked_cross_entropy(tx, tw, _t(labels), chunk=chunk,
                               final_softcap_val=cap, mask=_t(mask))
    gx, gw = torch.autograd.grad(tv, (tx, tw))
    np.testing.assert_allclose(tv.item(), float(jv), rtol=1e-5)
    np.testing.assert_allclose(gx.numpy(), np.asarray(jgx), rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(gw.numpy(), np.asarray(jgw), rtol=1e-4,
                               atol=1e-6)
    with torch.no_grad():
        assert chunked_cross_entropy(tx, tw, _t(labels), chunk=chunk,
                                     final_softcap_val=cap,
                                     mask=_t(mask)).item() == tv.item()


# ---------------------------------------------------------------------------
# the train step against JAX's
# ---------------------------------------------------------------------------

def _batches(n, batch=B):
    pipe = TokenPipeline(256, batch, S, seed=0)
    out = []
    for _ in range(n):
        b = pipe.next_batch()
        b["labels"][0, :3] = -1                   # masked positions
        out.append(b)
    return out


def _jax_run(name, opt_cfg, *, grad_accum=1, comp=None, batch=B):
    """JAX's init_state and STEPS train steps: (the numpy states after
    steps 0..STEPS, the losses, the batches)."""
    jm = JLM(cfg=j_reduced(J_ARCHS[name]), remat=False,
             compute_dtype=jnp.float32, attn_impl="pallas",
             ssm_impl="pallas")
    st = j_init_state(jm, jax.random.PRNGKey(0), opt_cfg, comp)
    step = jax.jit(j_make_train_step(jm, opt_cfg, grad_accum=grad_accum,
                                     compression=comp))
    batches = _batches(STEPS, batch)
    states, losses = [_np(st)], []
    for b in batches:
        st, m = step(st, {k: jnp.array(v) for k, v in b.items()})
        states.append(_np(st))
        losses.append(float(m["loss"]))
        assert float(m["loss"]) == float(m["ce"])
    return states, losses, batches


def _port_run(name, jstate, batches, opt_cfg, **kw):
    cfg = reduced(ARCHS[name])
    model = LM(cfg, compute_dtype=torch.float32, attn_impl="kernel",
               ssm_impl="kernel")
    state = train_state_from_numpy(cfg, jstate, device="cpu")
    step = make_train_step(model, opt_cfg, **kw)
    losses = []
    for b in batches:
        state, m = step(state, b)
        assert m["loss"].item() == m["ce"].item() and m["aux"].item() == 0
        losses.append(m["loss"].item())
    return state, losses


def _assert_state_close(name, got: TrainState, jstate, flips=False):
    """Every leaf of the state within rtol 1e-4, atol 1e-5 of JAX's.  With
    ``flips`` (compressed gradients), at most one element in a thousand
    of a leaf may lie outside: where the two libraries' f32 gradients,
    equal to about 1e-7, fall on either side of a rounding boundary of
    the 8-bit quantisation, the two runs compress that element one step
    apart, and Adam turns a step from 0 into a full ``lr`` move."""
    want = train_state_from_numpy(reduced(ARCHS[name]), jstate,
                                  device="cpu")
    assert got.step == want.step
    for part in ("params", "opt", "err"):
        gl, wl = tree_leaves(getattr(got, part)), tree_leaves(
            getattr(want, part))
        assert len(gl) == len(wl)
        for g, w in zip(gl, wl):
            if not flips:
                torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-5)
                continue
            off = ~torch.isclose(g, w, rtol=1e-4, atol=1e-5)
            assert int(off.sum()) <= max(1, g.numel() // 1000), (
                part, int(off.sum()), g.numel())


@pytest.fixture(scope="module")
def jax_adamw():
    return {name: _jax_run(name, JOptConfig(**OPT)) for name in MODELS}


@pytest.mark.parametrize("name", MODELS)
def test_train_step_matches_jax(name, jax_adamw):
    states, jl, batches = jax_adamw[name]
    got, tl = _port_run(name, states[0], batches, OptConfig(**OPT))
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    _assert_state_close(name, got, states[-1])


@pytest.mark.parametrize("name", MODELS)
def test_state_carried_from_jax_after_a_step_continues(name, jax_adamw):
    """JAX runs step 1; the port takes its state and runs steps 2-3."""
    states, jl, batches = jax_adamw[name]
    got, tl = _port_run(name, states[1], batches[1:], OptConfig(**OPT))
    np.testing.assert_allclose(tl, jl[1:], rtol=1e-4)
    _assert_state_close(name, got, states[-1])


@pytest.mark.parametrize("compress", [False, True])
def test_train_step_grad_accum_matches_jax(compress):
    """grad_accum = 2 over a batch of 4, with and without compression
    (the default 8 bits and ``min_size``: the reduced model's small
    leaves pass through, stacked ones quantise with one scale across
    their layers)."""
    name = "gemma2-2b"
    states, jl, batches = _jax_run(
        name, JOptConfig(**OPT), comp=JCompressionConfig() if compress
        else None, batch=4, grad_accum=2)
    assert (states[0].err is not None) == compress
    got, tl = _port_run(name, states[0], batches, OptConfig(**OPT),
                        compression=CompressionConfig() if compress
                        else None, grad_accum=2)
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    _assert_state_close(name, got, states[-1], flips=compress)


def test_train_step_adafactor_matches_jax():
    name = "falcon-mamba-7b"
    opt = dict(OPT, name="adafactor")
    states, jl, batches = _jax_run(name, JOptConfig(**opt))
    got, tl = _port_run(name, states[0], batches, OptConfig(**opt))
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    _assert_state_close(name, got, states[-1])


def test_init_state_matches_the_reference_layout(jax_adamw):
    """``init_state``'s optimizer state has the reference's tree and
    shapes; its parameters follow ``LM.init``."""
    for name in MODELS:
        cfg = reduced(ARCHS[name])
        model = LM(cfg, compute_dtype=torch.float32)
        st = init_state(model, torch.Generator().manual_seed(0),
                        OptConfig(), CompressionConfig())
        want = train_state_from_numpy(cfg, jax_adamw[name][0][0],
                                      device="cpu")
        assert st.step == 0 and st.err is not None
        for part in ("params", "opt"):
            gl = tree_leaves(getattr(st, part))
            wl = tree_leaves(getattr(want, part))
            assert [g.shape for g in gl] == [w.shape for w in wl]
        assert not any(t.any() for t in tree_leaves(st.opt))
        view = reference_view(cfg, st.params)
        assert len(tree_leaves(view)) == len(tree_leaves(want.opt["mu"]))


# ---------------------------------------------------------------------------
# the port on its own
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", MODELS)
def test_remat_is_bit_equal(name):
    cfg = reduced(ARCHS[name])
    params = LM(cfg).init(torch.Generator().manual_seed(1), device="cpu")
    batch = _batches(1)[0]
    out = []
    for remat in (True, False):
        model = LM(cfg, compute_dtype=torch.float32, attn_impl="kernel",
                   ssm_impl="kernel", remat=remat)
        for k in ops.OP_CALLS:
            ops.OP_CALLS[k] = 0
        (loss, _), grads = value_and_grad(model, params, batch)
        op = "flash_attention" if name == "gemma2-2b" else "mamba_scan"
        # the forward, and with remat its recompute in the backward
        assert ops.OP_CALLS[op] == cfg.n_layers * (2 if remat else 1)
        out.append((loss, tree_leaves(grads)))
    assert torch.equal(out[0][0], out[1][0])
    for g, w in zip(out[0][1], out[1][1]):
        assert torch.equal(g, w)


@pytest.mark.parametrize("name", MODELS)
def test_kernel_route_grads_equal_plain_route(name):
    """On the CPU the kernel route's forward is the plain version, and
    K9's backward is the plain attention's own: the routes' gradients
    agree (K10's forward runs step by step, the scan route in chunks)."""
    cfg = reduced(ARCHS[name])
    params = LM(cfg).init(torch.Generator().manual_seed(2), device="cpu")
    batch = _batches(1)[0]
    got = []
    for impl in ("kernel", "plain"):
        model = LM(cfg, compute_dtype=torch.float32,
                   attn_impl="kernel" if impl == "kernel" else "chunked",
                   ssm_impl="kernel" if impl == "kernel" else "scan")
        got.append(value_and_grad(model, params, batch))
    torch.testing.assert_close(got[0][0][0], got[1][0][0], rtol=1e-5,
                               atol=0)
    for g, w in zip(tree_leaves(got[0][1]), tree_leaves(got[1][1])):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-6)


def test_tiny_model_loss_falls_over_20_steps():
    from repro_torch.configs import ArchConfig

    cfg = ArchConfig(name="tiny", family="dense", n_layers=2, d_model=128,
                     n_heads=4, n_kv_heads=2, d_ff=256, vocab=1024)
    model = LM(cfg, compute_dtype=torch.float32, attn_impl="kernel")
    opt = OptConfig(lr=3e-4, warmup=20)
    state = init_state(model, torch.Generator().manual_seed(0), opt)
    step = make_train_step(model, opt)
    pipe = TokenPipeline(cfg.vocab, 8, 64, seed=0)
    losses = []
    for _ in range(20):
        state, m = step(state, pipe.next_batch())
        losses.append(m["loss"].item())
    assert np.all(np.isfinite(losses)) and state.step == 20
    assert losses[-1] < losses[0] - 0.05


def test_init_state_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without a card")
    with pytest.raises(RuntimeError, match="CUDA"):
        init_state(LM(reduced(ARCHS["gemma2-2b"])), None, OptConfig())


def test_params_carried_into_train_state_unstack_like_serving(jax_adamw):
    name = "gemma2-2b"
    jstate = jax_adamw[name][0][0]
    st = train_state_from_numpy(reduced(ARCHS[name]), jstate, device="cpu")
    want = lm_params_from_numpy(reduced(ARCHS[name]), jstate.params,
                                device="cpu")
    for g, w in zip(tree_leaves(st.params), tree_leaves(want)):
        assert torch.equal(g, w)
