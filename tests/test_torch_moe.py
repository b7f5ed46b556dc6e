"""The port's MoE layer and MoE models against the JAX package, on the CPU.

``models.moe.moe_apply`` against JAX's ``moe_apply(mesh=None)`` on the
cases of ``tests/test_moe.py`` (E, k in {(4, 2), (8, 2), (8, 6)}, 3 real
experts padded to 8, capacity factor 0.25 with drops, shared experts),
a router with two equal columns (the chosen experts are ``lax.top_k``'s:
the lower index wins a tie), and capacity 1 with two tokens colliding
(the same assignment is dropped).  Then reduced qwen2-moe-a2.7b (8
experts padded to 16), deepseek-moe-16b (a dense prelude layer) and
jamba-1.5-large-398b (attention, Mamba and MoE), weights carried from
JAX ``LM.init`` by ``models.lm_params_from_numpy``, f32 compute and
cache on both sides, the JAX side ``attn_impl="pallas"`` and
``ssm_impl="pallas"`` (interpret mode), the port's ``"kernel"`` route
(the plain versions on the CPU): prefill logits and caches, four greedy
decode steps at B = 4 (capacity 2 a step, where assignments are
dropped), ``loss_fn`` with its aux loss and gradients, and one AdamW and
one Adafactor ``make_train_step``.

Tolerances: the layer's outputs and aux rtol 1e-5, atol 1e-5, its
gradients rtol 1e-4, atol 1e-6; prefill logits and caches rtol 1e-4,
atol 1e-4 (``tests/test_torch_lm.py``'s); greedy tokens equal; the loss,
ce and aux rtol 1e-5; the model's gradients and the train state after a
step rtol 1e-4, atol 1e-5 (``tests/test_torch_train.py``'s state
tolerance: jamba's embedding gradient, of order 1, sums its tokens'
rows in another order and differs by ~8e-6).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.moe as jmoe
import repro_torch.models as tmodels
from repro.configs.registry import ARCHS as J_ARCHS
from repro.configs.registry import reduced as j_reduced
from repro.models.model import LM as JLM
from repro.serve import greedy_decode as j_greedy_decode
from repro.train import OptConfig as JOptConfig
from repro.train import init_state as j_init_state
from repro.train import make_train_step as j_make_train_step
from repro_torch.configs import ARCHS, reduced
from repro_torch.models import (LM, lm_caches_from_numpy, lm_params_from_numpy,
                                train_state_from_numpy)
from repro_torch.models import blocks
from repro_torch.models.moe import moe_apply, moe_init, route
from repro_torch.serve import greedy_decode
from repro_torch.train import OptConfig, make_train_step
from repro_torch.train.trainer import value_and_grad
from repro_torch.tree import tree_leaves

MODELS = ["qwen2-moe-a2.7b", "deepseek-moe-16b", "jamba-1.5-large-398b"]
B, S, STEPS = 4, 24, 4
OPT = dict(lr=1e-3, warmup=2)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


# ---------------------------------------------------------------------------
# the layer
# ---------------------------------------------------------------------------

def _layer_run(p, x, **kw):
    """JAX's and the port's (y, aux) and the gradients of sum(y^2) + aux
    with respect to the parameters and x."""
    def jloss(p, x):
        y, aux = jmoe.moe_apply(p, x, mesh=None, **kw)
        return jnp.sum(y * y) + aux, (y, aux)

    (_, (jy, jaux)), jg = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(p, jnp.array(x))
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a))
                      .requires_grad_(), p)
    tx = torch.from_numpy(x).requires_grad_()
    ty, taux = moe_apply(tp, tx, **kw)
    leaves = jax.tree.leaves(tp)
    grads = torch.autograd.grad(torch.sum(ty * ty) + taux, leaves + [tx])
    return (jy, jaux, jax.tree.leaves(jg[0]) + [jg[1]]), (ty, taux, grads)


def _assert_layer_close(j, t):
    jy, jaux, jg = j
    ty, taux, tg = t
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(taux.item(), float(jaux), rtol=1e-5, atol=1e-5)
    assert len(tg) == len(jg)
    for g, w in zip(tg, jg):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-6)


def _dropped(x, p, top_k, n_real, capacity_factor):
    """Assignments past their expert's capacity, by the port's router."""
    xt = torch.from_numpy(x.reshape(-1, x.shape[-1]))
    _, _, _, ids = route(xt, torch.from_numpy(np.array(p["router"])), top_k,
                         n_real)
    cap = math.ceil(xt.shape[0] * top_k / n_real * capacity_factor)
    counts = torch.bincount(ids.reshape(-1), minlength=p["router"].shape[1])
    return int(torch.clamp(counts - cap, min=0).sum())


LAYER_CASES = {
    # name: (E padded, n_real, k, n_shared, capacity factor, B, S, d, f)
    "E4_k2": (4, 4, 2, 0, 4.0, 2, 8, 16, 32),
    "E8_k2": (8, 8, 2, 0, 8.0, 2, 8, 16, 32),
    "E8_k6": (8, 8, 6, 0, 8.0, 2, 8, 16, 32),
    "padding_3_of_8": (8, 3, 2, 0, 8.0, 2, 4, 8, 16),
    "capacity_0.25_drops": (4, 4, 2, 0, 0.25, 2, 16, 8, 16),
    "shared": (4, 4, 2, 2, 1.25, 1, 4, 8, 16),
}


@pytest.mark.parametrize("case", sorted(LAYER_CASES))
def test_moe_apply_matches_jax(case):
    ep, n_real, k, ns, cf, Bs, Ss, d, f = LAYER_CASES[case]
    p = jmoe.moe_init(jax.random.PRNGKey(7), d, f, ep, ns, "silu")
    x = np.random.default_rng(1).normal(size=(Bs, Ss, d)).astype(np.float32)
    kw = dict(top_k=k, n_real=n_real, act="silu", capacity_factor=cf)
    j, t = _layer_run(p, x, **kw)
    _assert_layer_close(j, t)
    if case == "capacity_0.25_drops":
        assert _dropped(x, p, k, n_real, cf) > 0
    if case == "padding_3_of_8":
        _, probs, _, ids = route(torch.from_numpy(x.reshape(-1, d)),
                                 torch.from_numpy(np.array(p["router"])),
                                 k, n_real)
        assert int(ids.max()) < n_real and not probs[:, n_real:].any()


@pytest.mark.parametrize("case", ["E8_k6", "capacity_0.25_drops", "shared"])
def test_moe_apply_without_aux_gives_the_same_output(case):
    """``with_aux=False`` (a prefill's or a decode step's call) returns the
    same output bit for bit and no aux loss."""
    ep, n_real, k, ns, cf, Bs, Ss, d, f = LAYER_CASES[case]
    p = _t(jmoe.moe_init(jax.random.PRNGKey(7), d, f, ep, ns, "silu"))
    x = torch.from_numpy(np.random.default_rng(1).normal(
        size=(Bs, Ss, d)).astype(np.float32))
    kw = dict(top_k=k, n_real=n_real, act="silu", capacity_factor=cf)
    y, aux = moe_apply(p, x, **kw)
    y0, aux0 = moe_apply(p, x, with_aux=False, **kw)
    assert aux.dim() == 0 and aux0 is None
    assert torch.equal(y, y0)


@pytest.mark.parametrize("k,pair,above", [(1, (0, 1), 0), (1, (1, 3), 0),
                                          (3, (2, 5), 2), (2, (4, 6), 0)])
def test_router_ties_go_to_the_lower_expert(k, pair, above):
    """Two equal router columns give equal logits for every token; the
    experts chosen, and their order, are ``lax.top_k``'s, and the outputs
    agree.  ``above`` experts outrank the pair: with ``above + 1 == k``
    the tie straddles the k-th place and the lower index takes it."""
    d, f, E = 8, 16, 8
    p = jmoe.moe_init(jax.random.PRNGKey(3), d, f, E, 0, "silu")
    rng = np.random.default_rng(2)
    router = rng.normal(size=(d, E)).astype(np.float32) * 0.1
    x = np.abs(rng.normal(size=(2, 6, d))).astype(np.float32)
    router[:, pair[0]] = router[:, pair[1]] = 1.0
    for j in range(above):
        router[:, 7 - j] = 2.0 + j
    p = dict(p, router=jnp.array(router))
    logits = (jnp.array(x.reshape(-1, d)) @ p["router"]).astype(jnp.float32)
    _, jids = jax.lax.top_k(jax.nn.softmax(logits, -1), k)
    _, _, _, tids = route(torch.from_numpy(x.reshape(-1, d)),
                          torch.from_numpy(router), k, E)
    assert np.all(np.asarray(logits)[:, pair[0]]
                  == np.asarray(logits)[:, pair[1]])
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    assert bool((tids == pair[0]).any(1).all())
    assert bool((tids == pair[1]).any(1).all()) == (above + 2 <= k)
    j, t = _layer_run(p, x, top_k=k, n_real=E, act="silu")
    _assert_layer_close(j, t)


def test_capacity_one_drops_the_same_assignment():
    """T = 2, k = 2, E = 8: capacity ceil(2 * 2 / 8 * 1.25) = 1.  Both
    tokens' first choice is expert 5, so token 1's assignment to it is
    dropped (position by flat index t * k + j) and token 0's kept."""
    d, f, E, k = 8, 16, 8, 2
    p = jmoe.moe_init(jax.random.PRNGKey(4), d, f, E, 0, "silu")
    rng = np.random.default_rng(3)
    router = rng.normal(size=(d, E)).astype(np.float32) * 0.1
    router[:, 5] = 1.0
    p = dict(p, router=jnp.array(router))
    x = np.abs(rng.normal(size=(1, 2, d))).astype(np.float32)
    _, _, _, ids = route(torch.from_numpy(x[0]), torch.from_numpy(router),
                         k, E)
    assert ids[0, 0] == ids[1, 0] == 5 and ids[0, 1] != ids[1, 1]
    assert _dropped(x, p, k, E, 1.25) == 1
    kw = dict(top_k=k, n_real=E, act="silu")
    j, t = _layer_run(p, x, **kw)
    _assert_layer_close(j, t)
    # without the drop token 0 is unchanged and token 1 gains expert 5
    full, _ = moe_apply(_t(p), torch.from_numpy(x), capacity_factor=8.0, **kw)
    y = t[0].detach()
    torch.testing.assert_close(y[0, 0], full[0, 0], rtol=1e-6, atol=1e-6)
    assert not torch.allclose(y[0, 1], full[0, 1], rtol=1e-3, atol=1e-3)


def test_moe_init_follows_the_jax_shapes_and_fan_in():
    """JAX's tree and shapes; lecun variance over fan_in = E d for the
    (E, d, f) expert stacks, as ``jax.nn.initializers.lecun_normal``."""
    d, f, E = 32, 48, 16
    got = moe_init(torch.Generator().manual_seed(0), "cpu", d, f, E, 2,
                   "silu")
    want = jmoe.moe_init(jax.random.PRNGKey(0), d, f, E, 2, "silu")
    flat_got = jax.tree_util.tree_flatten_with_path(got)[0]
    flat_want = dict(jax.tree_util.tree_flatten_with_path(want)[0])
    assert len(flat_got) == len(flat_want)
    for path, t in flat_got:
        assert tuple(t.shape) == flat_want[path].shape
    for name in ("wi", "wo"):
        var = (got[name].var() * math.prod(got[name].shape[:-1])).item()
        want_var = (np.asarray(want[name]).var()
                    * math.prod(want[name].shape[:-1]))
        assert abs(var - 1.0) < 0.1 and abs(want_var - 1.0) < 0.1


def test_models_exports_the_ported_names_of_the_reference():
    """Every name of the reference's model modules that the port has is
    exported from ``repro_torch.models``."""
    import repro.models.layers as jlayers
    import repro.models.model as jmodel

    for name, mod in (("LM", jmodel), ("moe_init", jmoe),
                      ("moe_apply", jmoe), ("apply_mrope", jlayers)):
        assert hasattr(mod, name)
        assert name in tmodels.__all__ and hasattr(tmodels, name)


# ---------------------------------------------------------------------------
# the models
# ---------------------------------------------------------------------------

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
            for name in MODELS}


@pytest.fixture(scope="module")
def prompt():
    return np.random.default_rng(0).integers(0, 256, size=(B, S)).astype(
        np.int32)


def _port_params(name, jax_params):
    return lm_params_from_numpy(reduced(ARCHS[name]), _np(jax_params[name]),
                                device="cpu")


def test_reduced_moe_configs_have_the_structure_they_test():
    q, ds, jb = (reduced(ARCHS[n]) for n in MODELS)
    assert (q.n_experts, q.n_experts_padded, q.n_shared_experts) == (8, 16, 1)
    assert not ds.layer_spec(0).moe and ds.layer_spec(1).moe
    specs = [jb.layer_spec(i) for i in range(jb.n_layers)]
    assert {s.mixer for s in specs} == {"attn", "mamba"}
    assert any(s.moe for s in specs) and not all(s.moe for s in specs)


@pytest.mark.parametrize("name", MODELS)
def test_prefill_logits_and_caches_match_jax(name, jax_params, prompt):
    jm = _jax_model(name)
    jl, jc, _ = jax.jit(lambda p, b: jm.prefill(p, b))(
        jax_params[name], {"tokens": jnp.array(prompt)})
    logits, caches, idx = _port_model(name).prefill(
        _port_params(name, jax_params), {"tokens": torch.from_numpy(prompt)})
    assert idx == S
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), rtol=1e-4,
                               atol=1e-4)
    want = lm_caches_from_numpy(reduced(ARCHS[name]), _np(jc), device="cpu")
    assert len(caches) == len(want)
    for got_c, want_c in zip(caches, want):
        assert set(got_c) == set(want_c)
        for key in got_c:
            np.testing.assert_allclose(got_c[key].numpy(),
                                       want_c[key].numpy(), rtol=1e-4,
                                       atol=1e-4)


@pytest.mark.parametrize("name", MODELS)
def test_greedy_decode_with_capacity_drops_equals_jax(name, jax_params,
                                                      prompt, monkeypatch):
    """Four greedy steps at B = 4: a step's T = 4 tokens give capacity
    ceil(4 * 2 / 8 * 1.25) = 2 an expert, and some step of some MoE layer
    drops an assignment (counted by the port's router on the layer's
    input)."""
    want = j_greedy_decode(_jax_model(name), jax_params[name],
                           jnp.array(prompt), STEPS)
    cfg = reduced(ARCHS[name])
    drops = []
    real = blocks.moe_apply

    def counting(p, x, **kw):
        if x.shape[1] == 1:
            xt = x.reshape(-1, x.shape[-1])
            _, _, _, ids = route(xt, p["router"], kw["top_k"], kw["n_real"])
            cap = math.ceil(xt.shape[0] * kw["top_k"] / kw["n_real"] * 1.25)
            n = torch.bincount(ids.reshape(-1),
                               minlength=p["router"].shape[1])
            drops.append(int(torch.clamp(n - cap, min=0).sum()))
        return real(p, x, **kw)

    monkeypatch.setattr(blocks, "moe_apply", counting)
    got = greedy_decode(_port_model(name), _port_params(name, jax_params),
                        torch.from_numpy(prompt), STEPS)
    n_moe = sum(cfg.layer_spec(i).moe for i in range(cfg.n_layers))
    assert len(drops) == (STEPS - 1) * n_moe and sum(drops) > 0
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_only_loss_fn_computes_the_aux_loss(jax_params, prompt, monkeypatch):
    """A prefill and a decode step ask no MoE layer for its aux loss, and
    ``backbone`` gives none; ``loss_fn`` asks every MoE layer."""
    name = "qwen2-moe-a2.7b"
    asked = []
    real = blocks.moe_apply

    def recording(p, x, **kw):
        asked.append(kw["with_aux"])
        return real(p, x, **kw)

    monkeypatch.setattr(blocks, "moe_apply", recording)
    model, params = _port_model(name), _port_params(name, jax_params)
    n_moe = sum(model.cfg.layer_spec(i).moe
                for i in range(model.cfg.n_layers))
    tokens = torch.from_numpy(prompt)
    _, caches, idx = model.prefill(params, {"tokens": tokens},
                                   max_len=S + 1)
    model.decode_step(params, caches, tokens[:, :1], idx)
    x = model.embed(params, {"tokens": tokens})
    _, _, aux = model.backbone(params, x, model.positions_for({}, x))
    assert aux is None
    assert asked == [False] * (3 * n_moe)
    asked.clear()
    model.loss_fn(params, {k: torch.from_numpy(v)
                           for k, v in _batch(prompt).items()})
    assert asked == [True] * n_moe


def _batch(prompt):
    labels = np.roll(prompt, -1, axis=1).astype(np.int32)
    labels[0, :3] = -1
    return {"tokens": prompt, "labels": labels}


@pytest.mark.parametrize("name", MODELS)
def test_loss_fn_aux_and_gradients_match_jax(name, jax_params, prompt):
    jm = _jax_model(name)
    batch = _batch(prompt)
    (jloss, jmet), jg = jax.jit(jax.value_and_grad(
        lambda p, b: jm.loss_fn(p, b), has_aux=True))(
        jax_params[name], {k: jnp.array(v) for k, v in batch.items()})
    cfg = reduced(ARCHS[name])
    (loss, met), grads = value_and_grad(
        _port_model(name), _port_params(name, jax_params), batch)
    assert float(jmet["aux"]) > 0
    for got, want in ((loss, jloss), (met["ce"], jmet["ce"]),
                      (met["aux"], jmet["aux"])):
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    want = lm_params_from_numpy(cfg, _np(jg), device="cpu")
    gl, wl = tree_leaves(grads), tree_leaves(want)
    assert len(gl) == len(wl)
    for g, w in zip(gl, wl):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("name,opt", [("qwen2-moe-a2.7b", "adamw"),
                                      ("jamba-1.5-large-398b", "adafactor")])
def test_train_step_matches_jax(name, opt, prompt):
    """One step from JAX's ``init_state``: the loss, its ce and aux, and
    the whole state after it (the experts' moments in JAX's (E, d, f)
    stacks over the layers)."""
    jm = JLM(cfg=j_reduced(J_ARCHS[name]), remat=False,
             compute_dtype=jnp.float32, attn_impl="pallas",
             ssm_impl="pallas")
    jcfg = JOptConfig(name=opt, **OPT)
    st = j_init_state(jm, jax.random.PRNGKey(0), jcfg)
    batch = _batch(prompt)
    st1, jm_ = jax.jit(j_make_train_step(jm, jcfg))(
        st, {k: jnp.array(v) for k, v in batch.items()})
    cfg = reduced(ARCHS[name])
    model = LM(cfg, compute_dtype=torch.float32, attn_impl="kernel",
               ssm_impl="kernel")
    state = train_state_from_numpy(cfg, _np(st), device="cpu")
    state, m = make_train_step(model, OptConfig(name=opt, **OPT))(state,
                                                                  batch)
    for key in ("loss", "ce", "aux"):
        np.testing.assert_allclose(m[key].item(), float(jm_[key]), rtol=1e-5)
    assert m["loss"].item() != m["ce"].item()
    want = train_state_from_numpy(cfg, _np(st1), device="cpu")
    assert state.step == want.step == 1
    for part in ("params", "opt"):
        gl = tree_leaves(getattr(state, part))
        wl = tree_leaves(getattr(want, part))
        assert len(gl) == len(wl)
        for g, w in zip(gl, wl):
            torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-5)
