"""The repo's shapes at long lengths, the port against the JAX package on
the CPU, and the dry-run's sizing of those shapes
(``launch.dryrun.fit_cell``, which ``chip_smoke.py`` runs) on the meta
device.

- A tiny gemma2-like LM (one local layer, window 4096, and one global;
  narrow widths) steps ``decode_step`` at cache indices 524280-524287
  against 524288-slot caches filled from the same numpy array on both
  sides: RoPE's angles past 2^19 and the window and validity masks at
  those positions.  f32 compute and caches; logits rtol 1e-4, atol 1e-4
  (``tests/test_torch_lm.py``'s: the softmax sums run in other orders).
  The JAX side runs eagerly with its layer stack unrolled
  (``scan_layers=False``): under ``jax.jit`` XLA's CPU fusion of RoPE
  errs with the position (6.4e-3 against an f64 reference at 524280,
  1.4e-5 at 1000), where eager JAX and the port err by ~2e-7; RoPE itself
  is held to the f64 reference at gemma2-2b's head dim too.
- A narrow Mamba layer prefills S = 65536 tokens through its chunked scan
  (256 chunks, the state carried across every one) and, in the port, also
  through the K10 op, whose plain version runs the recurrence step by
  step: outputs and final state against JAX's chunked scan, rtol 1e-4,
  atol 1e-4.
- ``dryrun.fit_cell`` on a tiny budget: the largest batch whose
  predicted peak fits, the largest power-of-two length at batch 1, and
  "does not fit" below batch 1; ``dryrun.fit_largest`` on known curves.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCHS as J_ARCHS
from repro.configs.registry import reduced as j_reduced
from repro.models import layers as j_layers
from repro.models import mamba as j_mamba
from repro.models.model import LM as JLM
from repro_torch.configs import ARCHS, reduced
from repro_torch.configs.base import ShapeConfig
from repro_torch.distributed.sharding import AxisRules
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import LM, lm_caches_from_numpy, lm_params_from_numpy
from repro_torch.models import layers as p_layers
from repro_torch.models import mamba as p_mamba

TOL = dict(rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# decode steps at the end of a 524288-slot cache
# ---------------------------------------------------------------------------

SMAX = 524288
WINDOW = 4096


def _gemma_like(cfg):
    return dataclasses.replace(cfg, n_layers=2, sliding_window=WINDOW)


def test_decode_steps_at_the_end_of_a_524288_slot_cache_match_jax():
    jcfg = _gemma_like(j_reduced(J_ARCHS["gemma2-2b"]))
    cfg = _gemma_like(reduced(ARCHS["gemma2-2b"]))
    assert [cfg.layer_spec(i).window for i in range(2)] == [WINDOW, None]
    opts = dict(compute_dtype=jnp.float32, cache_dtype=jnp.float32,
                kv_chunk=65536)
    jm = JLM(cfg=jcfg, remat=False, scan_layers=False, **opts)
    jparams = jm.init(jax.random.PRNGKey(0))
    model = LM(cfg, compute_dtype=torch.float32, cache_dtype=torch.float32,
               kv_chunk=65536)
    params = lm_params_from_numpy(cfg, jax.tree.map(np.asarray, jparams),
                                  device="cpu")
    rng = np.random.default_rng(0)
    filled = jax.tree.map(
        lambda a: rng.standard_normal(a.shape).astype(np.float32),
        jax.eval_shape(lambda: jm.init_caches(1, SMAX)))
    jc = jax.tree.map(jnp.asarray, filled)
    pc = lm_caches_from_numpy(cfg, filled, device="cpu")
    del filled
    for idx in range(SMAX - 8, SMAX):
        tok = rng.integers(0, cfg.vocab, size=(1, 1)).astype(np.int32)
        want, jc = jm.decode_step(jparams, jc, jnp.asarray(tok),
                                  jnp.int32(idx))
        got, pc = model.decode_step(params, pc, torch.from_numpy(tok), idx)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # the steps wrote the last 8 slots of every layer's cache alike
    want_c = lm_caches_from_numpy(cfg, jax.tree.map(np.asarray, jc),
                                  device="cpu")
    for g, w in zip(pc, want_c):
        for key in ("k", "v"):
            np.testing.assert_allclose(g[key][:, -8:].numpy(),
                                       w[key][:, -8:].numpy(), **TOL)


@pytest.mark.parametrize("d_head", [16, 256])
def test_rope_past_2_19_matches_an_f64_reference_and_jax(d_head):
    """The angle is ``positions.float() * freqs`` in f32 in both
    packages; at d_head = 256 one of the 128 frequencies differs by an
    ulp between torch's and XLA's ``pow``, which at position 524287 moves
    its angle by ~1.5e-5 rad: hence rtol 1e-4, atol 1e-4 against eager
    JAX, and the port within 1e-6 of the f64 rotation of its own
    angles."""
    pos = np.arange(SMAX - 8, SMAX, dtype=np.int32)[None, :]
    x = np.random.default_rng(2).standard_normal(
        (1, 8, 2, d_head)).astype(np.float32)
    got = p_layers.apply_rope(torch.from_numpy(x),
                              torch.from_numpy(pos).long()).numpy()
    want = np.asarray(j_layers.apply_rope(jnp.asarray(x), jnp.asarray(pos)))
    np.testing.assert_allclose(got, want, **TOL)
    ang = (torch.from_numpy(pos)[..., None].float() * p_layers.rope_freqs(
        d_head, 10000.0)).double().numpy()[:, :, None, :]
    x1, x2 = np.split(x.astype(np.float64), 2, axis=-1)
    exact = np.concatenate([x1 * np.cos(ang) - x2 * np.sin(ang),
                            x2 * np.cos(ang) + x1 * np.sin(ang)], axis=-1)
    np.testing.assert_allclose(got, exact, rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# a Mamba layer over 65536 tokens
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", ["scan", "kernel"])
def test_mamba_layer_prefill_of_65536_tokens_matches_jax(impl):
    S, d_model, d_inner, d_state, dt_rank = 65536, 16, 32, 16, 4
    p = jax.tree.map(lambda a: np.array(a), j_mamba.mamba_init(
        jax.random.PRNGKey(1), d_model, d_inner, d_state, dt_rank))
    x = np.random.default_rng(1).standard_normal(
        (1, S, d_model)).astype(np.float32)
    want, wc = j_mamba.mamba_apply(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
        d_state=d_state, cache=j_mamba.init_mamba_cache(
            1, d_inner, d_state, dtype=jnp.float32))
    got, gc = p_mamba.mamba_apply(
        {k: torch.from_numpy(v) for k, v in p.items()}, torch.from_numpy(x),
        d_state=d_state, impl=impl, cache=p_mamba.init_mamba_cache(
            1, d_inner, d_state, dtype=torch.float32))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(gc["h"].numpy(), np.asarray(wc["h"]), **TOL)
    np.testing.assert_array_equal(gc["conv"].numpy(), np.asarray(wc["conv"]))


# ---------------------------------------------------------------------------
# the dry-run's sizing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hi,budget,want", [
    (8, 4.5, 3),        # 1.5 + n
    (8, 100.0, 8),      # all fit: the shape's own n
    (8, 2.0, 0),        # not even n = 1
    (1, 3.0, 1),
    (256, 40.0, 6),     # level to n = 4 (an optimizer peak), then steep
])
def test_fit_largest_finds_the_largest_n_within_the_budget(hi, budget, want):
    seen = []

    def curve(n):
        assert 1 <= n <= hi
        seen.append(n)
        if hi == 256:
            return 30.0 + 2.5 * max(0, n - 4) ** 2
        return 1.5 + n

    assert dryrun.fit_largest(curve, hi, budget) == want
    assert len(set(seen)) <= 10


def test_fit_cell_sizes_batch_and_length_by_the_dry_run():
    cfg = reduced(ARCHS["gemma2-2b"])
    shape = ShapeConfig("prefill_64", 64, 8, "prefill")
    kw = dict(attn_bypass=True, params_dtype=torch.bfloat16)
    with dryrun.fake_world(1):
        mesh = make_host_mesh((1, 1), ("data", "model"), device_type="meta")
        rules = AxisRules.for_mesh(mesh)

        def peak(B, S=64):
            return dryrun.peak_memory(
                cfg, dataclasses.replace(shape, global_batch=B, seq_len=S),
                mesh, rules, **kw)["peak_bytes"]

        p = {b: peak(b) for b in (1, 3, 4)}
        assert p[1] < p[3] < p[4]
        budget = (p[3] + p[4]) / 2
        got = dryrun.fit_cell(cfg, shape, budget, mesh, rules, **kw)
        assert got["fits"] and got["shape"].global_batch == 3
        assert got["shape"].seq_len == 64 and got["cut"] == {"B": "8 -> 3"}
        assert got["predicted_peak"] == p[3] <= budget
        # below batch 1: does not fit
        low = dryrun.fit_cell(cfg, shape, p[1] - 1, mesh, rules, **kw)
        assert not low["fits"] and low["cut"]["B"] == "8 -> 0"
        assert low["predicted_peak"] == p[1]
        # the length, halved at batch 1 until its peak fits
        one = dataclasses.replace(shape, global_batch=1)
        budget = (peak(1, 16) + peak(1, 32)) / 2
        got = dryrun.fit_cell(cfg, one, budget, mesh, rules, vary="seq", **kw)
        assert got["fits"] and got["shape"].seq_len == 16
        assert got["cut"] == {"B": "1 -> 1", "S": "64 -> 16"}
