"""The port's distributed LM (``LM(mesh=...)``, ``distributed.sharding``,
sharded training, elastic restore) against the JAX package's, on the CPU,
and the launcher's restart.

One spawned 4-rank gloo world (each rank runs this file as a script,
``_rank_main``), a 2-rank world for the elastic restore, and one JAX
subprocess with 4 host devices (``XLA_FLAGS``, as
``tests/test_distributed.py``) start together; they rendezvous through
files under the test's temporary directory, and every join and wait has
a deadline (``DEADLINE`` seconds).  The JAX side writes its ``init_state``
trees first; the port's ranks carry them across with
``models.train_state_from_numpy`` and shard them with ``shard_state`` /
``param_shardings``.  Compute and caches are f32 on both sides (a bf16
cache would round k and v, and a 1-ulp f32 difference flips a rounding);
the JAX side runs its
default ``chunked`` / ``scan`` impls under its mesh, ``jit``ted.  Cases:

  * moe: reduced qwen2-moe-a2.7b with ``n_experts=8, top_k=2`` on a
    (2, 2) ``("data", "model")`` mesh, two AdamW steps (as
    ``tests/test_distributed.py:279``); the capacity comes from each data
    rank's tokens, so this is JAX's sharded result, not its ``mesh=None``
    one; every rank's local parameter shapes equal JAX's
    ``addressable_shards`` (a per-layer leaf's against the stacked
    shard's without the repeat axis);
  * mamba: reduced falcon-mamba-7b, one step on (2, 2), with gradient
    compression (the ``xz`` split and ``x_proj``'s partial sums);
  * gqa: reduced gemma2-2b (kv 2) on a (1, 4) mesh, where ``wk`` / ``wv``
    stay replicated: prefill logits and one step;
  * serve: the moe model's ``serve=True`` parameters, a prefill and two
    greedy steps on ``cache_shardings`` caches;
  * restore: the moe state saved by the 4-rank world, restored by the
    2-rank world on a (2,) ``("data",)`` mesh (as
    ``tests/test_distributed.py:315``).

In-process: ``launch.train`` uninterrupted against stop-and-resume, and
the one-process expert-parallel emulation (tp = 2 and 4) against the
unsharded ``moe_apply``.

Tolerances (``tests/test_torch_train.py``'s): losses rtol 1e-4; the state
(parameters and moments) and logits rtol 1e-4, atol 1e-5; with
compression all but one element in a thousand of a leaf (Adam turns a
gradient rounded one quantisation step apart into a full ``lr`` move);
greedy tokens equal; the restore, the emulation and the resumed launcher
losses bit-equal (the launcher's at rtol 1e-5, ``tests/test_system.py``'s
tolerance, would also do).  About 50 s on one worker alone, 83 s inside
the six-worker suite.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
DEADLINE = 150
B, S = 4, 16
STEPS = {"moe": 2, "mamba": 1, "gqa": 1}
MESH = {"moe": (2, 2), "mamba": (2, 2), "gqa": (1, 4), "serve": (2, 2)}
NEW = 3        # greedy tokens: the prefill's and two steps'


def _cfgs(registry, reduced):
    return {
        "moe": dataclasses.replace(reduced(registry["qwen2-moe-a2.7b"]),
                                   n_experts=8, top_k=2),
        "mamba": reduced(registry["falcon-mamba-7b"]),
        "gqa": reduced(registry["gemma2-2b"]),
    }


def _batch(vocab: int, step: int) -> dict:
    rng = np.random.default_rng(100 + step)
    toks = rng.integers(0, vocab, size=(B, S)).astype(np.int32)
    return {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}


def _wait_for(path: Path, deadline: float) -> None:
    while not path.exists():
        if time.monotonic() > deadline:
            raise TimeoutError(f"{path} did not appear")
        time.sleep(0.1)


# ---------------------------------------------------------------------------
# the JAX side: one subprocess, 4 host devices
# ---------------------------------------------------------------------------

_JAX_SCRIPT = """
import dataclasses, os, pickle, sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
sys.path.insert(0, %(tests)r)
from test_torch_sharded_lm import _cfgs, _batch, B, S, STEPS, MESH, NEW
from repro.configs.registry import ARCHS, reduced
from repro.distributed import CompressionConfig
from repro.distributed.sharding import AxisRules, param_shardings
from repro.launch.mesh import make_host_mesh
from repro.models.model import LM
from repro.serve.decode import DecodeSession
from repro.train import OptConfig, init_state, make_train_step
out_dir = %(out)r
cfgs = _cfgs(ARCHS, reduced)
opt = OptConfig(lr=1e-3, warmup=1)
comp = {"mamba": CompressionConfig()}

def np_state(st):
    st = jax.tree.map(np.asarray, st)
    return dict(step=int(st.step), params=st.params, opt=st.opt, err=st.err)

def dump(obj, name):
    with open(os.path.join(out_dir, name + ".tmp"), "wb") as f:
        pickle.dump(obj, f)
    os.replace(os.path.join(out_dir, name + ".tmp"),
               os.path.join(out_dir, name))

init = {k: np_state(init_state(LM(cfg=c, compute_dtype=jnp.float32),
                               jax.random.PRNGKey(0), opt, comp.get(k)))
        for k, c in cfgs.items()}
dump(init, "init.pkl")

def coords(mesh):
    ids = np.vectorize(lambda d: d.id)(mesh.devices)
    return {int(i): tuple(int(c) for c in np.argwhere(ids == i)[0])
            for i in ids.ravel()}

def shards(mesh, tree):
    where = coords(mesh)
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {jax.tree_util.keystr(p): {where[s.device.id]: tuple(s.data.shape)
                                      for s in leaf.addressable_shards}
            for p, leaf in flat}

def sharded(key, serve=False):
    cfg = cfgs[key if key != "serve" else "moe"]
    mesh = make_host_mesh(MESH[key], ("data", "model"))
    model = LM(cfg=cfg, mesh=mesh, dp_axes=("data",),
               compute_dtype=jnp.float32, cache_dtype=jnp.float32)
    st = init_state(model, jax.random.PRNGKey(0), opt, comp.get(key))
    params = jax.device_put(st.params, param_shardings(
        cfg, mesh, AxisRules(), st.params, serve=serve))
    return cfg, mesh, model, dataclasses.replace(st, params=params)

out = {}
for key in ("moe", "mamba", "gqa"):
    cfg, mesh, model, st = sharded(key)
    rec = {"shards": shards(mesh, st.params)}
    if key == "gqa":
        logits, _, _ = jax.jit(model.prefill)(
            st.params, {"tokens": jnp.asarray(_batch(cfg.vocab, 0)["tokens"])})
        rec["prefill"] = np.asarray(logits)
    step = jax.jit(make_train_step(model, opt, compression=comp.get(key)))
    bs = NamedSharding(mesh, P("data", None))
    losses = []
    for i in range(STEPS[key]):
        batch = {k: jax.device_put(jnp.asarray(v), bs)
                 for k, v in _batch(cfg.vocab, i).items()}
        st, m = step(st, batch)
        losses.append(float(m["loss"]))
    rec["losses"] = losses
    rec["state"] = np_state(st)
    out[key] = rec

cfg, mesh, model, st = sharded("serve", serve=True)
sess = DecodeSession(model, st.params, max_len=S + NEW)
prompt = jnp.asarray(_batch(cfg.vocab, 7)["tokens"])
logits = [sess.prefill({"tokens": prompt})]
toks = [jnp.argmax(logits[-1], -1)[:, None].astype(jnp.int32)]
for _ in range(NEW - 1):
    logits.append(sess.step(toks[-1]))
    toks.append(jnp.argmax(logits[-1], -1)[:, None].astype(jnp.int32))
out["serve"] = {"logits": [np.asarray(x) for x in logits],
                "tokens": np.asarray(jnp.concatenate(toks, axis=1)),
                "shards": shards(mesh, st.params)}
dump(out, "jax.pkl")
"""


def _start_jax(tmp: Path):
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               CUDA_VISIBLE_DEVICES="")
    script = _JAX_SCRIPT % {"tests": str(ROOT / "tests"), "out": str(tmp)}
    log = open(tmp / "jax.log", "w")
    return subprocess.Popen([sys.executable, "-c", script], env=env,
                            stdout=log, stderr=subprocess.STDOUT)


# ---------------------------------------------------------------------------
# the port's side: each rank this file
# ---------------------------------------------------------------------------

def _init_state(key: str, tmp: Path, deadline: float):
    from repro_torch.configs import ARCHS, reduced
    from repro_torch.models import train_state_from_numpy

    _wait_for(tmp / "init.pkl", deadline)
    with open(tmp / "init.pkl", "rb") as f:
        init = pickle.load(f)[key]
    cfg = _cfgs(ARCHS, reduced)[key]
    return cfg, train_state_from_numpy(cfg, SimpleNamespace(**init),
                                       device="cpu")


def _full_tree(tree):
    from repro_torch.distributed.sharding import full
    from repro_torch.tree import tree_map

    return tree_map(lambda t: full(t).clone() if isinstance(
        t, torch.Tensor) else t, tree)


def _local_shapes(tree) -> dict:
    from repro_torch.distributed.sharding import is_dtensor
    from repro_torch.tree import named_leaves

    return {name: tuple(t.to_local().shape if is_dtensor(t) else t.shape)
            for name, t in named_leaves(tree)}


def _world4(rank: int, tmp: Path, deadline: float) -> dict:
    from repro_torch.distributed import CompressionConfig
    from repro_torch.distributed.sharding import (AxisRules, full,
                                                  param_shardings)
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import LM
    from repro_torch.serve import DecodeSession, greedy_decode
    from repro_torch.train import OptConfig, make_train_step, save_checkpoint
    from repro_torch.train.trainer import shard_state

    opt = OptConfig(lr=1e-3, warmup=1)
    comp = {"mamba": CompressionConfig()}
    meshes = {shape: make_host_mesh(shape, ("data", "model"),
                                    device_type="cpu")
              for shape in sorted(set(MESH.values()))}
    out = {"coord": {s: tuple(m.get_coordinate()) for s, m in meshes.items()}}
    for key in ("moe", "mamba", "gqa"):
        cfg, state = _init_state(key, tmp, deadline)
        mesh = meshes[MESH[key]]
        model = LM(cfg, mesh=mesh, compute_dtype=torch.float32,
                   cache_dtype=torch.float32)
        state = shard_state(cfg, mesh, AxisRules(), state)
        rec = {"shards": _local_shapes(state.params)}
        if key == "gqa":
            logits, _, _ = model.prefill(
                state.params, {"tokens": _batch(cfg.vocab, 0)["tokens"]})
            rec["prefill"] = full(logits)
        step = make_train_step(model, opt, compression=comp.get(key))
        losses = []
        for i in range(STEPS[key]):
            state, m = step(state, _batch(cfg.vocab, i))
            losses.append(float(m["loss"]))
        rec["losses"] = losses
        rec["state"] = _full_tree(state)
        if key == "moe":     # for the 2-rank world's elastic restore
            save_checkpoint(str(tmp / "ckpt"), state.step, state,
                            extra={"mesh": list(MESH[key])})
        out[key] = rec

    cfg, state = _init_state("moe", tmp, deadline)
    mesh = meshes[MESH["serve"]]
    model = LM(cfg, mesh=mesh, compute_dtype=torch.float32,
                   cache_dtype=torch.float32)
    params = param_shardings(cfg, mesh, AxisRules(), state.params,
                             serve=True, distribute_leaves=True)
    prompt = torch.as_tensor(_batch(cfg.vocab, 7)["tokens"])
    sess = DecodeSession(model, params, max_len=S + NEW)
    logits = [sess.prefill({"tokens": prompt})]
    caches = [{k: (tuple(c.placements), tuple(c.to_local().shape))
               for k, c in layer.items()} for layer in sess.caches]
    toks = [torch.argmax(logits[-1], -1)[:, None].to(torch.int32)]
    for _ in range(NEW - 1):
        logits.append(sess.step(toks[-1]))
        toks.append(torch.argmax(logits[-1], -1)[:, None].to(torch.int32))
    out["serve"] = {"logits": [full(x) for x in logits],
                    "tokens": full(torch.cat(toks, dim=1)),
                    "greedy": full(greedy_decode(model, params, prompt, NEW)),
                    "caches": caches, "shards": _local_shapes(params)}
    return out


def _world2(rank: int, tmp: Path, deadline: float) -> dict:
    """The elastic restart: the 4-rank world's checkpoint onto a (2,)
    mesh."""
    from repro_torch.distributed.sharding import AxisRules
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.train import TrainState, latest_step, restore_checkpoint
    from repro_torch.train.trainer import shard_state, state_shardings

    mesh = make_host_mesh((2,), ("data",), device_type="cpu")
    cfg, like = _init_state("moe", tmp, deadline)
    like = shard_state(cfg, mesh, AxisRules(), like)
    while latest_step(str(tmp / "ckpt")) is None:
        if time.monotonic() > deadline:
            raise TimeoutError("no checkpoint from the 4-rank world")
        time.sleep(0.1)
    sh = state_shardings(cfg, mesh, AxisRules(), like)
    state, extra = restore_checkpoint(
        str(tmp / "ckpt"), like, device="cpu",
        shardings=TrainState(step=None, params=sh["params"], opt=sh["opt"],
                             err=sh["err"]))
    return {"step": state.step, "extra": extra,
            "mesh": tuple(state.params["embed"].device_mesh.shape),
            "placements": tuple(state.params["embed"].placements),
            "shards": _local_shapes(state.params),
            "state": _full_tree(state)}


_WORLDS = {"world4": (4, _world4), "world2": (2, _world2)}


def _rank_main(name: str, rank: int, tmp: str) -> None:
    import datetime

    import torch.distributed as dist

    torch.set_num_threads(1)
    size, fn = _WORLDS[name]
    deadline = time.monotonic() + DEADLINE
    dist.init_process_group("gloo", init_method=f"file://{tmp}/{name}.rdv",
                            rank=rank, world_size=size,
                            timeout=datetime.timedelta(seconds=DEADLINE))
    try:
        torch.save(fn(rank, Path(tmp), deadline),
                   Path(tmp) / f"{name}_{rank}.pt")
        dist.barrier()      # leave together (gloo aborts a torn-down peer)
    finally:
        dist.destroy_process_group()


def _start_world(tmp: Path, name: str):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="")
    procs = []
    for r in range(_WORLDS[name][0]):
        log = open(tmp / f"{name}_{r}.log", "w")
        procs.append(subprocess.Popen(
            [sys.executable, __file__, name, str(r), str(tmp)],
            env=env, stdout=log, stderr=subprocess.STDOUT))
    return procs


def _join(procs, deadline: float) -> str | None:
    try:
        for p in procs:
            p.wait(timeout=max(0.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.wait()
        return f"not done within the {DEADLINE} s deadline"
    rcs = [p.returncode for p in procs]
    return None if not any(rcs) else f"exit codes {rcs}"


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Start the JAX subprocess and both worlds together and join them
    under one deadline.  Each entry is its result, or an error string."""
    tmp = tmp_path_factory.mktemp("sharded_lm")
    jax_proc = _start_jax(tmp)
    worlds = {name: _start_world(tmp, name) for name in _WORLDS}
    deadline = time.monotonic() + DEADLINE + 10
    got = {}
    for name, procs in worlds.items():
        err = _join(procs, deadline)
        if err is None:
            got[name] = [torch.load(tmp / f"{name}_{r}.pt", weights_only=False)
                         for r in range(len(procs))]
        else:
            logs = "".join((tmp / f"{name}_{r}.log").read_text()[-3000:]
                           for r in range(len(procs)))
            got[name] = f"{name}: {err}\n{logs}"
    err = _join([jax_proc], deadline)
    if err is None:
        with open(tmp / "jax.pkl", "rb") as f:
            got["jax"] = pickle.load(f)
    else:
        got["jax"] = f"jax: {err}\n" + (tmp / "jax.log").read_text()[-3000:]
    return got


def _get(runs, name):
    got = runs[name]
    if isinstance(got, str):
        pytest.fail(got)
    return got


def _jax_state(key: str, jstate: dict):
    from repro_torch.configs import ARCHS, reduced
    from repro_torch.models import train_state_from_numpy

    return train_state_from_numpy(_cfgs(ARCHS, reduced)[key],
                                  SimpleNamespace(**jstate), device="cpu")


def _assert_state_close(got, want, flips: bool = False):
    from repro_torch.tree import named_leaves

    assert got.step == want.step
    for part in ("params", "opt", "err"):
        gl, wl = named_leaves(getattr(got, part)), named_leaves(
            getattr(want, part))
        assert [n for n, _ in gl] == [n for n, _ in wl], part
        for (name, g), (_, w) in zip(gl, wl):
            if not flips:
                torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-5,
                                           msg=lambda m: f"{part}{name}: {m}")
                continue
            bad = ~torch.isclose(g, w, rtol=1e-4, atol=1e-5)
            assert int(bad.sum()) <= max(1, g.numel() // 1000), (
                part, name, int(bad.sum()), g.numel())


def _jax_key(cfg, name: str) -> tuple[str, bool]:
    """The JAX leaf of the port's per-layer parameter ``name`` and whether
    it is a stacked one (``models.convert``'s layer order)."""
    import re

    m = re.match(r"\['layers'\]\[(\d+)\](.*)", name)
    if m is None:
        return name, False
    i, rest = int(m.group(1)), m.group(2)
    prelude, period, _ = cfg.layout()
    if i < len(prelude):
        return f"['prelude'][{i}]{rest}", False
    return f"['scan'][{(i - len(prelude)) % len(period)}]{rest}", True


def _assert_shards_equal(key, ranks, jshards, mesh_shape):
    from repro_torch.configs import ARCHS, reduced

    cfg = _cfgs(ARCHS, reduced)["moe" if key == "serve" else key]
    for r in ranks:
        coord = r["coord"][mesh_shape]
        local = r[key]["shards"]
        assert len(local) == sum(
            1 for n in local if _jax_key(cfg, n)[0] in jshards)
        for name, shape in local.items():
            jname, stacked = _jax_key(cfg, name)
            want = jshards[jname][coord]
            assert shape == (want[1:] if stacked else want), (
                key, coord, name, shape, want)


@pytest.mark.parametrize("key", ["moe", "mamba", "gqa"])
def test_sharded_train_steps_match_jax(runs, key):
    """Losses, parameters, moments (and for mamba the compression error)
    after the steps against JAX's sharded ``make_train_step``; every
    rank's local parameter shapes equal JAX's addressable shards."""
    ranks, jx = _get(runs, "world4"), _get(runs, "jax")
    got, want = ranks[0][key], jx[key]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-4)
    _assert_state_close(got["state"], _jax_state(key, want["state"]),
                        flips=key == "mamba")
    _assert_shards_equal(key, ranks, want["shards"], MESH[key])
    for r in ranks[1:]:
        assert r[key]["losses"] == got["losses"]


def test_gqa_prefill_under_kv_replication_matches_jax(runs):
    """gemma2's reduced kv = 2 on tp = 4: ``wk`` / ``wv`` replicated, each
    rank's q head reading kv head ``h // 2``; the logits equal JAX's."""
    got = _get(runs, "world4")[0]["gqa"]
    want = _get(runs, "jax")["gqa"]
    torch.testing.assert_close(got["prefill"],
                               torch.from_numpy(want["prefill"]),
                               rtol=1e-4, atol=1e-5)
    # the replicated kv projections: whole on every rank
    assert got["shards"]["['layers'][0]['attn']['wk']"] == (64, 32)
    assert got["shards"]["['layers'][0]['attn']['wq']"] == (64, 16)


def test_serve_prefill_and_greedy_steps_match_jax(runs):
    """``serve=True`` parameters (no FSDP) and ``cache_shardings`` caches:
    the prefill's and two steps' logits and the greedy tokens equal JAX's;
    ``greedy_decode`` runs unchanged and gives the same tokens."""
    ranks, jx = _get(runs, "world4"), _get(runs, "jax")["serve"]
    got = ranks[0]["serve"]
    for g, w in zip(got["logits"], jx["logits"]):
        torch.testing.assert_close(g, torch.from_numpy(w), rtol=1e-4,
                                   atol=1e-5)
    np.testing.assert_array_equal(got["tokens"].numpy(), jx["tokens"])
    assert torch.equal(got["greedy"], got["tokens"])
    _assert_shards_equal("serve", ranks, jx["shards"], MESH["serve"])
    from torch.distributed.tensor import Shard

    # batch 4 over data 2, kv 2 over model 2: (dp, None, tp, None)
    for layer in got["caches"]:
        for key in ("k", "v"):
            assert layer[key] == ((Shard(0), Shard(2)),
                                  (2, S + NEW, 1, 16)), layer


def test_elastic_restore_onto_a_smaller_mesh(runs):
    """The 4-rank (2, 2) world's state, restored by a 2-rank world on a
    (2,) mesh: every leaf bit-equal to what was saved, placed on the new
    mesh."""
    saved = _get(runs, "world4")[0]["moe"]["state"]
    ranks = _get(runs, "world2")
    from torch.distributed.tensor import Shard

    from repro_torch.tree import named_leaves

    for r in ranks:
        assert r["step"] == saved.step == STEPS["moe"]
        assert r["mesh"] == (2,) and r["placements"] == (Shard(1),)
        assert r["shards"]["['embed']"] == (256, 32)
    got = ranks[0]["state"]
    for part in ("params", "opt"):
        gl = named_leaves(getattr(got, part))
        wl = named_leaves(getattr(saved, part))
        assert [n for n, _ in gl] == [n for n, _ in wl]
        for (name, g), (_, w) in zip(gl, wl):
            assert torch.equal(g, w), (part, name)


# ---------------------------------------------------------------------------
# in-process
# ---------------------------------------------------------------------------

def test_launch_train_resume_equals_uninterrupted(tmp_path):
    """``launch.train --device cpu --preset reduced``: steps 1-4 in one
    run, against steps 1-2 with ``--ckpt-every 2`` and a second call that
    restores step 2 (parameters, moments, the pipeline's cursor) and runs
    3-4; the heartbeat holds the last step."""
    from repro_torch.distributed import Heartbeat
    from repro_torch.launch.train import main

    common = ["--arch", "gemma2-2b", "--preset", "reduced", "--batch", "2",
              "--seq", "16", "--device", "cpu", "--log-every", "100"]
    full_run = main(common + ["--steps", "4"])
    ck, hb = str(tmp_path / "ck"), str(tmp_path / "hb.json")
    first = main(common + ["--steps", "2", "--ckpt-every", "2",
                           "--ckpt-dir", ck, "--heartbeat", hb])
    second = main(common + ["--steps", "4", "--ckpt-every", "2",
                            "--ckpt-dir", ck, "--heartbeat", hb])
    assert first["start"] == 0 and second["start"] == 2
    np.testing.assert_allclose(first["losses"] + second["losses"],
                               full_run["losses"], rtol=1e-5)
    assert first["losses"] + second["losses"] == full_run["losses"]
    import json
    with open(hb) as f:
        assert json.load(f)["step"] == 3
    assert not Heartbeat(hb).is_straggler(600.0)


@pytest.mark.parametrize("tp", [2, 4])
def test_moe_expert_parallel_emulation_bit_equal(tp):
    """Each model rank's island (its ``E / tp`` experts from ``e0``) on
    one process, the partial outputs summed in rank order: top-2 routing
    adds the one-device combine's terms in its order (the other ranks
    add zeros), so the sum equals the unsharded routed output bit for
    bit; the aux loss is every rank's."""
    from repro_torch.configs import ARCHS, reduced
    from repro_torch.models.moe import _routed, moe_init

    cfg = dataclasses.replace(reduced(ARCHS["qwen2-moe-a2.7b"]),
                              n_experts=8, top_k=2)
    gen = torch.Generator().manual_seed(3)
    p = moe_init(gen, "cpu", cfg.d_model, cfg.d_expert,
                 cfg.n_experts_padded, 0, cfg.act)
    xt = torch.randn(64, cfg.d_model, generator=gen)
    opts = dict(top_k=cfg.top_k, n_real=cfg.n_experts, capacity_factor=1.25,
                act=cfg.act, with_aux=True)
    want, aux = _routed(xt, p["router"], p["wi"], p["wg"], p["wo"], **opts)
    el = cfg.n_experts_padded // tp
    y = None
    for r in range(tp):
        sl = slice(r * el, (r + 1) * el)
        yr, aux_r = _routed(xt, p["router"], p["wi"][sl], p["wg"][sl],
                            p["wo"][sl], e0=r * el, **opts)
        assert torch.equal(aux_r, aux)
        y = yr if y is None else y + yr
    assert torch.equal(y, want)


if __name__ == "__main__":
    _rank_main(sys.argv[1], int(sys.argv[2]), sys.argv[3])
