"""Distributed search of the port (``repro_torch.search.distributed``)
against the JAX package's, on the CPU.

The port's step runs in spawned gloo worlds, one process a rank, each rank
running this file as a script (``_rank_main``): an 8-rank world holds a
(4, 2) ``("data", "model")`` mesh and a (2, 2, 2) ``("pod", "data",
"model")`` one, and a 1-rank world the single-device comparison.  The JAX
side runs once, in one subprocess with 8 emulated host devices (as
``tests/test_distributed.py`` does), and prints JSON.  All of them start
together; the rendezvous is a file under the test's temporary directory,
so parallel test workers never contend for a port, and every join has a
deadline (``DEADLINE`` seconds), so a hung world fails its tests.

Data and configs are those of ``tests/test_distributed.py`` (the (4, 2)
exact case, staged and unstaged, the skewed store of the global-budget and calibration cases,
the masked sketch store, the multipod case) and of the distributed guard
cases of ``tests/test_guards.py``.  Tolerances: ids and ``n_dtw`` equal to
JAX's, distances within rtol 1e-5 (XLA contracts the DTW cell update into
an FMA on the CPU, the port does not); the global-budget limits bit-equal
(the same f32 share computed from the same bound matrix); against the
port's own brute force or ``nn_search`` everything is equal.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
DEADLINE = 120

# the skewed store (tests/test_distributed.py:47 and :98): every query's
# near neighbours in shard 0
SKEW = dict(Q=8, L=64, N=128, w=12, k=2)


def _skewed():
    rng = np.random.default_rng(7)
    Q, L, N = SKEW["Q"], SKEW["L"], SKEW["N"]
    queries = rng.normal(size=(Q, L)).astype(np.float32)
    near = np.repeat(queries, 4, axis=0) + 0.05 * rng.normal(
        size=(Q * 4, L)).astype(np.float32)
    far = 5.0 + rng.normal(size=(N - Q * 4, L)).astype(np.float32)
    return queries, np.concatenate([near, far], axis=0).astype(np.float32)


def _lb01(queries, series):
    """The stand-in cheap bound of the allocation probe: squared Euclidean
    distance, computed once in numpy so both packages see the same bits."""
    d = queries[:, None, :] - series[None, :, :]
    return np.sum(d * d, axis=-1, dtype=np.float32)


# ---------------------------------------------------------------------------
# the JAX side: one subprocess, 8 host devices
# ---------------------------------------------------------------------------

_JAX_SCRIPT = """
import json, sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
sys.path.insert(0, %(tests)r)
from test_torch_distributed import _skewed, _lb01, SKEW
from repro.data import make_dataset
from repro.launch.mesh import make_host_mesh
from repro.search import (build_index, EngineConfig, CascadeConfig,
                          make_distributed_search, shard_index,
                          calibrate_distributed_plan)
from repro.search.distributed import global_budget_limit_fn
import repro.distributed.sharding as sharding
# calibrate_distributed_plan runs its shard_map probe unjitted, op by op
# (~40 s here); jitted, the same program compiles once (no while_loop in
# it, so jax 0.4's jit(shard_map) miscompile cannot reach it)
_shard_map = sharding.shard_map_compat
sharding.shard_map_compat = lambda *a, **kw: jax.jit(_shard_map(*a, **kw))
mesh = make_host_mesh((4, 2), ("data", "model"))
out = {}
# (b) the (4, 2) exact case
ds = make_dataset(n_classes=3, n_train_per_class=32, n_test_per_class=8,
                  length=64, seed=5)
idx = build_index(ds.x_train, 12, ds.y_train)
cfg = EngineConfig(cascade=CascadeConfig(w=12, v=4, candidate_chunk=32,
                                         use_pallas=False), verify_chunk=8, k=2)
sidx = shard_index(mesh, idx, ("data",))
step = make_distributed_search(mesh, cfg, data_axes=("data",),
                               query_axis="model", jit=True)
d, i, n = step(sidx.series, sidx.labels, sidx.upper, sidx.lower, sidx.kim,
               sidx.kim_ok, jnp.asarray(ds.x_test))
out["step"] = dict(d=np.asarray(d).tolist(), i=np.asarray(i).tolist(),
                   n=np.asarray(n).tolist())
# (b), unstaged: the dense plan (every pair scored by LB_ENHANCED^V)
cfg = EngineConfig(cascade=CascadeConfig(w=12, v=4, candidate_chunk=32,
                                         use_pallas=False, staged=False),
                   verify_chunk=8, k=2)
step = make_distributed_search(mesh, cfg, data_axes=("data",),
                               query_axis="model", jit=True)
d, i, n = step(sidx.series, sidx.labels, sidx.upper, sidx.lower, sidx.kim,
               sidx.kim_ok, jnp.asarray(ds.x_test))
out["dense_step"] = dict(d=np.asarray(d).tolist(), i=np.asarray(i).tolist(),
                         n=np.asarray(n).tolist())
# (c) the allocation on the skewed store's bound matrix
queries, series = _skewed()
lb01 = _lb01(queries, series)
limit_fn = global_budget_limit_fn(("data",))
probe = _shard_map(lambda lb: limit_fn(lb, 8, SKEW["k"])[None],
                         mesh=mesh, in_specs=(P(None, ("data",)),),
                         out_specs=P(("data",), None))
out["limits"] = np.asarray(probe(jnp.asarray(lb01))).tolist()
# (d) the calibrated plan on the skewed store
w = SKEW["w"]
sidx = shard_index(mesh, build_index(series, w), ("data",))
cfg = EngineConfig(cascade=CascadeConfig(w=w, v=4, candidate_chunk=32,
                                         use_pallas=False, survivor_budget=8),
                   verify_chunk=8, k=SKEW["k"])
dec = calibrate_distributed_plan(
    mesh, cfg, sidx.series, sidx.labels, sidx.upper, sidx.lower, sidx.kim,
    sidx.kim_ok, jnp.asarray(queries), data_axes=("data",),
    query_axis="model")
out["decision"] = dict(order=list(dec.order), dropped=list(dec.dropped),
                       budget=dec.budget, limit=dec.limit)
print(json.dumps(out))
"""


def _start_jax(tmp: Path):
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    script = _JAX_SCRIPT % {"tests": str(ROOT / "tests")}
    log = open(tmp / "jax.log", "w")
    return subprocess.Popen([sys.executable, "-c", script], env=env,
                            stdout=subprocess.PIPE, stderr=log, text=True)


# ---------------------------------------------------------------------------
# the port's side: one gloo world per test module, each rank this file
# ---------------------------------------------------------------------------


def _cfg(w, chunk, vchunk, k, **kw):
    from repro_torch.search import CascadeConfig, EngineConfig

    return EngineConfig(cascade=CascadeConfig(w=w, v=4, candidate_chunk=chunk,
                                              **kw),
                        verify_chunk=vchunk, k=k)


def _leaves(sidx, sketch=False):
    base = (sidx.series, sidx.labels, sidx.upper, sidx.lower, sidx.kim,
            sidx.kim_ok)
    if not sketch:
        return base, ()
    return base, (sidx.sk_lo, sidx.sk_hi, sidx.sk_scale, sidx.live)


def _run(step, sidx, q, sketch=False):
    base, extra = _leaves(sidx, sketch)
    return tuple(x.clone() for x in step(*base, q, *extra))


def _world8(rank: int) -> dict:
    """Every case of the 8-rank world, in one order on every rank."""
    from repro_torch.data import make_dataset
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.search import (brute_force, build_index,
                                    calibrate_distributed_plan,
                                    make_distributed_search, shard_index)
    from repro_torch.search.distributed import global_budget_limit_fn
    from repro_torch.search.guards import GuardReport
    from repro_torch.search.planner import calibration_sample
    from repro_torch.testing import faults

    mesh = make_host_mesh((4, 2), ("data", "model"), device_type="cpu")
    out = {"coord": tuple(mesh.get_coordinate())}

    # (a), (b): tests/test_distributed.py:24
    ds = make_dataset(n_classes=3, n_train_per_class=32, n_test_per_class=8,
                      length=64, seed=5)
    idx = build_index(ds.x_train, 12, ds.y_train, device="cpu")
    cfg = _cfg(12, 32, 8, 2)
    sidx = shard_index(mesh, idx, ("data",))
    step = make_distributed_search(mesh, cfg)
    out["step"] = _run(step, sidx, ds.x_test)
    if rank == 0:
        out["step_brute"] = brute_force(idx, ds.x_test, 12, k=2,
                                        use_kernels=False)
    # (b), unstaged: the dense plan through the same step
    out["dense_step"] = _run(
        make_distributed_search(mesh, _cfg(12, 32, 8, 2, staged=False)),
        sidx, ds.x_test)

    # (c): the allocation on :47's skewed store
    queries, series = _skewed()
    lb01 = torch.from_numpy(_lb01(queries, series))
    d_i = mesh.get_coordinate()[0]
    nl = SKEW["N"] // 4
    limit_fn = global_budget_limit_fn(mesh, ("data",))
    out["limits"] = limit_fn(lb01[:, d_i * nl:(d_i + 1) * nl], 8, SKEW["k"])
    w, k = SKEW["w"], SKEW["k"]
    sk_idx = build_index(series, w, device="cpu")
    sk_sidx = shard_index(mesh, sk_idx, ("data",))
    cfg_s = _cfg(w, 32, 8, k, survivor_budget=8)
    out["skew_step"] = _run(make_distributed_search(mesh, cfg_s), sk_sidx,
                            queries)
    if rank == 0:
        out["skew_brute"] = brute_force(sk_idx, queries, w, k=k,
                                        use_kernels=False)

    # (d): :98's calibrate-then-commit
    dec = calibrate_distributed_plan(mesh, cfg_s, *_leaves(sk_sidx)[0],
                                     queries)
    out["decision"] = dict(order=list(dec.order), dropped=list(dec.dropped),
                           budget=dec.budget, limit=dec.limit,
                           composed=dec.plan.compaction.limit_fn is not None)
    out["calib_step"] = _run(
        make_distributed_search(mesh, cfg_s, plan=dec.plan), sk_sidx,
        queries)

    # (e): :146's masked sketch store
    rng = np.random.default_rng(7)
    walks = np.cumsum(rng.normal(size=(128, 64)), axis=1).astype(np.float32)
    cfg_k = _cfg(12, 32, 8, 2, use_sketch=True)
    m_idx = build_index(walks, 12, calibrate=cfg_k, mask=True, device="cpu")
    m_sidx = shard_index(mesh, m_idx, ("data",))
    qm = walks[calibration_sample(128, 8)]
    out["sketch_step"] = _run(
        make_distributed_search(mesh, cfg_k, with_sketch=True), m_sidx, qm,
        sketch=True)
    out["sketch_live"] = float(m_idx.live.float().mean())
    # calibrated across the mesh: with the sketch leaves the sketch tier
    # is priced (and the committed step stays exact); without them, as in
    # JAX, it scores zeros and is dropped
    base, sk = _leaves(m_sidx, sketch=True)
    dec = calibrate_distributed_plan(mesh, cfg_k, *base, qm, *sk)
    out["sketch_calib"] = dict(order=list(dec.order),
                               sketch_mass=float(dec.stats.mass[0]))
    out["sketch_calib_step"] = _run(
        make_distributed_search(mesh, cfg_k, with_sketch=True, plan=dec.plan),
        m_sidx, qm, sketch=True)
    dec = calibrate_distributed_plan(mesh, cfg_k, *base, qm)
    out["sketch_calib_no_leaves"] = dict(
        order=list(dec.order), sketch_mass=float(dec.stats.mass[0]))
    idx0 = build_index(walks, 12, sketch=None, device="cpu")
    out["sketchless_step"] = _run(make_distributed_search(mesh,
                                                          _cfg(12, 32, 8, 2)),
                                  shard_index(mesh, idx0, ("data",)), qm)
    if rank == 0:
        out["sketch_brute"] = brute_force(m_idx, qm, 12, k=2,
                                          use_kernels=False)

    # (f): tests/test_guards.py:447 and :462
    rng = np.random.default_rng(11)
    X = rng.normal(size=(64, 32)).astype(np.float32)
    qg = rng.normal(size=(4, 32)).astype(np.float32)
    g_idx = build_index(X, 8, device="cpu")
    g_sidx = shard_index(mesh, g_idx, ("data",))
    g_step = make_distributed_search(mesh, _cfg(8, 16, 4, 2),
                                     with_guards=True)
    d, i, n, gv = _run(g_step, g_sidx, qg)
    out["guard_step"] = (d, i, n)
    out["guard_clean"] = GuardReport.from_vector(gv).values()
    with faults.shard_dropout(shard=0):
        gv = _run(g_step, g_sidx, qg)[3]
    rep = GuardReport.from_vector(gv)
    out["guard_dropout"] = (rep.values(), rep.tripped())
    if rank == 0:
        out["guard_brute"] = brute_force(g_idx, qg, 8, k=2, use_kernels=False)

    # (a), multipod: tests/test_distributed.py:255, a (2, 2, 2) mesh over
    # the same world
    pmesh = make_host_mesh((2, 2, 2), ("pod", "data", "model"),
                           device_type="cpu")
    out["pod_coord"] = tuple(pmesh.get_coordinate())
    ds = make_dataset(n_classes=2, n_train_per_class=16, n_test_per_class=4,
                      length=32, seed=9)
    p_idx = build_index(ds.x_train, 8, ds.y_train, device="cpu")
    out["pod_step"] = _run(
        make_distributed_search(pmesh, _cfg(8, 16, 4, 1),
                                data_axes=("pod", "data")),
        shard_index(pmesh, p_idx, ("pod", "data")), ds.x_test)
    if rank == 0:
        out["pod_brute"] = brute_force(p_idx, ds.x_test, 8, k=1,
                                       use_kernels=False)
    return out


def _world1(rank: int) -> dict:
    """(g): a one-rank world against single-device ``nn_search``, with the
    global budget off and on (one shard: the same bounds); the budget is
    fixed by ``adaptive_budget=False``, the step's static rule."""
    from repro_torch.data import make_dataset
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.search import (build_index, make_distributed_search,
                                    nn_search, shard_index)

    mesh = make_host_mesh((1, 1), ("data", "model"), device_type="cpu")
    ds = make_dataset(n_classes=3, n_train_per_class=32, n_test_per_class=8,
                      length=64, seed=5)
    idx = build_index(ds.x_train, 12, ds.y_train, device="cpu")
    cfg = _cfg(12, 32, 8, 2, adaptive_budget=False)
    res = nn_search(idx, ds.x_test, cfg)
    out = {"nn_search": (res.dists, res.idx, res.n_dtw)}
    sidx = shard_index(mesh, idx)
    for gb in (False, True):
        out[f"step_gb{int(gb)}"] = _run(
            make_distributed_search(mesh, cfg, global_budget=gb), sidx,
            ds.x_test)
    return out


_WORLDS = {"world8": (8, _world8), "world1": (1, _world1)}


def _rank_main(name: str, rank: int, init: str, out: str) -> None:
    import datetime

    import torch.distributed as dist

    torch.set_num_threads(1)
    size, fn = _WORLDS[name]
    dist.init_process_group("gloo", init_method=f"file://{init}", rank=rank,
                            world_size=size,
                            timeout=datetime.timedelta(seconds=DEADLINE))
    try:
        torch.save(fn(rank), Path(out) / f"{name}_{rank}.pt")
        dist.barrier()      # leave together (gloo aborts a torn-down peer)
    finally:
        dist.destroy_process_group()


def _start_world(tmp: Path, name: str):
    size = _WORLDS[name][0]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="")
    procs = []
    for r in range(size):
        log = open(tmp / f"{name}_{r}.log", "w")
        procs.append(subprocess.Popen(
            [sys.executable, __file__, name, str(r),
             str(tmp / f"{name}.rdv"), str(tmp)],
            env=env, stdout=log, stderr=subprocess.STDOUT))
    return procs


def _join(procs, deadline: float) -> str | None:
    """Wait for every process until the deadline; kill them all on a hang.
    Returns an error, or ``None``."""
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
    tmp = tmp_path_factory.mktemp("dist")
    jax_proc = _start_jax(tmp)
    worlds = {name: _start_world(tmp, name) for name in _WORLDS}
    deadline = time.monotonic() + DEADLINE
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
    try:
        stdout, _ = jax_proc.communicate(
            timeout=max(0.0, deadline - time.monotonic()))
        got["jax"] = (json.loads(stdout.strip().splitlines()[-1])
                      if jax_proc.returncode == 0 else
                      f"jax: exit {jax_proc.returncode}\n"
                      + (tmp / "jax.log").read_text()[-3000:])
    except subprocess.TimeoutExpired:
        jax_proc.kill()
        jax_proc.communicate()
        got["jax"] = f"jax: not done within the {DEADLINE} s deadline"
    return got


def _get(runs, name):
    got = runs[name]
    if isinstance(got, str):
        pytest.fail(got)
    return got


def _merged(ranks, key, n_model=2, data_pos=0):
    """The whole-batch result of ``key``: the model blocks of the ranks at
    data coordinate 0, in model order (every data rank holds the same
    merged block)."""
    blocks = {}
    for r in ranks:
        c = r["pod_coord"] if key.startswith("pod") else r["coord"]
        if all(x == 0 for x in c[:-1]):
            blocks[c[-1]] = r[key]
    assert sorted(blocks) == list(range(n_model))
    return tuple(torch.cat([blocks[m][j] for m in range(n_model)])
                 for j in range(len(blocks[0])))


def _same_on_every_data_rank(ranks, key):
    by_model = {}
    for r in ranks:
        by_model.setdefault(r["coord"][-1], []).append(r[key])
    for outs in by_model.values():
        for o in outs[1:]:
            for a, b in zip(outs[0], o):
                assert torch.equal(a, b)


def _assert_exact(got, brute):
    d, i = got[0], got[1]
    bd, bi = brute
    np.testing.assert_array_equal(i.numpy(), bi.numpy())
    np.testing.assert_array_equal(d.numpy(), bd.numpy())


@pytest.mark.parametrize("key,brute", [
    ("step", "step_brute"), ("dense_step", "step_brute"),
    ("skew_step", "skew_brute"),
    ("calib_step", "skew_brute"), ("sketch_step", "sketch_brute"),
    ("sketch_calib_step", "sketch_brute"),
    ("guard_step", "guard_brute"), ("pod_step", "pod_brute")])
def test_distributed_step_exact_against_brute_force(runs, key, brute):
    """(a), (d), (e), (f) and the multipod mesh: ids and distances equal
    to the single-device brute force through the plain DTW, with global
    ids, and every data rank holds the same merged block."""
    ranks = _get(runs, "world8")
    _assert_exact(_merged(ranks, key), ranks[0][brute])
    if not key.startswith("pod"):
        _same_on_every_data_rank(ranks, key)


def test_distributed_step_matches_jax_step(runs):
    """(b): the (4, 2) step against JAX's ``make_distributed_search`` on
    the same inputs: ids bit-equal, ``n_dtw`` equal per query, distances
    within rtol 1e-5."""
    ranks, jx = _get(runs, "world8"), _get(runs, "jax")
    d, i, n = _merged(ranks, "step")
    np.testing.assert_array_equal(i.numpy(), np.asarray(jx["step"]["i"]))
    np.testing.assert_array_equal(n.numpy(), np.asarray(jx["step"]["n"]))
    np.testing.assert_allclose(d.numpy(), np.asarray(jx["step"]["d"]),
                               rtol=1e-5)


def test_unstaged_distributed_step_matches_jax_step(runs):
    """(b), unstaged (``staged=False``: the dense plan): the (4, 2) step
    against JAX's unstaged step on the same inputs, ids bit-equal,
    ``n_dtw`` equal per query, distances within rtol 1e-5; ids and
    distances equal to the staged step's."""
    ranks, jx = _get(runs, "world8"), _get(runs, "jax")
    d, i, n = _merged(ranks, "dense_step")
    np.testing.assert_array_equal(i.numpy(),
                                  np.asarray(jx["dense_step"]["i"]))
    np.testing.assert_array_equal(n.numpy(),
                                  np.asarray(jx["dense_step"]["n"]))
    np.testing.assert_allclose(d.numpy(), np.asarray(jx["dense_step"]["d"]),
                               rtol=1e-5)
    sd, si, _ = _merged(ranks, "step")
    assert torch.equal(si, i) and torch.equal(sd, d)


def test_global_budget_limits_bit_equal_to_jax_and_skewed(runs):
    """(c): the per-shard refine limits on the skewed store's bound matrix
    equal JAX's bit for bit, and the allocation skews toward shard 0."""
    ranks, jx = _get(runs, "world8"), _get(runs, "jax")
    lim = {}
    for r in ranks:
        lim.setdefault(r["coord"][0], r["limits"])
        assert torch.equal(lim[r["coord"][0]], r["limits"])
    got = torch.stack([lim[d] for d in range(4)]).numpy()
    want = np.asarray(jx["limits"])
    np.testing.assert_array_equal(got, want)
    assert got[0].mean() > 8 and got[1:].mean() < 8, got


def test_calibrated_plan_matches_jax(runs):
    """(d): the same committed tiers, budget and refine limit as JAX's
    ``calibrate_distributed_plan``, the global budget kept in the
    compaction, the same decision on every rank, and no more DTWs than the
    default step."""
    ranks, jx = _get(runs, "world8"), _get(runs, "jax")
    dec = ranks[0]["decision"]
    assert all(r["decision"] == dec for r in ranks)
    assert dec.pop("composed")
    assert dec == jx["decision"]
    n_cal = _merged(ranks, "calib_step")[2]
    n_def = _merged(ranks, "skew_step")[2]
    assert torch.all(n_cal <= n_def), (n_cal, n_def)


def test_masked_sketch_step_verifies_no_more_than_sketchless(runs):
    """(e): the mask kills candidates, and the committed sketch step
    verifies no more than the sketchless step on the same queries (both
    exact: the parametrised exactness test)."""
    ranks = _get(runs, "world8")
    assert ranks[0]["sketch_live"] < 1.0
    n_sk = _merged(ranks, "sketch_step")[2]
    d0, i0, n0 = _merged(ranks, "sketchless_step")
    _assert_exact((d0, i0), ranks[0]["sketch_brute"])
    assert torch.all(n_sk <= n0), (n_sk, n0)


def test_sketch_calibration_prices_the_sketch_tier_given_its_leaves(runs):
    """(e), calibrated: given the sketch leaves, the distributed
    calibration measures the sketch tier's mass; without them (JAX's
    seven leaves) the tier scores zeros, measures none and is dropped."""
    ranks = _get(runs, "world8")
    got, bare = ranks[0]["sketch_calib"], ranks[0]["sketch_calib_no_leaves"]
    assert all(r["sketch_calib"] == got for r in ranks)
    assert got["sketch_mass"] > 0, got
    assert bare["sketch_mass"] == 0 and "sketch" not in bare["order"], bare


def test_merged_guard_vector_clean_then_shard_dropout_trips(runs):
    """(f): the guard vector merged over all 8 ranks is clean, with both
    conservation (the echo check) and admissibility checked; with
    ``shard_dropout(0)`` conservation trips; nothing degrades."""
    ranks = _get(runs, "world8")
    for r in ranks:
        clean = r["guard_clean"]
        assert clean == ranks[0]["guard_clean"]
        for f in ("admiss_viol", "conserve_viol", "account_viol",
                  "nonfinite_dtw", "degraded"):
            assert clean[f] == 0.0, clean
        # each of 8 ranks echoes its 2 queries
        assert clean["conserve_checked"] >= 16 and clean["admiss_checked"] > 0
        vals, trip = r["guard_dropout"]
        assert "conserve_viol" in trip and vals["degraded"] == 0.0, vals
        # the dropped shard's two ranks lose their 2 queries each
        assert vals["conserve_viol"] == 4.0, vals


def test_one_rank_step_equals_nn_search(runs):
    """(g): on one rank the step is ``nn_search``: ids, distances and
    ``n_dtw`` equal, with the global budget off and on."""
    r = _get(runs, "world1")[0]
    want = r["nn_search"]
    for key in ("step_gb0", "step_gb1"):
        d, i, n = r[key]
        assert torch.equal(d, want[0]) and torch.equal(i, want[1])
        assert torch.equal(n, want[2]), (key, n, want[2])


if __name__ == "__main__":
    _rank_main(sys.argv[1], int(sys.argv[2]), sys.argv[3], sys.argv[4])
