"""The port's dry-run tools (``launch.dryrun``, ``launch.report``,
``launch.cost_analysis``) and the LM's probe stand-ins against the JAX
package, on the CPU.

The JAX dry-run sets 512 host devices before it imports jax, so it runs
in one subprocess (``jax_side``): four compilations of reduced cells on a
(2, 4) mesh for their ``memory_analysis()``, and its pure arithmetic.
Each fake world of the port's side is set up and torn down inside its
test.  The distributed search's collectives are counted on a real 4-rank
gloo world of subprocesses.

Tolerances: argument bytes, roofline dicts, report tables, skip reasons,
recorded collective bytes and FLOPs are exact; the ``"bypass"``
stand-ins are bit-equal to JAX's in f32 (attention at ``attn_apply``,
the SSM's at its two lines), and a prefill through them agrees at
``tests/test_torch_lm.py``'s f32 tolerance; ``mamba_scan_dtype=bfloat16``
agrees with JAX's ``scan_dtype=bfloat16`` to rtol 2e-2, atol 2e-3 (each
of the prefix scan's log2(chunk) levels rounds to bf16, 2^-8 relative,
in another association order than ``lax.associative_scan``'s).
"""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import SHAPES as J_SHAPES
from repro.configs.base import shape_applicability as j_applicability
from repro.configs.registry import ARCHS as J_ARCHS
from repro.configs.registry import reduced as j_reduced
from repro.launch import hlo_analysis as j_hlo
from repro.launch import report as j_report
from repro.models.model import LM as JLM
from repro_torch.configs import ARCHS, reduced
from repro_torch.configs.base import SHAPES, ShapeConfig, shape_applicability
from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import AxisRules, NamedSharding, distribute
from repro_torch.kernels import ops
from repro_torch.launch import cost_analysis, dryrun, report
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import LM, lm_params_from_numpy

ROOT = Path(__file__).resolve().parents[1]
DEADLINE = 150.0
CUT = {"train_4k": (64, 8), "decode_32k": (128, 8)}     # (seq, batch)
PARITY_ARCHS = ("gemma2-2b", "falcon-mamba-7b")

JAX_SIDE = textwrap.dedent("""
    import json, sys
    import repro.launch.dryrun as jd        # 512 host devices, before jax
    from repro.configs.base import SHAPES, ShapeConfig
    from repro.configs.registry import ARCHS, reduced
    from repro.distributed.sharding import AxisRules
    from repro.launch.mesh import make_host_mesh

    cut = json.loads(sys.argv[1])
    mesh = make_host_mesh((2, 4), ("data", "model"))
    rules = AxisRules.for_mesh(mesh)
    args = {}
    for name in json.loads(sys.argv[2]):
        for shape, (seq, batch) in cut.items():
            sh = ShapeConfig(shape, seq, batch, SHAPES[shape].kind)
            mem = jd.build_lowered(reduced(ARCHS[name]), sh, mesh,
                                   rules).compile().memory_analysis()
            args[f"{name}/{shape}"] = mem.argument_size_in_bytes
    flops = {f"{a}/{s}": jd.model_flops_for(cfg, sh)
             for a, cfg in ARCHS.items() for s, sh in SHAPES.items()}
    ideal = {f"{a}/{s}": jd.ideal_bytes_for(cfg, sh, n)
             for a, cfg in ARCHS.items() for s, sh in SHAPES.items()
             for n in (1, 256)}
    opt = {a: jd.opt_config_for(cfg).name for a, cfg in ARCHS.items()}
    print(json.dumps({"args": args, "flops": flops, "ideal": ideal,
                      "opt": opt}))
""")


@pytest.fixture(scope="module")
def jax_side():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, "-c", JAX_SIDE, json.dumps(CUT),
         json.dumps(PARITY_ARCHS)],
        env=env, capture_output=True, text=True, timeout=DEADLINE)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def _mesh(shape, axes):
    return make_host_mesh(shape, axes, device_type="meta")


# ---------------------------------------------------------------------------
# memory
# ---------------------------------------------------------------------------

def test_argument_bytes_equal_jax_memory_analysis(jax_side):
    """Rank 0's argument bytes on a (2, 4) mesh, to the byte, as XLA's
    ``memory_analysis()`` counts them (the train step's counter counted,
    an all-Mamba decode step's unread cache index not)."""
    got = {}
    with dryrun.fake_world(8):
        mesh = _mesh((2, 4), ("data", "model"))
        rules = AxisRules.for_mesh(mesh)
        for name in PARITY_ARCHS:
            for shape, (seq, batch) in CUT.items():
                sh = ShapeConfig(shape, seq, batch, SHAPES[shape].kind)
                cell = dryrun.build_cell(reduced(ARCHS[name]), sh, mesh,
                                         rules)
                got[f"{name}/{shape}"] = (dryrun.local_bytes(cell.args)
                                          + cell.scalars)
    assert got == jax_side["args"]


def test_memtracker_counts_the_local_shard():
    """A ``Shard(0)`` DTensor of b bytes over g ranks, made from rank 0's
    shard, and an op on it, each add b / g to MemTracker's peak: it counts
    local storages, not the DTensor's global shape."""
    from torch.distributed._tools.mem_tracker import MemTracker
    from torch.distributed.tensor import DTensor, Shard

    g, rows, cols = 8, 1024, 64
    b = rows * cols * 4
    with dryrun.fake_world(g):
        mesh = _mesh((g,), ("data",))
        with MemTracker() as mt:
            x = DTensor.from_local(
                torch.empty((rows // g, cols), device="meta"), mesh,
                [Shard(0)], run_check=False)
            first = sum(s["Total"] for s in
                        mt.get_tracker_snapshot("peak").values())
            y = x * 2
            second = sum(s["Total"] for s in
                         mt.get_tracker_snapshot("peak").values())
        assert tuple(y.shape) == (rows, cols)
    assert (first, second) == (b // g, 2 * b // g)


COLD_TRACE = textwrap.dedent("""
    import dataclasses, json
    from torch.distributed._tools.mem_tracker import MemTracker
    from repro_torch.configs import ARCHS, reduced
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed.sharding import AxisRules
    from repro_torch.launch import cost_analysis, dryrun
    from repro_torch.launch.mesh import make_host_mesh

    cfg = dataclasses.replace(reduced(ARCHS["falcon-mamba-7b"]), n_layers=1)
    sh = ShapeConfig("train_4k", 32, 8, "train")
    got = {}
    with dryrun.fake_world(8):
        mesh = make_host_mesh((2, 4), ("data", "model"), device_type="meta")
        rules = AxisRules.for_mesh(mesh)
        for name, make in (("plain", MemTracker),
                           ("rank", cost_analysis.rank_memory_tracker),
                           ("cost", cost_analysis.CostRecorder)):
            got[name] = []
            for _ in range(2):
                cell = dryrun.build_cell(cfg, sh, mesh, rules)
                t = make()
                if isinstance(t, MemTracker):
                    t.track_external(*dryrun._tensors(cell.args))
                with t:
                    cell.run()
                    got[name].append(
                        sum(v["Total"] for v in
                            t.get_tracker_snapshot("peak").values())
                        if isinstance(t, MemTracker) else
                        [t.flops, t.bytes_accessed, t.coll.wire_bytes])
    print(json.dumps(got))
""")


def test_trackers_skip_dtensors_sharding_propagation():
    """The first time DTensor places an op in a process, it may run the
    op's decomposition on meta tensors of the global shapes; the rank
    trackers skip them, so a cold trace (a new process) reads what a warm
    one reads, where a plain MemTracker's cold trace reads more."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", COLD_TRACE], env=env,
                         capture_output=True, text=True, timeout=DEADLINE)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["rank"][0] == got["rank"][1]
    assert got["cost"][0] == got["cost"][1]
    assert got["plain"][0] > got["plain"][1] == got["rank"][1]


@pytest.mark.parametrize("name,kind", [
    ("gemma2-2b", "train"), ("gemma2-2b", "prefill"), ("gemma2-2b", "decode"),
    ("falcon-mamba-7b", "prefill")])
def test_depth_probes_equal_a_full_depth_trace(name, kind):
    """The peak traced on 2- and 3-period stacks and extrapolated equals a
    trace of the whole stack (five periods, so the fit extrapolates), on
    a (2, 4) mesh: arguments, outputs and temporaries to the byte.  (From
    1- and 2-period stacks it would not: a falcon-mamba-7b prefill's
    first period steps its peak up more than the later ones.)"""
    cfg = reduced(ARCHS[name])
    prelude, period, _ = cfg.layout()
    cfg = dataclasses.replace(cfg, n_layers=len(prelude) + 5 * len(period))
    seq, batch = (128, 8) if kind == "decode" else (64, 8)
    sh = ShapeConfig(kind, seq, batch, kind)
    keys = ("argument_size_in_bytes", "output_size_in_bytes",
            "temp_size_in_bytes", "peak_bytes")
    with dryrun.fake_world(8):
        mesh = _mesh((2, 4), ("data", "model"))
        rules = AxisRules.for_mesh(mesh)
        probe = dryrun.peak_memory(cfg, sh, mesh, rules, depth_probes=True)
        full = dryrun.peak_memory(cfg, sh, mesh, rules, depth_probes=False)
    assert {k: probe[k] for k in keys} == {k: full[k] for k in keys}
    assert full["temp_size_in_bytes"] > 0
    assert (probe["depth"], full["depth"]) == ("probes", "full")


def test_sharded_caches_never_whole_at_once():
    """Under a mesh ``LM.init_caches`` places each layer's cache as soon as
    it is made: the peak is every layer's local shards plus about one
    layer's whole cache, where making them all first held every layer's
    whole cache (the port's prefill did so until the dry-run showed it;
    JAX's jitted prefill never makes them whole)."""
    cfg = reduced(ARCHS["gemma2-2b"])
    B, S = 8, 64
    whole = 2 * B * S * cfg.n_kv_heads * cfg.head_dim * 2     # k, v bf16
    with dryrun.fake_world(8):
        mesh = _mesh((2, 4), ("data", "model"))
        model = LM(cfg, mesh=mesh)
        mt = cost_analysis.rank_memory_tracker()
        with mt:
            caches = model.init_caches(B, S, torch.device("meta"))
            peak = sum(v["Total"] for v in
                       mt.get_tracker_snapshot("peak").values())
        local = dryrun.local_bytes(caches)
    # batch over data, and the sequence over model (kv = 2 does not
    # divide 4): a rank holds an eighth
    assert local == cfg.n_layers * whole // 8
    # one layer's whole k and v, and distribute_tensor's copy in passing
    assert peak <= local + 2 * whole < cfg.n_layers * whole


def test_fake_world_is_torn_down_and_refuses_a_second():
    """The fake world refuses to start over another, serves only a
    ``"meta"`` mesh, and is gone on exit."""
    import torch.distributed as dist

    with dryrun.fake_world(4):
        with pytest.raises(RuntimeError, match="already up"):
            with dryrun.fake_world(4):
                pass
        with pytest.raises(RuntimeError, match="gloo"):
            make_host_mesh((4,), ("data",), device_type="cpu")
        assert make_host_mesh((4,), ("data",),
                              device_type="meta").size() == 4
    assert not dist.is_initialized()


# ---------------------------------------------------------------------------
# costs
# ---------------------------------------------------------------------------

def test_recorder_counts_a_shard_to_replicate_gather():
    """A ``Shard(0)`` -> ``Replicate`` redistribution of b bytes over a
    group of g is one all-gather of b (g - 1) / g wire bytes a rank, over
    the network when the group spans nodes and over NVLink when not."""
    from torch.distributed.tensor import Replicate

    b = 256 * 512 * 4
    with dryrun.fake_world(32):
        mesh = _mesh((4, 8), ("data", "model"))
        for axis, spec, g, nvlink in (("data", ("data", None), 4, False),
                                      ("model", ("model", None), 8, True)):
            x = distribute(torch.empty((256, 512), device="meta"),
                           NamedSharding(mesh, spec))
            with cost_analysis.CostRecorder() as rec:
                x.redistribute(mesh, [Replicate(), Replicate()])
            assert rec.coll.count == 1, axis
            assert rec.coll.by_kind == {"all-gather": b * (g - 1) / g}
            assert rec.coll.nvlink_bytes == (rec.coll.wire_bytes if nvlink
                                             else 0.0)


def test_prefill_flops_equal_the_hand_count():
    """A reduced dense model's counted prefill FLOPs (a probe: one chunk
    the whole length) are its products counted by hand: the q/k/v/o
    projections, the scores and PV over every (q, kv) pair, the gated
    MLP, and the head on the last position."""
    cfg = reduced(ARCHS["qwen2.5-3b"])
    B, S = 2, 32
    d, H, Hkv, D, f, V = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                          cfg.head_dim, cfg.d_ff, cfg.vocab)
    per_layer = (2 * B * S * d * (H + 2 * Hkv) * D + 2 * B * S * H * D * d
                 + 2 * 2 * B * H * S * S * D + 3 * 2 * B * S * d * f)
    want = cfg.n_layers * per_layer + 2 * B * d * V
    with dryrun.fake_world(1):
        mesh = _mesh((1, 1), ("data", "model"))
        cell = dryrun.build_cell(cfg, ShapeConfig("p", S, B, "prefill"),
                                 mesh, AxisRules.for_mesh(mesh), probe=True)
        with cost_analysis.CostRecorder() as rec:
            cell.run()
    assert rec.flops == want
    assert rec.coll.count == 0


def test_model_flops_and_ideal_bytes_equal_jax(jax_side):
    flops = {f"{a}/{s}": dryrun.model_flops_for(cfg, sh)
             for a, cfg in ARCHS.items() for s, sh in SHAPES.items()}
    ideal = {f"{a}/{s}": dryrun.ideal_bytes_for(cfg, sh, n)
             for a, cfg in ARCHS.items() for s, sh in SHAPES.items()
             for n in (1, 256)}
    assert flops == jax_side["flops"]
    assert ideal == jax_side["ideal"]
    assert {a: dryrun.opt_config_for(cfg).name
            for a, cfg in ARCHS.items()} == jax_side["opt"]


@pytest.mark.parametrize("cost,wire,model_flops,n,ideal", [
    ({"flops": 3.1e14, "bytes accessed": 2.2e12}, 4.0e10, 1.3e16, 256, 1e9),
    ({"flops": 1.0e9, "bytes accessed": 5.0e11}, 0.0, 2.0e12, 256, 4e11),
    ({"flops": 7.0e12}, 9.0e12, 0.0, 512, 0.0),
    ({}, 0.0, 0.0, 1, 0.0),
])
def test_roofline_equals_jax_with_its_constants(cost, wire, model_flops, n,
                                                ideal):
    want = j_hlo.roofline(cost, j_hlo.CollectiveStats(wire_bytes=wire),
                          model_flops=model_flops, n_devices=n,
                          ideal_bytes_per_device=ideal)
    got = cost_analysis.roofline(
        cost, cost_analysis.CollectiveStats(wire_bytes=wire),
        model_flops=model_flops, n_devices=n, ideal_bytes_per_device=ideal,
        peak_flops=j_hlo.PEAK_FLOPS, hbm_bw=j_hlo.HBM_BW,
        nvlink_bw=j_hlo.ICI_BW, network_bw=j_hlo.ICI_BW)
    assert got == want


@pytest.mark.parametrize("kind,b,g", [("all-reduce", 1000, 16),
                                      ("all-gather", 4096, 16),
                                      ("reduce-scatter", 64, 8),
                                      ("all-to-all", 4096, 32),
                                      ("collective-permute", 100, 2)])
def test_ring_accounting_is_the_references(kind, b, g):
    """``wire_bytes`` is ``hlo_analysis.collective_bytes``'s accounting,
    read from one HLO line of that collective."""
    shape = {"all-gather": b // 4, "all-to-all": b // 4,
             "all-reduce": b // 4, "reduce-scatter": b // 4,
             "collective-permute": b // 4}[kind]
    ids = ",".join(str(i) for i in range(g))
    line = (f"  %x = f32[{shape}]{{0}} {kind}(f32[{shape}]{{0}} %p), "
            f"replica_groups={{{{{ids}}}}}")
    want = j_hlo.collective_bytes(line, 256)
    assert cost_analysis.wire_bytes(kind, b, g) == want.wire_bytes


# ---------------------------------------------------------------------------
# the distributed search's collectives on a real gloo world
# ---------------------------------------------------------------------------

GLOO_RANK = textwrap.dedent("""
    import dataclasses, datetime, sys
    from pathlib import Path
    import torch
    import torch.distributed as dist
    from repro_torch.data import make_dataset
    from repro_torch.launch import cost_analysis, dryrun
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.search import (CascadeConfig, EngineConfig, build_index,
                                    make_distributed_search, shard_index)
    from repro_torch.search.distributed import _axes

    rank, init, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init}", rank=rank,
                            world_size=4,
                            timeout=datetime.timedelta(seconds=150))
    try:
        mesh = make_host_mesh((2, 2), ("data", "model"), device_type="cpu")
        ds = make_dataset(n_classes=2, n_train_per_class=32,
                          n_test_per_class=4, length=32, seed=0)
        cfg = EngineConfig(cascade=CascadeConfig(w=4, v=4,
                                                 candidate_chunk=16),
                           verify_chunk=8, k=2)
        idx = build_index(ds.x_train, 4, ds.y_train, device="cpu")
        sidx = shard_index(mesh, idx, ("data",))
        step = make_distributed_search(mesh, cfg)
        leaves = (sidx.series, sidx.labels, sidx.upper, sidx.lower,
                  sidx.kim, sidx.kim_ok)
        q = torch.as_tensor(ds.x_test, dtype=torch.float32)
        with cost_analysis.CostRecorder() as rec:
            step(*leaves, q)
        want = dryrun.paper_collectives(q.shape[0] // 2, cfg.k,
                                        _axes(mesh, ("data",)).group)
        torch.save({"got": dataclasses.asdict(rec.coll),
                    "want": dataclasses.asdict(want)},
                   Path(out) / f"rank{rank}.pt")
        dist.barrier()
    finally:
        dist.destroy_process_group()
""")


def test_paper_collectives_count_the_steps_helper_calls(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1",
               CUDA_VISIBLE_DEVICES="")
    procs = []
    for r in range(4):
        log = open(tmp_path / f"rank{r}.log", "w")
        procs.append(subprocess.Popen(
            [sys.executable, "-c", GLOO_RANK, str(r), str(tmp_path / "rdv"),
             str(tmp_path)], env=env, stdout=log, stderr=subprocess.STDOUT))
    deadline = time.monotonic() + DEADLINE
    try:
        for p in procs:
            p.wait(timeout=max(0.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.wait()
    logs = "".join((tmp_path / f"rank{r}.log").read_text()[-2000:]
                   for r in range(4))
    assert [p.returncode for p in procs] == [0] * 4, logs
    for r in range(4):
        res = torch.load(tmp_path / f"rank{r}.pt", weights_only=False)
        assert res["got"] == res["want"], (r, res)
        assert res["got"]["count"] == 5


# ---------------------------------------------------------------------------
# cells, skips and the report
# ---------------------------------------------------------------------------

def test_skip_reasons_equal_jax(tmp_path):
    assert list(ARCHS) == list(J_ARCHS) and list(SHAPES) == list(J_SHAPES)
    n_skip = 0
    for a in ARCHS:
        for s in SHAPES:
            want = j_applicability(J_ARCHS[a], J_SHAPES[s])
            assert shape_applicability(ARCHS[a], SHAPES[s]) == want
            if want:
                r = dryrun.run_cell(a, s, "single", str(tmp_path))
                assert r == {"arch": a, "shape": s, "mesh": "single",
                             "status": "skip", "reason": want}
                n_skip += 1
    assert n_skip == 8


def _rows():
    rf = j_hlo.roofline({"flops": 3.1e14, "bytes accessed": 2.2e12},
                        j_hlo.CollectiveStats(wire_bytes=4e10),
                        model_flops=1.3e16, n_devices=256,
                        ideal_bytes_per_device=1e9)
    mem = {"argument_size_in_bytes": 6545207656,
           "output_size_in_bytes": 6544683380,
           "temp_size_in_bytes": 48743074832}
    return [
        {"arch": "gemma2-2b", "shape": "decode_32k", "mesh": "single",
         "status": "ok", "compile_s": 1.29, "memory": mem, "roofline": rf},
        {"arch": "gemma2-2b", "shape": "train_4k", "mesh": "single",
         "status": "ok", "compile_s": 4.38, "memory": mem, "roofline": rf},
        {"arch": "hubert-xlarge", "shape": "decode_32k", "mesh": "single",
         "status": "skip",
         "reason": "encoder-only architecture: no autoregressive decode step"},
        {"arch": "falcon-mamba-7b", "shape": "long_500k", "mesh": "multi",
         "status": "ok", "compile_s": 0.24, "memory": dict(
             mem, temp_size_in_bytes=3 * 2 ** 40)},
        {"arch": "paper-dtw-search", "shape": "search_1m", "mesh": "multi",
         "status": "ok", "compile_s": 0.0, "memory": mem, "roofline": rf},
    ]


def test_report_tables_equal_jax(tmp_path, capsys, monkeypatch):
    for r in _rows():
        with open(tmp_path / f"{r['mesh']}__{r['arch']}__{r['shape']}.json",
                  "w") as f:
            json.dump(r, f)
    for mesh in ("single", "multi"):
        rows, jrows = report.load(str(tmp_path), mesh), \
            j_report.load(str(tmp_path), mesh)
        assert rows == jrows
        assert report.dryrun_table(rows) == j_report.dryrun_table(
            jrows).replace("| compile s |", "| trace s |")
        assert report.roofline_table(rows) == j_report.roofline_table(jrows)
    outs = []
    for mod in (report, j_report):
        monkeypatch.setattr(sys, "argv", ["report", "--dir", str(tmp_path)])
        mod.main()
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1].replace("| compile s |", "| trace s |")


def test_report_marks_an_unmeasured_size():
    row = dict(_rows()[0], memory={"argument_size_in_bytes": 1024,
                                   "output_size_in_bytes": 8,
                                   "temp_size_in_bytes": None})
    assert "| 1.00KB | not measured | 8.00B |" in report.dryrun_table([row])


# ---------------------------------------------------------------------------
# the LM's probe stand-ins and the device rule
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def prompt():
    return np.random.default_rng(0).integers(0, 256, size=(2, 24)).astype(
        np.int32)


def _pair(name, **kw):
    jkw = {k: (jnp.bfloat16 if v is torch.bfloat16 else v)
           for k, v in kw.items()}
    jm = JLM(cfg=j_reduced(J_ARCHS[name]), remat=False,
             compute_dtype=jnp.float32, cache_dtype=jnp.float32, **jkw)
    jp = jm.init(jax.random.PRNGKey(0))
    pm = LM(reduced(ARCHS[name]), compute_dtype=torch.float32,
            cache_dtype=torch.float32, **kw)
    pp = lm_params_from_numpy(reduced(ARCHS[name]),
                              jax.tree.map(np.asarray, jp), device="cpu")
    return jm, jp, pm, pp


def test_attention_stand_in_equals_jax_bit_for_bit():
    """``attn_apply(impl="bypass")`` against JAX's, GQA, f32: without a
    cache and as a full-cache prefill (``S == Smax``)."""
    from repro.models import attention as jattn
    from repro_torch.models import attention as pattn

    rng = np.random.default_rng(0)
    B, S, d, H, Hkv, D = 2, 24, 64, 4, 2, 16
    x = rng.standard_normal((B, S, d)).astype(np.float32)
    p = {k: (rng.standard_normal(sh) * 0.1).astype(np.float32)
         for k, sh in dict(wq=(d, H * D), wk=(d, Hkv * D), wv=(d, Hkv * D),
                           wo=(H * D, d)).items()}
    pos = np.broadcast_to(np.arange(S), (B, S)).astype(np.int32)
    kw = dict(n_heads=H, n_kv_heads=Hkv, d_head=D, impl="bypass")
    for cached in (False, True):
        jc = pc = None
        if cached:
            jc = jattn.init_cache(B, S, Hkv, D, jnp.float32)
            pc = pattn.init_cache(B, S, Hkv, D, torch.float32)
        want, _ = jattn.attn_apply(
            {k: jnp.array(v) for k, v in p.items()}, jnp.array(x),
            jnp.array(pos), cache=jc, cache_index=0 if cached else None,
            **kw)
        got, _ = pattn.attn_apply(
            {k: torch.from_numpy(v) for k, v in p.items()},
            torch.from_numpy(x), torch.from_numpy(pos).long(), cache=pc,
            cache_index=0 if cached else None, **kw)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_ssm_stand_in_equals_jax_bit_for_bit():
    """The SSM stand-in (``mamba._scan(impl="bypass")``) is JAX's two
    lines (``src/repro/models/mamba.py:197-198``) bit for bit on the same
    inputs, and ``mamba_apply(impl="bypass")`` agrees with JAX's to the
    bound that the plain scan path keeps (its projections and
    transcendentals run in other orders: rtol 1e-5, atol 1e-7)."""
    from repro.models import mamba as jmamba
    from repro_torch.models import mamba as pmamba

    rng = np.random.default_rng(1)
    B, S, C, N = 2, 24, 32, 8
    delta, uf = (rng.random((B, S, C), dtype=np.float32) for _ in range(2))
    Bm, Cm = (rng.standard_normal((B, S, N)).astype(np.float32)
              for _ in range(2))
    h0 = rng.standard_normal((B, C, N)).astype(np.float32)
    jy = delta * uf * jnp.sum(jnp.array(Bm) * jnp.array(Cm), -1,
                              keepdims=True)
    jh = jnp.array(h0) + jnp.einsum("bsc,bsn->bcn", jnp.array(delta * uf),
                                    jnp.array(Bm)) * 0.0
    t = torch.from_numpy
    y, h = pmamba._scan(t(delta), t(uf), torch.zeros(C, N), t(Bm), t(Cm),
                        t(h0), impl="bypass", chunk=8,
                        scan_dtype=torch.float32)
    np.testing.assert_array_equal(y.numpy(), np.asarray(jy))
    np.testing.assert_array_equal(h.numpy(), np.asarray(jh))

    d, din, N, dtr = 64, 128, 16, 4
    x = rng.standard_normal((B, S, d)).astype(np.float32)
    shapes = dict(in_proj=(d, 2 * din), conv_w=(4, din), conv_b=(din,),
                  x_proj=(din, dtr + 2 * N), dt_proj=(dtr, din),
                  dt_bias=(din,), A_log=(din, N), D=(din,),
                  out_proj=(din, d))
    p = {k: (rng.standard_normal(sh) * 0.1).astype(np.float32)
         for k, sh in shapes.items()}
    want, _ = jmamba.mamba_apply({k: jnp.array(v) for k, v in p.items()},
                                 jnp.array(x), d_state=N, impl="bypass")
    got, _ = pmamba.mamba_apply({k: t(v) for k, v in p.items()}, t(x),
                                d_state=N, impl="bypass")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-7)


@pytest.mark.parametrize("name,kw", [
    ("gemma2-2b", {"attn_impl": "bypass"}),
    ("falcon-mamba-7b", {"ssm_impl": "bypass"})])
def test_lm_prefill_through_the_stand_ins_matches_jax(name, kw, prompt):
    """The full-cache prefill through each stand-in, f32 both sides, at
    ``tests/test_torch_lm.py``'s prefill tolerance (rtol 1e-4, atol
    1e-4): the LM threads the option as JAX's does."""
    jm, jp, pm, pp = _pair(name, **kw)
    jl, _, _ = jax.jit(lambda p, b: jm.prefill(p, b))(
        jp, {"tokens": jnp.array(prompt)})
    logits, _, _ = pm.prefill(pp, {"tokens": torch.from_numpy(prompt)})
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), rtol=1e-4,
                               atol=1e-4)


def test_mamba_scan_dtype_bf16_matches_jax(prompt):
    jm, jp, pm, pp = _pair("falcon-mamba-7b", mamba_scan_dtype=torch.bfloat16)
    jl, _, _ = jax.jit(lambda p, b: jm.prefill(p, b))(
        jp, {"tokens": jnp.array(prompt)})
    logits, _, _ = pm.prefill(pp, {"tokens": torch.from_numpy(prompt)})
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), rtol=2e-2,
                               atol=2e-3)
    f32, _, _ = LM(reduced(ARCHS["falcon-mamba-7b"]),
                   compute_dtype=torch.float32,
                   cache_dtype=torch.float32).prefill(
        pp, {"tokens": torch.from_numpy(prompt)})
    assert not torch.equal(f32, logits)      # the lever is threaded through


def test_meta_only_when_named_and_no_kernel_route_there():
    assert resolve_device("meta") == torch.device("meta")
    assert resolve_device("cpu") == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            resolve_device(None)
    with pytest.raises(RuntimeError, match="unsupported device"):
        resolve_device("xpu")
    q = torch.empty((1, 16, 2, 8), device="meta")
    with pytest.raises(RuntimeError, match="no kernel route"):
        ops.flash_attention_op(q, q, q, True, None, None)
    x = torch.empty((1, 16, 4), device="meta")
    with pytest.raises(RuntimeError, match="no kernel route"):
        ops.mamba_scan_op(x, x, torch.empty((4, 2), device="meta"),
                          torch.empty((1, 16, 2), device="meta"),
                          torch.empty((1, 16, 2), device="meta"),
                          torch.empty((1, 4, 2), device="meta"))
    p = LM(reduced(ARCHS["gemma2-2b"])).init(device="meta")
    assert p["final_norm"].is_meta and p["layers"][0]["attn"]["wq"].is_meta
