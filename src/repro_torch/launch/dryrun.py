"""Multi-pod dry-run on the meta device (port of ``repro.launch.dryrun``).

For each (arch x shape x mesh) cell this builds the real step (the train
step, ``LM.prefill`` or ``LM.decode_step``, or the paper's distributed
search step) over a fake world of 256 or 512 ranks in one process
(``fake_world``, the ``fake`` backend of
``torch.testing._internal.distributed.fake_pg``), on the 16x16 single-pod
and 2x16x16 multi-pod meshes of ``launch.mesh.make_production_mesh``.
Parameters, optimizer state, caches and batches are made on the meta
device (shapes and dtypes, no data) and placed by the sharding rules as
DTensors, so each tensor holds rank 0's local shard.  Nothing is compiled:
the step runs eagerly on meta, as rank 0 would run it, and the memory
dict answers the reference's question, whether each rank's share fits:

  * ``argument_size_in_bytes``: rank 0's local bytes of the state (or
    parameters and caches) and the batch, with the step or cache-index
    scalar counted as the reference's int32;
  * ``output_size_in_bytes``: rank 0's local bytes of the outputs;
  * ``temp_size_in_bytes``: the peak of rank 0's local storages over the
    step, arguments included (``cost_analysis.rank_memory_tracker``, a
    ``torch.distributed._tools.mem_tracker.MemTracker``), less the
    arguments; so it holds the outputs, which XLA counts apart;
  * ``compile_s``: the seconds of the traces (no compile; the report's
    column reads "trace s").

The peak needs the real chunking (``kv_chunk``, ``mamba_chunk``,
``ce_chunk``) at the real length, so the step is traced at the real
length and depth (``peak_memory``).  A cell whose whole trace would pass
``FULL_TRACE_MAX_S`` (judged from its 2-period trace) is traced on 2- and
3-period stacks instead and extrapolated in depth: after the first
period, state, saved activations, caches and gradients grow by the same
bytes each period, and a transient that does not (a probe's temporaries
larger than the other's) is kept as a floor.

Roofline costs follow the reference's methodology on probes: 1- and
2-period stacks with every chunk the full length and no remat, at one or
two lengths, each layer one trace of each op, watched by
``launch.cost_analysis.CostRecorder``; per-period costs are fitted as
a + q*S (decode: a + c*S_cache) or a*S + q*S^2 (train/prefill),
extrapolated to the real depth and length, and train terms multiplied by
4/3 for remat recompute.

No kernel op runs on meta (``kernels.ops`` raises there): the plain
routes, or the reference's ``"bypass"`` stand-ins under the levers below,
are named, never fallen back to.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma2-2b --shape train_4k --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
  PYTHONPATH=src python -m repro_torch.launch.dryrun --paper --mesh both
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
import traceback
from typing import Any, Callable

import torch

from repro_torch.configs.base import (SHAPES, ArchConfig, ShapeConfig,
                                      shape_applicability)
from repro_torch.configs.registry import ARCHS, get_arch
from repro_torch.distributed.sharding import (AxisRules, NamedSharding,
                                              batch_specs, distribute,
                                              is_dtensor, param_shardings)
from repro_torch.launch import cost_analysis
from repro_torch.models.model import LM
from repro_torch.train.optimizer import OptConfig
from repro_torch.train.trainer import init_state, make_train_step, shard_state
from repro_torch.tree import tensors

Tensor = torch.Tensor

REMAT_FACTOR = 4.0 / 3.0   # one extra forward during backward
FULL_TRACE_MAX_S = 120.0   # a longer peak trace runs on depth probes
META = torch.device("meta")
SCALAR_BYTES = 4            # the step / cache index, an int32 in the reference

# levers toggled via env for before/after measurement (the reference's)
MAMBA_SCAN_DTYPE = (
    torch.bfloat16 if os.environ.get("REPRO_MAMBA_SCAN_BF16") == "1" else None
)
SERVE_SHARDING = os.environ.get("REPRO_SERVE_SHARDING") == "1"
LB_TILE_Q = int(os.environ.get("REPRO_LB_TILE_Q", "8"))
STORE_BF16 = os.environ.get("REPRO_STORE_BF16") == "1"
# K10 / K9 in place of the plain scan / attention: traced with the
# shape-compatible "bypass" stand-ins (the kernels keep the state and the
# scores on chip, so their traffic is inputs + outputs, added analytically)
SSM_PALLAS = os.environ.get("REPRO_SSM_PALLAS") == "1"
ATTN_PALLAS = os.environ.get("REPRO_ATTN_PALLAS") == "1"
SEQ_SHARD = os.environ.get("REPRO_SEQ_SHARD") == "1"


# ---------------------------------------------------------------------------
# the world
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def fake_world(n_ranks: int):
    """A ``torch.distributed`` world of ``n_ranks`` fake ranks in this
    process, as rank 0; torn down on exit.  Refuses to replace a world
    that is already up."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a torch.distributed world is already up")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=n_ranks)
    try:
        yield
    finally:
        dist.destroy_process_group()


def production_world(mesh_kind: str) -> int:
    return 512 if mesh_kind == "multi" else 256


# ---------------------------------------------------------------------------
# cells
# ---------------------------------------------------------------------------

def _tensors(tree: Any) -> list[Tensor]:
    """The tensors of ``tree`` (a ``Stacked`` leaf's members; no ints)."""
    return [t for t in tensors(tree) if isinstance(t, Tensor)]


def local_bytes(tree: Any) -> int:
    """Rank 0's bytes of every tensor in ``tree`` (a DTensor's local
    shard)."""
    total = 0
    for t in _tensors(tree):
        t = t.to_local() if is_dtensor(t) else t
        total += t.numel() * t.element_size()
    return total


def opt_config_for(cfg: ArchConfig) -> OptConfig:
    # Adam state for a 398B model cannot fit a 256-chip pod; use the
    # factored optimizer there
    if cfg.n_params() > 1e11:
        return OptConfig(name="adafactor")
    return OptConfig(name="adamw")


def input_batch(cfg: ArchConfig, shape: ShapeConfig, mesh, rules: AxisRules,
                seq: int) -> dict[str, Tensor]:
    """The cell's batch on meta, placed by ``batch_specs``."""
    B = shape.global_batch
    S_in = 1 if shape.kind == "decode" else seq
    specs = batch_specs(cfg, shape, mesh, rules)
    out: dict[str, Tensor] = {}

    def put(name: str, shp, dtype):
        out[name] = distribute(torch.empty(shp, dtype=dtype, device=META),
                               NamedSharding(mesh, specs[name]))

    if cfg.embed_inputs:
        put("tokens", (B, S_in), torch.int32)
    else:
        put("frames", (B, S_in, cfg.d_model), torch.bfloat16)
    if shape.kind == "train":
        put("labels", (B, S_in), torch.int32)
    if cfg.vision_prefix and shape.kind != "decode":
        put("vision_embeds", (B, min(cfg.vision_prefix, S_in), cfg.d_model),
            torch.bfloat16)
        put("positions", (B, 3, S_in), torch.int32)
    return out


@dataclasses.dataclass
class Cell:
    """A cell's step on meta: ``run()`` runs it on ``args`` and returns
    its outputs; ``scalars`` is the bytes of the step's int32 scalars
    (the train step's counter, the decode step's cache index), which the
    port passes as Python ints."""

    args: Any
    run: Callable[[], Any]
    scalars: int = 0


def build_cell(cfg: ArchConfig, shape: ShapeConfig, mesh, rules: AxisRules,
               *, seq: int | None = None, probe: bool = False,
               opt_cfg: OptConfig | None = None,
               attn_bypass: bool = ATTN_PALLAS,
               ssm_bypass: bool = SSM_PALLAS,
               params_dtype: torch.dtype | None = None) -> Cell:
    """The cell's step on ``mesh`` (the reference's ``build_lowered``).
    ``probe=True`` makes every chunk the full length and turns remat off,
    so each layer is one trace of each op; probes are for costs only.
    ``opt_cfg`` is the train step's optimizer (default
    ``opt_config_for(cfg)``; a depth probe passes its full model's).
    ``attn_bypass`` / ``ssm_bypass`` trace the ``"bypass"`` stand-ins where
    the card runs K9 / K10 (not in a decode step, which runs neither).
    ``params_dtype`` holds a prefill's or decode step's parameters at rest
    in that dtype, as ``LM.init(dtype=...)`` draws a served tree (default
    f32, the reference's); the train state stays f32."""
    seq = seq if seq is not None else shape.seq_len
    decode = shape.kind == "decode"
    ssm_impl = "bypass" if ssm_bypass and not decode else "scan"
    attn_impl = "bypass" if attn_bypass and not decode else "chunked"
    model = LM(
        cfg, mesh=mesh, dp_axes=rules.dp, remat=not probe,
        kv_chunk=seq if probe else (4096 if decode else 1024),
        mamba_chunk=seq if probe else 256,
        ce_chunk=seq if probe else 512,
        ssm_impl=ssm_impl, attn_impl=attn_impl,
        seq_shard=SEQ_SHARD and not decode,
        mamba_scan_dtype=MAMBA_SCAN_DTYPE)
    batch = input_batch(cfg, shape, mesh, rules, seq)

    if shape.kind == "train":
        opt_cfg = opt_cfg or opt_config_for(cfg)
        state = shard_state(cfg, mesh, rules,
                            init_state(model, None, opt_cfg, device=META))
        step = make_train_step(model, opt_cfg)
        return Cell(args=(state, batch), run=lambda: step(state, batch),
                    scalars=SCALAR_BYTES)
    params = model.init(device=META, dtype=params_dtype)
    serve = SERVE_SHARDING and decode
    if serve:
        # serving checkpoints are bf16 at rest (the >=2-D f32 leaves, as
        # compute_params casts them): halves param-read bytes
        params = model.compute_params(params)
    params = param_shardings(cfg, mesh, rules, params, serve=serve,
                             distribute_leaves=True)
    if shape.kind == "prefill":
        return Cell(args=(params, batch),
                    run=lambda: model.prefill(params, batch)[:2])
    # decode: the KV/SSM cache covers `seq` positions, placed by
    # cache_shardings
    caches = model.init_caches(shape.global_batch, seq, META)
    tokens = batch["tokens"]
    # only attention reads the cache index; XLA drops an argument the
    # step never reads, so an all-Mamba stack's index is not counted
    reads_index = any(cfg.layer_spec(i).mixer == "attn"
                      for i in range(cfg.n_layers))
    return Cell(args=(params, caches, tokens),
                run=lambda: model.decode_step(params, caches, tokens,
                                              seq - 1),
                scalars=SCALAR_BYTES if reads_index else 0)


def trace_memory(cfg: ArchConfig, shape: ShapeConfig, mesh,
                 rules: AxisRules, **cell_kw) -> dict[str, float]:
    """One traced step at the cell's real length and chunking: rank 0's
    argument, output and peak bytes, and the trace's seconds
    (``cell_kw``: ``build_cell``'s options)."""
    cell = build_cell(cfg, shape, mesh, rules, **cell_kw)
    args = local_bytes(cell.args) + cell.scalars
    mt = cost_analysis.rank_memory_tracker()
    mt.track_external(*_tensors(cell.args))
    t0 = time.perf_counter()
    with mt:
        out = cell.run()
        peak = mt.get_tracker_snapshot("peak")
    seconds = time.perf_counter() - t0
    peak_b = sum(s["Total"] for s in peak.values()) + cell.scalars
    if shape.kind == "train":
        state, metrics = out
        outs = local_bytes((state.params, state.opt, state.err, metrics)) \
            + cell.scalars
    else:
        outs = local_bytes(out)
    return {"args": float(args), "outs": float(outs), "peak": float(peak_b),
            "trace_s": seconds}


def peak_memory(cfg: ArchConfig, shape: ShapeConfig, mesh, rules: AxisRules,
                *, depth_probes: bool | None = None,
                **cell_kw) -> dict[str, Any]:
    """The memory dict of the cell (module docstring), from one trace of
    the whole stack, or (``depth_probes=True``) from traces of 2- and
    3-period stacks extrapolated to the real depth (the first period is
    no guide: the embedding's output and the stack's first transients
    make its step to the second period larger than the later ones).
    ``None`` traces the 2-period stack first and takes the probes only
    where its seconds, scaled to the whole stack, pass
    ``FULL_TRACE_MAX_S``."""
    cell_kw.setdefault("opt_cfg", opt_config_for(cfg))
    prelude, period, n_repeat = cfg.layout()

    def probe(k):
        return trace_memory(dataclasses.replace(
            cfg, n_layers=len(prelude) + k * len(period)), shape, mesh, rules,
            **cell_kw)

    pts = {}
    if n_repeat <= 3:
        depth_probes = False
    elif depth_probes is None:
        pts[2] = probe(2)
        depth_probes = (pts[2]["trace_s"] * cfg.n_layers
                        / (len(prelude) + 2 * len(period)) > FULL_TRACE_MAX_S)
    if depth_probes:
        pts.setdefault(2, probe(2))
        pts[3] = probe(3)
        m = {key: pts[2][key] + (n_repeat - 2) * (pts[3][key] - pts[2][key])
             for key in ("args", "outs", "peak")}
        # a transient that does not grow with depth (one probe's
        # temporaries above the other's) is in the whole stack too: the
        # peak is at least the arguments plus the larger temporaries
        floor = m["args"] + max(p["peak"] - p["args"] for p in pts.values())
        m["peak"] = max(m["peak"], floor)
    else:
        m = trace_memory(cfg, shape, mesh, rules, **cell_kw)
    return {
        "argument_size_in_bytes": int(m["args"]),
        "output_size_in_bytes": int(m["outs"]),
        "temp_size_in_bytes": int(m["peak"] - m["args"]),
        "peak_bytes": int(m["peak"]),
        "trace_s": sum(p["trace_s"] for p in pts.values())
        + (0.0 if depth_probes else m["trace_s"]),
        "depth": "probes" if depth_probes else "full",
    }


# ---------------------------------------------------------------------------
# sizing a cell to one card
# ---------------------------------------------------------------------------

def fit_largest(peak_of: Callable[[int], float], hi: int,
                budget: float) -> int:
    """The largest n in [1, hi] with ``peak_of(n) <= budget``, 0 when even
    n = 1 is over, by bisection; ``peak_of`` is taken as non-decreasing in
    n (a batch or a depth), level stretches included."""
    if peak_of(1) > budget:
        return 0
    lo = 1
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if peak_of(mid) <= budget:
            lo = mid
        else:
            hi = mid - 1
    return lo


def fit_cell(cfg: ArchConfig, shape: ShapeConfig, budget: float, mesh,
             rules: AxisRules, *, vary: str = "batch",
             **cell_kw) -> dict[str, Any]:
    """Size one cell by ``peak_memory`` on ``mesh`` (a (1, 1) mesh of
    ``fake_world(1)``, which must be up): ``vary="batch"``, the largest
    batch up to the shape's whose predicted peak is within ``budget``
    bytes; ``"seq"``, batch 1 at the shape's length, halved while over;
    ``"depth"``, the largest depth up to the config's that fits at batch
    1, then the largest batch at that depth.  ``cell_kw`` goes to
    ``peak_memory``.  Returns ``{"fits", "cfg", "shape"}`` (the sized
    config and shape), ``"predicted_peak"`` (at the pick; where nothing
    fits, at batch 1 of the smallest case tried), ``"cut"``
    (``{"B": "32 -> 9", ...}``), the ``"traces"`` taken and
    ``"sizing_s"``.  The peak is the bytes the step allocates; what the
    caching allocator reserves for them is not in it."""
    t0 = time.perf_counter()
    memo: dict[tuple[int, int, int], int] = {}

    def peak(n_layers: int, B: int, S: int) -> int:
        if (n_layers, B, S) not in memo:
            c = dataclasses.replace(cfg, n_layers=n_layers)
            sh = dataclasses.replace(shape, global_batch=B, seq_len=S)
            memo[n_layers, B, S] = peak_memory(c, sh, mesh, rules,
                                               **cell_kw)["peak_bytes"]
        return memo[n_layers, B, S]

    L, S = cfg.n_layers, shape.seq_len
    if vary == "seq":
        while S > 1 and peak(L, 1, S) > budget:
            S //= 2
        B = int(peak(L, 1, S) <= budget)
    else:
        if vary == "depth":
            L = fit_largest(lambda n: peak(n, 1, S), cfg.n_layers,
                            budget) or 1
        B = fit_largest(lambda b: peak(L, b, S), shape.global_batch, budget)
    cut = {"B": f"{shape.global_batch} -> {B}"}
    if S != shape.seq_len:
        cut["S"] = f"{shape.seq_len} -> {S}"
    if L != cfg.n_layers:
        cut["n_layers"] = f"{cfg.n_layers} -> {L}"
    return {"fits": B > 0, "cfg": dataclasses.replace(cfg, n_layers=L),
            "shape": dataclasses.replace(shape, global_batch=max(B, 1),
                                         seq_len=S),
            "predicted_peak": peak(L, max(B, 1), S), "cut": cut,
            "traces": [{"n_layers": k[0], "B": k[1], "S": k[2], "peak": v}
                       for k, v in memo.items()],
            "sizing_s": time.perf_counter() - t0}


# ---------------------------------------------------------------------------
# roofline probes
# ---------------------------------------------------------------------------

def _probe_point(cfg: ArchConfig, shape: ShapeConfig, mesh, rules,
                 n_layers: int, seq: int, **cell_kw) -> dict[str, Any]:
    cfgm = dataclasses.replace(cfg, n_layers=n_layers)
    cell = build_cell(cfgm, shape, mesh, rules, seq=seq, probe=True,
                      opt_cfg=opt_config_for(cfg), **cell_kw)
    with cost_analysis.CostRecorder() as rec:
        cell.run()
    return {
        "flops": rec.flops,
        "bytes": rec.bytes_accessed,
        "coll": rec.coll.wire_bytes,
        "coll_nvlink": rec.coll.nvlink_bytes,
        "coll_by_kind": rec.coll.by_kind,
        "collectives": rec.coll.count,
    }


def probe_costs(cfg: ArchConfig, shape: ShapeConfig, mesh,
                rules: AxisRules, *, attn_bypass: bool = ATTN_PALLAS,
                ssm_bypass: bool = SSM_PALLAS) -> dict[str, Any]:
    """Extrapolated per-rank costs (see module docstring); the probes run
    the full model's optimizer (the reference's probe ran its own, AdamW
    for every probe of a model that trains with Adafactor)."""
    prelude, period, n_repeat = cfg.layout()
    fd = len(prelude)
    plen = len(period)
    S_real = shape.seq_len
    if shape.kind == "train" and S_real <= 4096:
        seqs = [S_real]
    else:
        seqs = [2048, 4096]
    pts: dict[tuple[int, int], dict[str, Any]] = {}
    for m in (1, 2):
        for s in seqs:
            pts[(m, s)] = _probe_point(cfg, shape, mesh, rules, fd + m * plen,
                                       s, attn_bypass=attn_bypass,
                                       ssm_bypass=ssm_bypass)

    def extrapolate(metric: str) -> float:
        if len(seqs) == 1:
            s = seqs[0]
            d = pts[(2, s)][metric] - pts[(1, s)][metric]
            base = pts[(1, s)][metric] - d
            return base + n_repeat * d
        s1, s2 = seqs
        d1 = pts[(2, s1)][metric] - pts[(1, s1)][metric]
        d2 = pts[(2, s2)][metric] - pts[(1, s2)][metric]
        b1 = pts[(1, s1)][metric] - d1
        b2 = pts[(1, s2)][metric] - d2
        if shape.kind == "decode":
            # per-period cost is affine in cache length
            slope = (d2 - d1) / (s2 - s1)
            dS = d1 + slope * (S_real - s1)
            bslope = (b2 - b1) / (s2 - s1)
            bS = b1 + bslope * (S_real - s1)
        else:
            # per-period cost = a*S + q*S^2 ; base is linear in S
            q = (d2 / s2 - d1 / s1) / (s2 - s1)
            a = d1 / s1 - q * s1
            dS = a * S_real + q * S_real * S_real
            bS = b2 * (S_real / s2)
        return max(bS + n_repeat * dS, 0.0)

    out = {
        "flops": extrapolate("flops"),
        "bytes": extrapolate("bytes"),
        "coll": extrapolate("coll"),
        "coll_nvlink": extrapolate("coll_nvlink"),
        "probe_points": {f"{m}x{s}": pts[(m, s)] for (m, s) in pts},
    }
    if shape.kind == "train":
        for k in ("flops", "bytes", "coll", "coll_nvlink"):
            out[k] *= REMAT_FACTOR
        out["remat_factor"] = REMAT_FACTOR
    if ssm_bypass and shape.kind != "decode":
        # analytic traffic of the fused selective-scan kernel (per rank):
        # inputs delta,u (B,S,C_loc) + Bm,Cm (B,S,N) + output y (B,S,C_loc)
        n_mamba = sum(
            1 for i in range(cfg.n_layers) if cfg.layer_spec(i).mixer == "mamba"
        )
        if n_mamba:
            mesh_model = _mesh_axis(mesh, "model")
            dp = 1
            for a in rules.dp:
                dp *= _mesh_axis(mesh, a)
            B_loc = max(shape.global_batch // dp, 1)
            C_loc = cfg.d_inner_ // mesh_model
            N = cfg.ssm_state
            k_bytes = B_loc * S_real * (3 * C_loc + 2 * N) * 4.0
            k_flops = B_loc * S_real * C_loc * N * 8.0
            mult = (2.0 + 1.0) if shape.kind == "train" else 1.0  # fwd+rec+bwd
            out["bytes"] += n_mamba * k_bytes * mult
            out["flops"] += n_mamba * k_flops * mult
            out["ssm_pallas_added"] = {
                "layers": n_mamba, "bytes_per_layer": k_bytes,
                "flops_per_layer": k_flops,
            }
    if attn_bypass and shape.kind != "decode":
        # analytic traffic of the fused flash-attention kernel: q/k/v reads
        # + out write (bf16), flops = 2 matmuls over the (masked) scores
        n_attn = sum(
            1 for i in range(cfg.n_layers) if cfg.layer_spec(i).mixer == "attn"
        )
        if n_attn:
            mesh_model = _mesh_axis(mesh, "model")
            dp = 1
            for a in rules.dp:
                dp *= _mesh_axis(mesh, a)
            B_loc = max(shape.global_batch // dp, 1)
            hq = cfg.n_heads
            hq_loc = hq // mesh_model if hq % mesh_model == 0 else hq
            hkv_loc = (
                cfg.n_kv_heads // mesh_model
                if cfg.n_kv_heads % mesh_model == 0
                else cfg.n_kv_heads
            )
            D = cfg.head_dim
            a_bytes = B_loc * S_real * D * 2.0 * (2 * hq_loc + 2 * hkv_loc)
            # causal wedge halves the score work; sliding window caps it
            pairs = 0.0
            for i in range(cfg.n_layers):
                sp = cfg.layer_spec(i)
                if sp.mixer != "attn":
                    continue
                if sp.window:
                    pairs += min(S_real * sp.window, S_real * S_real / 2)
                elif cfg.causal:
                    pairs += S_real * S_real / 2
                else:
                    pairs += S_real * S_real
            a_flops = 4.0 * B_loc * hq_loc * D * pairs
            mult = 4.0 if shape.kind == "train" else 1.0   # fwd+rec+bwd(2x)
            out["bytes"] += n_attn * a_bytes * mult
            out["flops"] += a_flops * mult
            out["attn_pallas_added"] = {
                "layers": n_attn, "bytes_per_layer": a_bytes,
                "flops_total": a_flops,
            }
    return out


def _mesh_axis(mesh, name: str) -> int:
    from repro_torch.distributed.sharding import mesh_axes

    return mesh_axes(mesh).get(name, 1)


def model_flops_for(cfg: ArchConfig, shape: ShapeConfig) -> float:
    n_active = cfg.n_active_params()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.global_batch * shape.seq_len
    return 2.0 * n_active * shape.global_batch     # one token per sequence


def ideal_bytes_for(cfg: ArchConfig, shape: ShapeConfig, n_dev: int) -> float:
    """Per-device mandatory-HBM-traffic floor (speed-of-light memory)."""
    n = cfg.n_params()
    if shape.kind == "train":
        # optimizer floor: fp32 params r+w, adam m/v r+w (adafactor ~r+w p)
        mult = 12.0 if cfg.n_params() > 1e11 else 24.0
        return mult * n / n_dev
    if shape.kind == "prefill":
        return 4.0 * n / n_dev     # fp32 params read once (floor)
    # decode: params read (all experts touched when B*k >= E) + cache read
    B, S = shape.global_batch, shape.seq_len
    if cfg.n_experts and B * cfg.top_k < cfg.n_experts:
        n_read = cfg.n_active_params()
    else:
        n_read = n
    cache_b = 0.0
    for i in range(cfg.n_layers):
        if cfg.layer_spec(i).mixer == "attn":
            cache_b += 2.0 * B * S * cfg.n_kv_heads * cfg.head_dim * 2
        else:
            cache_b += B * cfg.d_inner_ * cfg.ssm_state * 4.0
    param_bytes = 2.0 if SERVE_SHARDING else 4.0   # bf16 serving weights
    return (param_bytes * n_read + cache_b) / n_dev


def cell_roofline(cfg: ArchConfig, shape: ShapeConfig, mesh,
                  rules: AxisRules, n_devices: int, **cell_kw):
    """``(roofline dict, probe points)`` of the cell from its probes."""
    pc = probe_costs(cfg, shape, mesh, rules, **cell_kw)
    coll = cost_analysis.CollectiveStats(wire_bytes=pc["coll"],
                                         nvlink_bytes=pc["coll_nvlink"])
    rf = cost_analysis.roofline(
        {"flops": pc["flops"], "bytes accessed": pc["bytes"]},
        coll,
        model_flops=model_flops_for(cfg, shape),
        n_devices=n_devices,
        ideal_bytes_per_device=ideal_bytes_for(cfg, shape, n_devices),
    )
    return rf, pc["probe_points"]


# ---------------------------------------------------------------------------
# cells
# ---------------------------------------------------------------------------

def production_mesh(mesh_kind: str):
    from repro_torch.launch.mesh import make_production_mesh

    return make_production_mesh(multi_pod=(mesh_kind == "multi"),
                                device_type="meta")


def run_cell(
    arch_name: str, shape_name: str, mesh_kind: str, out_dir: str,
    *, do_probe: bool = True,
) -> dict[str, Any]:
    """One cell over its fake world: the skip of
    ``configs.base.shape_applicability``, else the memory dict and, on the
    single pod, the roofline; written as the reference names it."""
    cfg = get_arch(arch_name)
    shape = SHAPES[shape_name]
    skip = shape_applicability(cfg, shape)
    result: dict[str, Any] = {
        "arch": arch_name, "shape": shape_name, "mesh": mesh_kind,
    }
    if skip:
        result["status"] = "skip"
        result["reason"] = skip
        return result

    with fake_world(production_world(mesh_kind)):
        mesh = production_mesh(mesh_kind)
        rules = AxisRules.for_mesh(mesh)
        n_dev = mesh.size()
        mem = peak_memory(cfg, shape, mesh, rules)
        result.update(
            status="ok",
            n_devices=n_dev,
            compile_s=round(mem["trace_s"], 2),
            depth=mem["depth"],
            memory={k: mem[k] for k in (
                "argument_size_in_bytes", "output_size_in_bytes",
                "temp_size_in_bytes", "peak_bytes")},
        )
        if do_probe and mesh_kind == "single":   # roofline table is single-pod
            rf, points = cell_roofline(cfg, shape, mesh, rules, n_dev)
            result["roofline"] = rf
            result["probe"] = points

    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{mesh_kind}__{arch_name}__{shape_name}.json")
    with open(path, "w") as f:
        json.dump(result, f, indent=1)
    return result


def paper_collectives(q_loc: int, k: int, data_group) -> \
        cost_analysis.CollectiveStats:
    """The distributed search step's collectives on one rank, counted from
    its calls to ``search/distributed.py``'s two helpers (a staged plan with
    the global budget, no guards): ``global_budget_limit_fn``'s all-gathers
    of the (Q_loc,) f32 k-th bound and the (Q_loc,) int32 survivor mass
    (``:140``, ``:142``; one compaction a step), the step's all-gathers of
    the (Q_loc, k) f32 distances and int32 ids (``:309-310``) and its
    all-reduce of the (Q_loc,) int32 ``n_dtw`` (``:327``), all over the
    data axes' group ``data_group``."""
    g = data_group.size()
    nvlink = cost_analysis._in_one_node(data_group)
    stats = cost_analysis.CollectiveStats()
    if g == 1:
        return stats
    for kind, b in (("all-gather", q_loc * 4 * g), ("all-gather", q_loc * 4 * g),
                    ("all-gather", q_loc * k * 4 * g),
                    ("all-gather", q_loc * k * 4 * g),
                    ("all-reduce", q_loc * 4)):
        stats.add(kind, cost_analysis.wire_bytes(kind, b, g), nvlink=nvlink)
    return stats


def run_paper_cell(mesh_kind: str, out_dir: str) -> dict[str, Any]:
    """Dry-run the paper's own workload: distributed LB_ENHANCED NN-DTW.

    The verification loop's trip count depends on the data, so nothing is
    traced: the store's seven leaves are placed on meta for the argument
    bytes (the port's step takes the whole query batch on every rank),
    the outputs are counted from the step's, the collectives come from
    ``paper_collectives``, and the FLOPs and bytes are the reference's
    analytic charge of the expected verify rounds.  The temporaries are not
    measured."""
    from repro_torch.configs.paper_dtw import PAPER_SEARCH
    from repro_torch.search.distributed import _axes

    pc = PAPER_SEARCH
    N, L, Q = pc.n_store, pc.length, pc.n_queries
    with fake_world(production_world(mesh_kind)):
        mesh = production_mesh(mesh_kind)
        rules = AxisRules.for_mesh(mesh)
        n_dev = mesh.size()
        q_shards = _mesh_axis(mesh, "model")
        dp_size = n_dev // q_shards
        N_loc, Q_loc = N // dp_size, Q // q_shards
        dp = tuple(rules.dp)
        t0 = time.time()

        def put(shp, dtype, spec):
            return distribute(torch.empty(shp, dtype=dtype, device=META),
                              NamedSharding(mesh, spec))

        leaves = (
            put((N, L), torch.float32, (dp, None)),      # series
            put((N,), torch.int32, (dp,)),               # labels
            put((N, L), torch.float32, (dp, None)),      # upper
            put((N, L), torch.float32, (dp, None)),      # lower
            put((N, 4), torch.float32, (dp, None)),      # kim
            put((N, 2), torch.bool, (dp, None)),         # kim_ok
            put((Q, L), torch.float32, (None, None)),    # queries, whole
        )
        args = local_bytes(leaves)
        # (dists f32, global ids int32) (Q_loc, k) and n_dtw int32 (Q_loc,)
        outs = Q_loc * pc.k * (4 + 4) + Q_loc * 4
        coll = paper_collectives(Q_loc, pc.k, _axes(mesh, dp).group)
        t_build = time.time() - t0

    # Analytic per-device costs (the verification while-loop's trip count is
    # data-dependent; we charge the expected number of verify rounds):
    nb = min(pc.v, pc.w, L // 2)
    store_bytes = 2 if STORE_BF16 else 4   # series+envelope element size
    lb_flops = Q_loc * N_loc * (4.0 * L + 4.0 * nb * nb)        # bridge + bands
    dtw_flops = Q_loc * pc.expected_verify * 10.0 * L * L       # wavefront DP
    sort_flops = Q_loc * N_loc * 30.0                           # argsort log N
    flops = lb_flops + dtw_flops + sort_flops
    bytes_ = (
        N_loc * L * store_bytes * 3       # series + envelopes read per tile
        * max(Q_loc // LB_TILE_Q, 1)      # re-read per query kernel tile
        + Q_loc * N_loc * 4 * 4           # lb matrix + argsort traffic
    )
    useful = Q * (N * 4.0 * L + pc.expected_verify * 2.0 * L * (2 * pc.w + 1))
    rf = cost_analysis.roofline(
        {"flops": flops, "bytes accessed": float(bytes_)}, coll,
        model_flops=useful, n_devices=n_dev,
    )
    result = {
        "arch": "paper-dtw-search", "shape": pc.name, "mesh": mesh_kind,
        "status": "ok", "n_devices": n_dev,
        "lower_s": round(t_build, 2), "compile_s": 0.0,
        "memory": {
            "argument_size_in_bytes": args,
            "output_size_in_bytes": outs,
            "temp_size_in_bytes": None,
        },
        "roofline": rf,
        "note": "flops/bytes analytic (data-dependent verify loop); "
                "collectives counted from the step's helper calls; "
                "temporaries not measured",
    }
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir,
                           f"{mesh_kind}__paper-dtw-search__{pc.name}.json"),
              "w") as f:
        json.dump(result, f, indent=1)
    return result


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--paper", action="store_true")
    ap.add_argument("--no-probe", action="store_true")
    ap.add_argument("--out", default="results/dryrun")
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args()

    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    cells: list[tuple[str, str]] = []
    if args.all:
        cells = [(a, s) for a in ARCHS for s in SHAPES]
    elif args.arch:
        shapes = [args.shape] if args.shape else list(SHAPES)
        cells = [(args.arch, s) for s in shapes]

    failures = 0
    t_all = time.time()
    for mk in meshes:
        if args.paper:
            r = run_paper_cell(mk, args.out)
            print(f"[{mk}] paper-dtw-search: {r['status']} "
                  f"dominant={r['roofline']['dominant']}", flush=True)
        for a, s in cells:
            path = os.path.join(args.out, f"{mk}__{a}__{s}.json")
            if args.skip_existing and os.path.exists(path):
                print(f"[{mk}] {a} x {s}: cached", flush=True)
                continue
            try:
                t0 = time.time()
                r = run_cell(a, s, mk, args.out, do_probe=not args.no_probe)
                if r["status"] == "skip":
                    print(f"[{mk}] {a} x {s}: SKIP ({r['reason']})", flush=True)
                    os.makedirs(args.out, exist_ok=True)
                    with open(path, "w") as f:
                        json.dump(r, f, indent=1)
                else:
                    rf = r.get("roofline")
                    extra = (
                        f"dominant={rf['dominant']} "
                        f"frac={rf['roofline_fraction']:.3f}"
                        if rf else ""
                    )
                    print(
                        f"[{mk}] {a} x {s}: ok wall={time.time()-t0:.0f}s "
                        f"trace={r['compile_s']}s temp_gb="
                        f"{r['memory'].get('temp_size_in_bytes', 0)/2**30:.2f} "
                        + extra,
                        flush=True,
                    )
            except Exception as e:  # noqa: BLE001 — report and continue
                failures += 1
                print(f"[{mk}] {a} x {s}: FAIL {type(e).__name__}: {e}",
                      flush=True)
                traceback.print_exc()
    print(f"dry-run wall {time.time() - t_all:.1f} s", flush=True)
    if failures:
        raise SystemExit(f"{failures} dry-run cells failed")


if __name__ == "__main__":
    main()
