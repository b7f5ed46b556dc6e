"""Roofline terms of a traced step (the counterpart of
``repro.launch.hlo_analysis``).

The reference reads a compiled SPMD program: ``cost_analysis()`` gives
each device's FLOPs and bytes, and the collectives are parsed from the
optimised HLO text.  The port has no compiled program, so ``CostRecorder``
watches the eager step instead, as rank 0 runs it (DTensor ops are let
through to their local ops first, so every count is of rank 0's local
tensors: the per-device view that XLA's partitioned HLO gives):

  * ``flops``: ``torch.utils.flop_counter``'s formulas (FlopCounterMode's
    registry) applied to each local op.  They count the products (mm,
    bmm, convolutions, attention) only; XLA counts elementwise work too.
    FlopCounterMode itself, entered over DTensors, counts each op at its
    global shape, the whole mesh's work, so the registry is applied here
    below DTensor.
  * ``bytes accessed``: the sum of every dispatched op's input and output
    bytes on the local tensors (views, allocations and collectives move
    none here).  In eager PyTorch every op reads its inputs from device
    memory and writes its outputs back, so this is the eager program's
    traffic, less what the L2 catches.
  * collectives: the ``_c10d_functional`` ops that DTensor's
    redistributions issue (``_dtensor.shard_dim_alltoall`` among them), and
    the ``c10d`` all-gather and all-reduce of the distributed search's two
    helpers (``search/distributed.py:_all_gather``, ``_all_reduce``), with
    each call's tensor bytes and group size, in the reference's ring
    accounting:

      all-reduce        2 * bytes * (g-1)/g     (reduce-scatter + all-gather)
      all-gather        bytes * (g-1)/g         (bytes = gathered result)
      reduce-scatter    bytes_out * (g-1)       (bytes_out = local shard)
      all-to-all        bytes * (g-1)/g
      collective-permute bytes

``CostRecorder`` and ``rank_memory_tracker`` (the dry-run's peak) skip
what DTensor's sharding propagation runs on the side: meta tensors of the
global shapes, which on the card hold no device memory.

Hardware constants (one NVIDIA H100 SXM at its 700 W limit, NVIDIA's data
sheet): 989 TFLOP/s bf16 dense, 3.35 TB/s HBM3; a collective moves 450 GB/s
a direction over NVLink when its group lies within one node of 8 cards
(ranks in row-major order, ``rank // 8`` the node), else 50 GB/s, one
400 Gb/s NIC a card.  ``roofline`` takes each as a keyword argument.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

PEAK_FLOPS = 989e12
HBM_BW = 3.35e12
NVLINK_BW = 450e9
NETWORK_BW = 50e9
NODE_SIZE = 8


@dataclasses.dataclass
class CollectiveStats:
    wire_bytes: float = 0.0
    by_kind: dict[str, float] = dataclasses.field(default_factory=dict)
    count: int = 0
    # the wire bytes of collectives whose group lies within one node
    nvlink_bytes: float = 0.0

    def add(self, kind: str, b: float, *, nvlink: bool = False) -> None:
        self.wire_bytes += b
        self.by_kind[kind] = self.by_kind.get(kind, 0.0) + b
        self.count += 1
        if nvlink:
            self.nvlink_bytes += b


def wire_bytes(kind: str, b: float, g: int) -> float:
    """Per-rank wire bytes of one collective of ``b`` bytes (the gathered
    result for an all-gather, the local shard for a reduce-scatter) over a
    group of ``g`` ranks."""
    if kind == "all-reduce":
        return 2.0 * b * (g - 1) / g
    if kind in ("all-gather", "all-to-all"):
        return b * (g - 1) / g
    if kind == "reduce-scatter":
        return float(b) * (g - 1)
    if kind == "collective-permute":
        return float(b)
    raise ValueError(f"unknown collective {kind!r}")


def _nbytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) else 0


def _group(ref):
    """The process group of a functional collective's group name, or of a
    ``c10d`` op's boxed group."""
    import torch.distributed as dist

    if isinstance(ref, str):
        from torch.distributed.distributed_c10d import _resolve_process_group

        return _resolve_process_group(ref)
    if isinstance(ref, torch.ScriptObject):
        return dist.ProcessGroup.unbox(ref)
    return ref


def _in_one_node(group) -> bool:
    import torch.distributed as dist

    ranks = dist.get_process_group_ranks(group)
    return len({r // NODE_SIZE for r in ranks}) == 1


def _collectives() -> dict:
    """``{op: (kind, the op's bytes from (args, out), group from args)}``,
    for the ops this torch build has."""
    import torch.distributed.tensor  # noqa: F401  (registers _dtensor ops)

    def arg0(a, o):
        return _nbytes(a[0])

    def out(a, o):
        return _nbytes(o)

    table = {
        ("_c10d_functional", "all_gather_into_tensor"):
            ("all-gather", out, lambda a: a[2]),
        ("_c10d_functional", "reduce_scatter_tensor"):
            ("reduce-scatter", out, lambda a: a[3]),
        ("_c10d_functional", "all_reduce"): ("all-reduce", arg0,
                                             lambda a: a[2]),
        ("_c10d_functional", "all_reduce_"): ("all-reduce", arg0,
                                              lambda a: a[2]),
        ("_c10d_functional", "all_to_all_single"): ("all-to-all", arg0,
                                                    lambda a: a[3]),
        ("_dtensor", "shard_dim_alltoall"): ("all-to-all", arg0,
                                             lambda a: a[3]),
        ("c10d", "allgather_"): ("all-gather",
                                 lambda a, o: sum(map(_nbytes, a[0][0])),
                                 lambda a: a[2]),
        ("c10d", "allreduce_"): ("all-reduce",
                                 lambda a, o: sum(map(_nbytes, a[0])),
                                 lambda a: a[1]),
    }
    ops = {}
    for (ns, name), v in table.items():
        op = getattr(getattr(torch.ops, ns), name, None)
        if op is not None:
            ops[op] = v
    return ops


# ops that move no bytes of their own: allocations, metadata, waits
_NO_TRAFFIC = {"empty", "empty_strided", "empty_like", "new_empty",
               "new_empty_strided", "detach", "wait_tensor",
               "_wrap_tensor_autograd", "lift_fresh", "alias"}


class _SkipsPropagation:
    """A dispatch mode's marker of DTensor's sharding propagation: while
    DTensor works out an op's placements for the first time, it may run
    the op's decomposition on meta tensors of the *global* shapes outside
    a fake mode.  On the card those are meta tensors beside CUDA ones; in
    a trace on meta they look like rank 0's, so a mode that counts must
    skip them (``propagating``).  Entering the mode watches DTensor's
    uncached propagation; leaving it stops."""

    _prop_depth = 0

    @property
    def propagating(self) -> bool:
        from torch._guards import active_fake_mode

        return self._prop_depth > 0 or active_fake_mode() is not None

    def __enter__(self):
        from torch.distributed.tensor._sharding_prop import ShardingPropagator

        orig = ShardingPropagator.propagate_op_sharding_non_cached
        mode = self

        def watched(prop, *a, **kw):
            mode._prop_depth += 1
            try:
                return orig(prop, *a, **kw)
            finally:
                mode._prop_depth -= 1

        ShardingPropagator.propagate_op_sharding_non_cached = watched
        self._unwatch = lambda: setattr(
            ShardingPropagator, "propagate_op_sharding_non_cached", orig)
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._unwatch()


class CostRecorder(_SkipsPropagation, TorchDispatchMode):
    """Counts rank 0's local FLOPs, bytes accessed and collectives of
    whatever runs under it (module docstring).  Reads ``flops``,
    ``bytes_accessed`` and ``coll`` (a ``CollectiveStats``) after."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        self._flop_registry = flop_registry
        self._coll = _collectives()
        self.flops = 0.0
        self.bytes_accessed = 0.0
        self.coll = CollectiveStats()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented   # let DTensor run its local ops first
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self.propagating:
            return out   # DTensor's sharding propagation, not a real op
        packet = func._overloadpacket
        if packet in self._coll:
            kind, nbytes, group = self._coll[packet]
            pg = _group(group(args))
            g = pg.size()
            if g > 1:
                self.coll.add(kind, wire_bytes(kind, nbytes(args, out), g),
                              nvlink=_in_one_node(pg))
            return out
        if packet in self._flop_registry:
            self.flops += float(self._flop_registry[packet](
                *args, **kwargs, out_val=out))
        if func.is_view or packet.__name__ in _NO_TRAFFIC:
            return out
        ins, _ = tree_flatten((args, kwargs))
        outs, _ = tree_flatten(out)
        self.bytes_accessed += float(sum(map(_nbytes, ins))
                                     + sum(map(_nbytes, outs)))
        return out


def roofline(
    cost: dict[str, Any],
    coll: CollectiveStats,
    *,
    model_flops: float,
    n_devices: int,
    ideal_bytes_per_device: float = 0.0,
    peak_flops: float = PEAK_FLOPS,
    hbm_bw: float = HBM_BW,
    nvlink_bw: float = NVLINK_BW,
    network_bw: float = NETWORK_BW,
) -> dict[str, Any]:
    """The three roofline terms (seconds, per device) + bottleneck.

    ``roofline_fraction`` = speed-of-light step time / bound step time,
    where speed-of-light = max(useful-FLOPs time, mandatory-bytes time).
    The mandatory-bytes floor matters for decode (param+cache reads bound
    the step no matter how good the kernels are).  A collective's bytes
    cross NVLink when its group lies within one node, else the network.
    """
    flops = float(cost.get("flops", 0.0))
    mem_bytes = float(cost.get("bytes accessed", 0.0))
    compute_s = flops / peak_flops
    memory_s = mem_bytes / hbm_bw
    collective_s = (coll.nvlink_bytes / nvlink_bw
                    + (coll.wire_bytes - coll.nvlink_bytes) / network_bw)
    terms = {
        "compute": compute_s, "memory": memory_s, "collective": collective_s
    }
    dominant = max(terms, key=terms.get)
    step_s = max(terms.values())
    useful = model_flops / n_devices / peak_flops if model_flops else 0.0
    ideal_mem_s = ideal_bytes_per_device / hbm_bw
    sol_s = max(useful, ideal_mem_s)
    return {
        "flops_per_device": flops,
        "hbm_bytes_per_device": mem_bytes,
        "collective_bytes_per_device": coll.wire_bytes,
        "collective_by_kind": coll.by_kind,
        "n_collectives": coll.count,
        "compute_s": compute_s,
        "memory_s": memory_s,
        "collective_s": collective_s,
        "dominant": dominant,
        "bound_step_s": step_s,
        "model_flops": model_flops,
        "model_flops_per_device": model_flops / n_devices if model_flops else 0.0,
        "useful_compute_s": useful,
        "ideal_memory_s": ideal_mem_s,
        "speed_of_light_s": sol_s,
        "useful_flops_ratio": (model_flops / n_devices / flops) if flops and model_flops else 0.0,
        "roofline_fraction": sol_s / step_s if step_s else 0.0,
    }


def rank_memory_tracker():
    """``torch.distributed._tools.mem_tracker.MemTracker`` that skips
    DTensor's sharding propagation (``_SkipsPropagation``): the peak of
    rank 0's local storages only."""
    from torch.distributed._tools.mem_tracker import MemTracker

    class RankMemTracker(_SkipsPropagation, MemTracker):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if self.propagating:
                return func(*args, **(kwargs or {}))
            return super().__torch_dispatch__(func, types, args, kwargs)

    return RankMemTracker()
