"""Distribution substrate (port of ``repro.distributed``): sharding
rules on a ``DeviceMesh`` (tensor, FSDP, expert and channel parallelism),
gradient compression, and elasticity (mesh planning, heartbeats)."""

from repro_torch.distributed.compression import CompressionConfig, compress_grads
from repro_torch.distributed.elastic import Heartbeat, MeshPlan, plan_mesh
from repro_torch.distributed.sharding import (
    AxisRules,
    activation_spec,
    batch_specs,
    cache_shardings,
    param_shardings,
    param_spec,
)

__all__ = [
    "AxisRules",
    "CompressionConfig",
    "Heartbeat",
    "MeshPlan",
    "activation_spec",
    "batch_specs",
    "cache_shardings",
    "compress_grads",
    "param_shardings",
    "param_spec",
    "plan_mesh",
]
