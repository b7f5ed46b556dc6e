"""Elastic scaling + straggler mitigation policy (port of
``repro.distributed.elastic``, the same rules).

``plan_mesh`` re-derives a (data, model)[, pod] mesh for whatever rank
count survives a failure; together with ``train.checkpoint``'s
reshard-on-restore this is the restart path: lose a host -> relaunch with
the surviving ranks -> same checkpoint, new mesh, training continues.  The
model axis is kept at the largest power-of-two divisor <= preferred_tp of
the count, because the TP size changes activation sharding but never
numerics.

``Heartbeat`` is the straggler/liveness primitive the launcher monitors:
each host replaces its file every step (write to ``<path>.tmp``, then
``os.replace``, so a reader never sees half a beat); the monitor evicts
hosts whose heartbeat age exceeds the deadline.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    shape: tuple[int, ...]
    axes: tuple[str, ...]


def plan_mesh(
    n_devices: int,
    *,
    preferred_tp: int = 16,
    pods: int = 1,
) -> MeshPlan:
    """Choose mesh factors for an arbitrary surviving device count."""
    per_pod = n_devices // pods
    tp = preferred_tp
    while tp > 1 and per_pod % tp:
        tp //= 2
    data = per_pod // tp
    if pods > 1:
        return MeshPlan((pods, data, tp), ("pod", "data", "model"))
    return MeshPlan((data, tp), ("data", "model"))


@dataclasses.dataclass
class Heartbeat:
    """Per-host liveness file; the launcher monitors heartbeat age."""

    path: str
    host_id: int = 0

    def beat(self, step: int) -> None:
        tmp = f"{self.path}.tmp"
        with open(tmp, "w") as f:
            json.dump({"host": self.host_id, "step": step, "t": time.time()}, f)
        os.replace(tmp, self.path)

    def age(self) -> float | None:
        try:
            with open(self.path) as f:
                return time.time() - json.load(f)["t"]
        except (FileNotFoundError, json.JSONDecodeError):
            return None

    def is_straggler(self, deadline_s: float) -> bool:
        age = self.age()
        return age is None or age > deadline_s
