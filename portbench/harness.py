"""One run of one cell: set-up, warm-up, the measured window, the traced
batch, the metrics, and the check that decides ``correct``.

The window starts when its first batch is submitted and ends when the
last batch started before ``seconds`` had passed has completed and the
device is synchronised.  Batches run back to back.  Nothing is built or
compiled inside it: the kernels are built and loaded in set-up, and one
warm-up batch runs the cell's own shapes.
"""

from __future__ import annotations

import dataclasses
import time

import torch

from portbench import profiling, spec


@dataclasses.dataclass
class Record:
    """What a run measured; the metric readers read it."""

    cell: spec.Cell
    state: object
    setup_s: float
    window_s: float
    batches: int
    items: int
    counters: dict
    peak_window_bytes: int | None
    probes: object | None
    profile: dict | None


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize()


def _metrics(rec: Record, wanted: tuple) -> dict:
    out = {}
    for m in wanted:
        value = spec.reader(m["name"], rec.cell.root).read(rec)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def run(cell: spec.Cell, seed: int, seconds: float, trace: bool, *,
        device="cuda", started: float | None = None,
        since_start: float = 0.0) -> dict:
    """Run ``cell``; returns the result's fields (``correct``,
    ``attempted``, ``failed``, ``metrics``, ``device``, ``breakdown``
    with ``trace``, and ``check``: each number compared with its limit).

    ``started`` is the ``perf_counter`` reading taken at process start
    and ``since_start`` the seconds the process had run before it.
    """
    started = time.perf_counter() if started is None else started
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    drv = spec.system(cell)
    state = drv.prepare(cell.config, cell.traffic, seed, dev)
    drv.run_batch(state, "warmup", 0)
    _sync(dev)
    setup_peak = torch.cuda.max_memory_allocated() if on_card else None
    setup_s = since_start + time.perf_counter() - started
    if on_card:
        torch.cuda.reset_peak_memory_stats()

    probes = drv.probes(state) if trace else None
    if probes is not None:
        probes.install()
    outputs, items, profile = [], 0, None
    t0 = time.perf_counter()
    try:
        while True:
            b = len(outputs)
            if trace and on_card and b == 0:
                (n, out), profile = profiling.profile_call(
                    lambda: drv.run_batch(state, "window", 0))
            else:
                n, out = drv.run_batch(state, "window", b)
            outputs.append(out)
            items += n
            if time.perf_counter() - t0 >= seconds:
                break
        _sync(dev)
        window_s = time.perf_counter() - t0
    finally:
        if probes is not None:
            probes.remove()
    peak = torch.cuda.max_memory_allocated() if on_card else None

    rec = Record(cell=cell, state=state, setup_s=setup_s,
                 window_s=window_s, batches=len(outputs), items=items,
                 counters=drv.counters(state, outputs),
                 peak_window_bytes=peak, probes=probes, profile=profile)
    metrics = _metrics(rec, cell.per_layer if trace else cell.end_to_end)
    check = cell.run["check"]
    drv.free_program(state)
    numbers = drv.judge(state, outputs, int(check["queries"]),
                        int(check["check_every"]))
    limits = check["limits"]
    correct = bool(outputs) and all(
        numbers[k] <= float(limits[k]) for k in limits)
    result = {
        "correct": correct,
        "attempted": items,
        "failed": int(numbers.get("missing", 0)),
        "metrics": metrics,
        "device": {
            "platform": "gpu" if on_card else dev.type,
            "kind": torch.cuda.get_device_name(0) if on_card else dev.type,
            "count": cell.chips,
            "memory_peak_bytes": max(setup_peak, peak) if on_card else 0,
        },
    }
    if profile is not None:
        result["device"]["busy_s"] = profile["busy_s"]
        result["device"]["window_s"] = profile["window_s"]
        result["breakdown"] = {"device_ops": profile["device_ops"],
                               "idle_gaps": profile["idle_gaps"]}
    result["counters"] = {"batches": len(outputs),
                          "window_s": window_s, **rec.counters}
    result["check"] = {k: {"value": numbers[k], "limit": float(limits[k])}
                       for k in limits}
    return result
