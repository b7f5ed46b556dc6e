"""Device busy time, idle gaps and leading operations from one
``torch.profiler`` session (the session idioms of ``chip_smoke.py``:
a primed profiler and a pause before the first launch)."""

from __future__ import annotations

import time

import torch

# a pause between a session's start and its first launch: on the H100
# machine a session that starts long after the previous one lost its
# first kernel records without it
PAD_S = 0.2
TOP = 10
MARKER = "portbench.profiled_call"


def _prime() -> None:
    """Open sessions of 8 tiny kernels until one records all 8."""
    from torch.profiler import ProfilerActivity, profile

    x = torch.zeros(1, device="cuda")
    for _ in range(10):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(PAD_S)
            for _ in range(8):
                x.add_(1.0)
            torch.cuda.synchronize()
        n = sum(1 for e in prof.profiler.kineto_results.events()
                if e.device_type() == torch.autograd.DeviceType.CUDA)
        if n >= 8:
            return


def _union(spans: list[tuple[int, int]]) -> list[tuple[int, int]]:
    out: list[list[int]] = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def summarise(events, t0_ns: int, t1_ns: int) -> dict:
    """Busy seconds (the union of device activity inside ``[t0, t1]``),
    the window's seconds, the leading device operations and the longest
    idle gaps, each named by the innermost host operation running at its
    middle."""
    dev, host = [], []
    for e in events:
        s, d = e.start_ns(), e.duration_ns()
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if d > 0:
                dev.append((max(s, t0_ns), min(s + d, t1_ns), e.name()))
        elif d > 0:
            host.append((s, s + d, e.name()))
    dev = [x for x in dev if x[1] > x[0]]
    busy = _union([(s, e) for s, e, _ in dev])
    busy_ns = sum(e - s for s, e in busy)
    by_name: dict[str, int] = {}
    for s, e, name in dev:
        by_name[name] = by_name.get(name, 0) + (e - s)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    edges = [t0_ns] + [x for span in busy for x in span] + [t1_ns]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    gaps.sort(key=lambda g: g[0] - g[1])
    named = []
    for s, e in gaps[:TOP]:
        mid = (s + e) // 2
        inner = [h for h in host if h[0] <= mid < h[1]]
        name = min(inner, key=lambda h: h[1] - h[0])[2] if inner \
            else "no host operation"
        named.append([name[:96], (e - s) / 1e9])
    return {"busy_s": busy_ns / 1e9, "window_s": (t1_ns - t0_ns) / 1e9,
            "device_ops": [[n[:96], ns / 1e9] for n, ns in ops],
            "idle_gaps": named}


def profile_call(fn) -> tuple[object, dict]:
    """``fn()`` under a primed profiler; returns its result and
    ``summarise`` of the session over the call's span: from the start of
    a host marker around the call to its end, which follows the
    synchronisation that ends the call."""
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    _prime()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(PAD_S)
        with record_function(MARKER):
            out = fn()
            torch.cuda.synchronize()
    events = prof.profiler.kineto_results.events()
    mark = [e for e in events if e.name() == MARKER]
    if not mark:
        raise RuntimeError("the profiler recorded no span of the call")
    t0 = mark[0].start_ns()
    return out, summarise([e for e in events if e.name() != MARKER], t0,
                          t0 + mark[0].duration_ns())
