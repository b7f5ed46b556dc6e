#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py            # one CUDA card, from the repo root
    python3 chip_smoke.py --profile  # also profile one warm nn_search

1. prints the card (``nvidia-smi`` name and power limit) and builds the
   four CUDA kernels from ``src/repro_torch/csrc`` (``nvcc``, ``sm_90a``);
2. drives the main path once at full size -- ``build_index`` ->
   ``classify`` (which runs ``nn_search``) on N = 16384 store series of
   length L = 512 (w = 51, V = 4, k = 1, Q = 256 queries) -- with every
   kernel's launch count set to 0 just before and read just after, and
   records the inputs each kernel was given there;
3. holds each kernel against its plain PyTorch version on the card: at
   the main path's recorded inputs (timed with CUDA events) and over a
   sweep of small shapes (w in {0, 1, L/4, L}, odd L, cutoffs that kill
   pairs, ``live`` masks with all-dead tiles, ragged sizes).  Envelopes,
   banded DTW and the bands-only LB_ENHANCED must be bit-equal, with the
   same +-inf positions; the full LB_ENHANCED forms agree to
   rtol 1e-5, atol 1e-6 (their L-term sums run in another order);
4. checks the search: finite distances, neighbour ids equal to the
   kernel brute force for the first 64 queries and to a brute force
   through the plain DTW for the first 8, distances bit-equal;
5. prints one ``{"kernels": [...]}`` line and, last, the device line
   ``{"ok": true, "device": {...}}``.

Any failed check exits non-zero before the last line.  The script imports
nothing of the JAX package; without a CUDA device it exits 1.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM peaks (NVIDIA data sheet, 700 W): HBM3 bytes/s, FP32 non-tensor
# FLOP/s
PEAK_BYTES = 3.35e12
PEAK_FP32 = 67e12

# main-path configuration: the store is ~100 MB of f32 on the card with
# its two envelopes, the scale of the largest UCR training sets
MAIN = dict(n_classes=8, n_train_per_class=2048, n_test_per_class=32,
            length=512, seed=7)
V = 4
K = 1
VERIFY_CHUNK = 32

RTOL, ATOL = 1e-5, 1e-6


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean milliseconds per call over ``reps`` calls, CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def compare(name: str, got, want, exact: bool) -> float:
    """Max abs difference of finite entries; the +-inf positions must
    match.  ``exact`` demands equal values (``torch.equal``; -0.0 == 0.0),
    otherwise rtol 1e-5, atol 1e-6."""
    import torch

    got = [got] if isinstance(got, torch.Tensor) else list(got)
    want = [want] if isinstance(want, torch.Tensor) else list(want)
    err = 0.0
    for g, w in zip(got, want):
        check(g.shape == w.shape, f"{name}: shape {tuple(g.shape)} != "
              f"{tuple(w.shape)}")
        check(not torch.isnan(g).any().item(), f"{name}: NaN in output")
        check(torch.equal(torch.isposinf(g), torch.isposinf(w))
              and torch.equal(torch.isneginf(g), torch.isneginf(w)),
              f"{name}: +-inf positions differ from the plain version")
        fin = torch.isfinite(w)
        if exact:
            check(torch.equal(g[fin], w[fin]),
                  f"{name}: not bit-equal to the plain version")
        else:
            check(torch.allclose(g[fin], w[fin], rtol=RTOL, atol=ATOL),
                  f"{name}: outside rtol={RTOL}, atol={ATOL}")
        if fin.any():
            err = max(err, (g[fin] - w[fin]).abs().max().item())
    return err


class Recorder:
    """Wraps a kernel wrapper in ``kernels.ops`` to keep the inputs of its
    largest call on the main path (the count stays the wrapper's own).
    It keeps references, not copies, so the timed path does no extra
    work: the path makes every kernel input afresh and never writes to
    one after the launch."""

    def __init__(self, ops_module, attr: str):
        self.ops, self.attr = ops_module, attr
        self.orig = getattr(ops_module, attr)
        self.args = self.kwargs = None
        self.size = -1
        setattr(ops_module, attr, self)

    def __call__(self, *args, **kwargs):
        size = args[0].numel()
        if size > self.size:
            self.size, self.args, self.kwargs = size, args, kwargs
        return self.orig(*args, **kwargs)

    def restore(self):
        setattr(self.ops, self.attr, self.orig)


def run_main_path(torch, dev):
    """build_index -> classify at full size, counts set to 0 just before
    and read just after.  Returns what the later phases need."""
    from repro_torch.data import make_dataset
    from repro_torch.kernels import _build, ops
    from repro_torch.search import (CascadeConfig, EngineConfig,
                                    build_index, classify, nn_search)

    ds = make_dataset(**MAIN)
    L = ds.length
    w = int(0.1 * L)
    cfg = EngineConfig(cascade=CascadeConfig(w=w, v=V), verify_chunk=VERIFY_CHUNK,
                       k=K)
    recs = {n: Recorder(ops, n) for n in
            ("envelope_cuda", "lb_enhanced_cuda",
             "lb_enhanced_pairwise_cuda", "dtw_band_cuda")}
    torch.cuda.synchronize()
    _build.reset_counts()
    t0 = time.perf_counter()
    index = build_index(ds.x_train, w, ds.y_train, device=dev)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    pred, res = classify(index, ds.x_test, cfg)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = _build.counts()
    for r in recs.values():
        r.restore()

    # steady state: the same search again (survivor budget memoised)
    t3 = time.perf_counter()
    res2 = nn_search(index, ds.x_test, cfg)
    torch.cuda.synchronize()
    t4 = time.perf_counter()
    check(torch.equal(res2.idx, res.idx) and torch.equal(res2.dists,
                                                         res.dists),
          "a repeated nn_search gave another result")

    y = torch.as_tensor(ds.y_test, device=dev)
    acc = (pred.long() == y.long()).float().mean().item()
    n_dtw = res.n_dtw.float()
    summary = {
        "N": index.n, "L": L, "w": w, "v": V, "k": K, "Q": len(ds.x_test),
        "verify_chunk": VERIFY_CHUNK,
        "build_index_s": t1 - t0, "classify_s": t2 - t1,
        "nn_search_warm_s": t4 - t3,
        "mean_n_dtw": n_dtw.mean().item(),
        "pruning_power": res.pruning_power().mean().item(),
        "accuracy": acc, "launches": launches,
    }
    print("main path: " + json.dumps(summary))
    return ds, index, cfg, res, launches, recs


def check_search(torch, ds, index, cfg, res):
    from repro_torch.search import brute_force

    w = cfg.cascade.w
    N = index.n
    check(res.dists.shape == (len(ds.x_test), K), "dists shape")
    check(torch.isfinite(res.dists).all().item(), "non-finite distances")
    check(((res.idx >= 0) & (res.idx < N)).all().item(), "ids out of range")
    q64 = ds.x_test[:64]
    t0 = time.perf_counter()
    bd, bi = brute_force(index, q64, w, k=K)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    check(torch.equal(bi, res.idx[:64]),
          "neighbour ids differ from the kernel brute force")
    check(torch.equal(bd, res.dists[:64]),
          "distances not bit-equal to the kernel brute force")
    pd, pi = brute_force(index, ds.x_test[:8], w, k=K, use_kernels=False,
                         chunk=N)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    check(torch.equal(pi, res.idx[:8]),
          "neighbour ids differ from the plain-DTW brute force")
    check(torch.equal(pd, res.dists[:8]),
          "distances not bit-equal to the plain-DTW brute force")
    print(f"search check: ids and distances equal to brute force "
          f"(kernel, 64 queries, {t1 - t0:.3f} s; plain DTW, 8 queries, "
          f"{t2 - t1:.3f} s)")


def profile_search(torch, ds, index, cfg) -> None:
    """``--profile``: one warm ``nn_search`` under ``torch.profiler``;
    prints the wall time, the summed device time of every kernel (the
    device's busy time: one stream, so launches do not overlap) and the
    kernels that took most of it."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.search import nn_search

    nn_search(index, ds.x_test, cfg)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        nn_search(index, ds.x_test, cfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0)
        if us > 0:
            rows.append((e.key[:60], e.count, us / 1e3))
    rows.sort(key=lambda r: -r[2])
    busy = sum(r[2] for r in rows) / 1e3
    print("profile (warm nn_search, profiled): " + json.dumps({
        "wall_s": wall, "device_busy_s": busy,
        "idle_share": 1.0 - busy / wall,
        "top_kernels_name_count_ms": rows[:12]}))


def band_cells(L: int, w: int) -> int:
    wb = min(L if w >= L else w, L - 1)
    return L * (2 * wb + 1) - wb * (wb + 1)


def bound(bytes_: float, ops_: float) -> tuple[float, str]:
    tb, to = bytes_ / PEAK_BYTES * 1e3, ops_ / PEAK_FP32 * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def band_ops(nb: int) -> int:
    """Least FP32 operations of the elastic bands per pair.  Band ``bi``
    of each end has 2 bi + 1 distinct arm cells: one subtract each, 2 bi
    mins of the |differences| (|.| is free on the card, an operand
    modifier) and one multiply to square the least; each end sums its nb
    minima (nb - 1 adds) and one add joins the ends:
    4 nb^2 + 2 nb - 1 in all (71 at nb = 4)."""
    return 4 * nb * nb + 2 * nb - 1


def kernel_phases(torch, dev, recs, launches):
    """Each kernel against its plain version at the main path's inputs
    (timed) and over a small sweep.  Returns the ``kernels`` records."""
    import torch.nn.functional as F

    from repro_torch.core.lower_bounds import _n_bands
    from repro_torch.kernels import ref
    from repro_torch.kernels.dtw_band import dtw_band_cuda
    from repro_torch.kernels.envelope import envelope_cuda
    from repro_torch.kernels.lb_enhanced import lb_enhanced_cuda
    from repro_torch.kernels.lb_enhanced_pairwise import (
        lb_enhanced_pairwise_cuda)

    gen = torch.Generator(device="cpu").manual_seed(11)

    def randn(*shape):
        return torch.randn(*shape, generator=gen).to(dev)

    out = []

    # ---- K1 envelope ------------------------------------------------------
    b, w = recs["envelope_cuda"].args
    N, L = b.shape
    err = compare("envelope", envelope_cuda(b, w), ref.envelope_ref(b, w),
                  exact=True)
    for n, Ls, ws in [(5, 33, 0), (7, 33, 1), (3, 67, 16), (4, 64, 64),
                      (2, 16384, 51), (3, 1001, 999), (1, 1, 0)]:
        x = randn(n, Ls)
        compare(f"envelope sweep {(n, Ls, ws)}", envelope_cuda(x, ws),
                ref.envelope_ref(x, ws), exact=True)
    stacked = torch.stack([b, -b])
    bms, by = bound(12.0 * N * L, 6.0 * N * L)
    out.append(dict(
        name="envelope", route="cuda", source="src/repro_torch/csrc/envelope.cu",
        replaces="src/repro/kernels/envelope.py:72",
        launches=launches["envelope"], max_abs_err=err,
        ms=time_ms(lambda: envelope_cuda(b, w), 20),
        plain_ms=time_ms(lambda: ref.envelope_ref(b, w), 5),
        bound_ms=bms, bound_by=by,
        library_ms=time_ms(lambda: F.max_pool1d(
            stacked, 2 * w + 1, stride=1, padding=w), 20),
        shape=f"N={N} L={L} w={w}"))

    # ---- K2 cross-block LB_ENHANCED (bands-only on the path) --------------
    args = recs["lb_enhanced_cuda"].args
    kw = recs["lb_enhanced_cuda"].kwargs
    q, c, u, lo, w2, v = args
    check(kw.get("bands_only") is True, "the bands tier ran the full form")
    Q, L = q.shape
    C = c.shape[0]
    nb = _n_bands(L, w2, v)
    err = compare("lb_enhanced bands", lb_enhanced_cuda(*args, **kw),
                  ref.lb_enhanced_ref(*args, **kw), exact=True)
    err_full = compare("lb_enhanced full",
                       lb_enhanced_cuda(q, c, u, lo, w2, v),
                       ref.lb_enhanced_ref(q, c, u, lo, w2, v), exact=False)
    for Qs, Cs, Ls, ws, vs in [(3, 37, 33, 8, 4), (9, 70, 64, 1, 4),
                               (5, 33, 31, 0, 4), (4, 40, 24, 24, 8),
                               (2, 65, 9, 9, 4)]:
        qs, cs = randn(Qs, Ls), randn(Cs, Ls)
        us, ls = ref.envelope_ref(cs, ws)
        live = torch.rand(Cs, generator=gen).to(dev) > 0.3
        live[:32] = False                             # an all-dead tile
        for lv in (None, live):
            compare("lb_enhanced bands sweep",
                    lb_enhanced_cuda(qs, cs, us, ls, ws, vs, live=lv,
                                     bands_only=True),
                    ref.lb_enhanced_ref(qs, cs, us, ls, ws, vs, live=lv,
                                        bands_only=True), exact=True)
            compare("lb_enhanced full sweep",
                    lb_enhanced_cuda(qs, cs, us, ls, ws, vs, live=lv),
                    ref.lb_enhanced_ref(qs, cs, us, ls, ws, vs, live=lv),
                    exact=False)
    bms, by = bound(4.0 * Q * C + 8.0 * nb * (Q + C),
                    float(band_ops(nb)) * Q * C)
    out.append(dict(
        name="lb_enhanced", route="cuda",
        source="src/repro_torch/csrc/lb_enhanced.cu",
        replaces="src/repro/kernels/lb_enhanced.py:132",
        launches=launches["lb_enhanced"], max_abs_err=err,
        ms=time_ms(lambda: lb_enhanced_cuda(*args, **kw), 50),
        plain_ms=time_ms(lambda: ref.lb_enhanced_ref(*args, **kw), 5),
        bound_ms=bms, bound_by=by, library_ms=None,
        shape=f"Q={Q} C={C} L={L} w={w2} v={v} bands_only",
        full_form_max_abs_err=err_full,
        full_form_ms=time_ms(lambda: lb_enhanced_cuda(q, c, u, lo, w2, v),
                             20)))

    # ---- K3 pairwise LB_ENHANCED ------------------------------------------
    args = recs["lb_enhanced_pairwise_cuda"].args
    kw = recs["lb_enhanced_pairwise_cuda"].kwargs
    q, c, u, lo, w3, v = args
    P, L = q.shape
    err = compare("lb_enhanced_pairwise",
                  lb_enhanced_pairwise_cuda(*args, **kw),
                  ref.lb_enhanced_pairwise_ref(*args, **kw), exact=False)
    for Ps, Ls, ws in [(9, 33, 7), (130, 47, 11), (70, 64, 64), (16, 5, 4),
                       (33, 8, 1), (40, 31, 0)]:
        qs, cs = randn(Ps, Ls), randn(Ps, Ls)
        us, ls = ref.envelope_ref(cs, ws)
        live = torch.rand(Ps, generator=gen).to(dev) > 0.3
        live[:8] = False                              # an all-dead block
        for lv in (None, live):
            compare("lb_enhanced_pairwise bands sweep",
                    lb_enhanced_pairwise_cuda(qs, cs, us, ls, ws, V,
                                              live=lv, bands_only=True),
                    ref.lb_enhanced_pairwise_ref(qs, cs, us, ls, ws, V,
                                                 live=lv, bands_only=True),
                    exact=True)
            compare("lb_enhanced_pairwise sweep",
                    lb_enhanced_pairwise_cuda(qs, cs, us, ls, ws, V,
                                              live=lv),
                    ref.lb_enhanced_pairwise_ref(qs, cs, us, ls, ws, V,
                                                 live=lv), exact=False)
    nb = _n_bands(L, w3, v)
    # the function reads q, u and lo over the bridge [nb, L - nb) and q, c
    # at the 2 nb band columns, and writes one bound per pair; each bridge
    # column costs two subtracts, two maxes, a multiply and an add
    bms, by = bound(12.0 * P * (L - 2 * nb) + 16.0 * nb * P + 4.0 * P,
                    6.0 * P * (L - 2 * nb) + float(band_ops(nb)) * P)
    out.append(dict(
        name="lb_enhanced_pairwise", route="cuda",
        source="src/repro_torch/csrc/lb_enhanced_pairwise.cu",
        replaces="src/repro/kernels/lb_enhanced_pairwise.py:122",
        launches=launches["lb_enhanced_pairwise"], max_abs_err=err,
        ms=time_ms(lambda: lb_enhanced_pairwise_cuda(*args, **kw), 20),
        plain_ms=time_ms(lambda: ref.lb_enhanced_pairwise_ref(*args, **kw),
                         3),
        bound_ms=bms, bound_by=by, library_ms=None,
        shape=f"P={P} L={L} w={w3} v={v}"))

    # ---- K4 banded DTW ----------------------------------------------------
    a, bb, w4, cut = recs["dtw_band_cuda"].args
    P, L = a.shape
    err_cut = compare("dtw_band (round cutoffs)", dtw_band_cuda(a, bb, w4, cut),
                      ref.dtw_band_ref(a, bb, w4, cut), exact=True)
    err = compare("dtw_band", dtw_band_cuda(a, bb, w4),
                  ref.dtw_band_ref(a, bb, w4), exact=True)
    for Ps, Ls, ws in [(37, 33, 0), (37, 33, 1), (37, 33, 8), (37, 33, 33),
                       (20, 100, 25), (5, 513, 51), (3, 1, 0), (6, 2, 5),
                       (4, 700, 700)]:
        xa, xb = randn(Ps, Ls), randn(Ps, Ls)
        exact_d = ref.dtw_band_ref(xa, xb, ws)
        cut_s = exact_d * (0.5 + torch.rand(Ps, generator=gen).to(dev))
        cut_s[::5] = float("-inf")                    # invalid slots
        for cs in (None, cut_s):
            compare(f"dtw_band sweep {(Ps, Ls, ws)}",
                    dtw_band_cuda(xa, xb, ws, cs),
                    ref.dtw_band_ref(xa, xb, ws, cs), exact=True)
    bms, by = bound(8.0 * P * L + 8.0 * P, 5.0 * band_cells(L, w4) * P)
    out.append(dict(
        name="dtw_band", route="cuda", source="src/repro_torch/csrc/dtw_band.cu",
        replaces="src/repro/kernels/dtw_band.py:323",
        launches=launches["dtw_band"], max_abs_err=max(err, err_cut),
        ms=time_ms(lambda: dtw_band_cuda(a, bb, w4), 20),
        plain_ms=time_ms(lambda: ref.dtw_band_ref(a, bb, w4), 2, warmup=1),
        bound_ms=bms, bound_by=by, library_ms=None,
        shape=f"P={P} L={L} w={w4} no cutoff",
        round_cutoffs_ms=time_ms(lambda: dtw_band_cuda(a, bb, w4, cut), 20)))
    return out


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port package is missing ({e}); run from "
              "the repository root", file=sys.stderr)
        return 1
    try:
        line = card_line()
        print(line)
        name = torch.cuda.get_device_name(0)
        print(f"device: {name} (torch {torch.__version__}, CUDA "
              f"{torch.version.cuda})")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        from repro_torch.kernels import _build

        t0 = time.perf_counter()
        lib_path = _build.build()
        _build.library()
        print(f"kernels built in {time.perf_counter() - t0:.1f} s: "
              f"{lib_path.name}")
        dev = torch.device("cuda:0")
        ds, index, cfg, res, launches, recs = run_main_path(torch, dev)
        for kname, n in launches.items():
            check(n > 0, f"kernel {kname} was not launched on the main path")
        check_search(torch, ds, index, cfg, res)
        if "--profile" in sys.argv[1:]:
            profile_search(torch, ds, index, cfg)
        kernels = kernel_phases(torch, dev, recs, launches)
        torch.cuda.synchronize()
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        return 1
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
