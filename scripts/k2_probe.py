#!/usr/bin/env python3
"""Time K2's full form (the ``enhanced_dense`` tier) and K8 on one card,
and compare their outputs across two source trees.

    PYTHONPATH=src python3 scripts/k2_probe.py [--cases main,paper]
        [--save OUT.pt] [--against OUT.pt]

``repro_torch`` comes from ``PYTHONPATH``, and each source tree builds its
kernels into its own ``build/``, so two trees are compared on one card by
running the script once for each in one command (A, B, B, A).  ``--save``
writes the ``main`` case's K8 output to a file; ``--against`` reads such a
file (made by another tree) and reports whether this tree's K8 output is
bit-equal to it (the inputs are the same bits in both runs: the dataset
from its seed, the envelopes by K1, bit-equal to the plain version).

Cases: ``main`` is the main path of ``chip_smoke.py`` (the queries and
store of ``make_dataset(8, 2048, 32, length=512, seed=7)``: Q = 256,
C = 16384, L = 512, w = 51, V = 4); ``paper`` one query block of the
paper path's shape (Q = 512 against C = 2^20 series, L = 512, w = 154,
V = 4), z-normalised random walks drawn on the card from a fixed seed
(the kernel's work does not depend on the values while every envelope has
lo <= u).  Prints the card's name and power limit, then one ``k2_probe
{...}`` JSON line a case: the full form's ms (CUDA-event mean over
``--reps`` calls after two warm-up calls), its launches by count name,
its largest difference from ``ref.lb_enhanced_ref`` (over every candidate
at ``main``, over the first 512 at ``paper``: the plain version
materialises (Q, C, L)), the bound (the larger of q, c, u and lo read
once and the matrix written once at 3.35 TB/s, and the bands' 4 nb^2 +
2 nb - 1 operations plus 5 a bridge column and one add a pair at
67 TFLOP/s) and the issue floor (the bridge's 4 FP32 instructions a term
at 128 lanes an SM a clock at the card's maximum SM clock); at ``main``
also K8's ms, the bands form's ms and whether the full form at V = 0 is
bit-equal to K8.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

MAIN = dict(n_classes=8, n_train_per_class=2048, n_test_per_class=32,
            length=512, seed=7)
PAPER = dict(Q=512, C=1 << 20, L=512, w=154)
V = 4
TOL = dict(rtol=1e-5, atol=1e-6)


def time_ms(fn, reps: int) -> float:
    import torch

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def nvsmi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()


def band_ops(nb: int) -> int:
    return 4 * nb * nb + 2 * nb - 1


def plain_cols(q, c, u, lo, w, v, n: int):
    """``ref.lb_enhanced_ref`` over the first ``n`` candidates, 512 a
    call."""
    import torch

    from repro_torch.kernels import ref

    return torch.cat([ref.lb_enhanced_ref(q, c[s:s + 512], u[s:s + 512],
                                          lo[s:s + 512], w, v)
                      for s in range(0, n, 512)], dim=1)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cases", default="main,paper")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--save")
    ap.add_argument("--against")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("k2_probe: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.core.lower_bounds import _n_bands
    from repro_torch.data import make_dataset
    from repro_torch.kernels import _build
    from repro_torch.kernels.envelope import envelope_cuda
    from repro_torch.kernels.lb_enhanced import lb_enhanced_cuda
    from repro_torch.kernels.lb_keogh import lb_keogh_cuda

    print(f"card: {nvsmi('name,power.limit')}", flush=True)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clock = float(nvsmi("clocks.max.sm").split()[0]) * 1e6
    for name in args.cases.split(","):
        if name == "main":
            ds = make_dataset(**MAIN)
            q = torch.as_tensor(ds.x_test, device="cuda")
            c = torch.as_tensor(ds.x_train, device="cuda")
            w = int(0.1 * ds.length)
        else:
            gen = torch.Generator(device="cuda").manual_seed(23)
            x = [torch.randn(n, PAPER["L"], generator=gen,
                             device="cuda").cumsum(1)
                 for n in (PAPER["Q"], PAPER["C"])]
            q, c = ((s - s.mean(1, keepdim=True)) / s.std(1, keepdim=True)
                    for s in x)
            q, c = q.contiguous(), c.contiguous()
            del x
            w = PAPER["w"]
        u, lo = envelope_cuda(c, w)
        Q, L = q.shape
        C = c.shape[0]
        nb = _n_bands(L, w, V)
        _build.reset_counts()
        got = lb_enhanced_cuda(q, c, u, lo, w, V)
        torch.cuda.synchronize()
        launches = {n: k for n, k in _build.counts().items() if k}
        n_plain = C if name == "main" else 512
        want = plain_cols(q, c, u, lo, w, V, n_plain)
        err = (got[:, :n_plain] - want).abs().max().item()
        ok = torch.allclose(got[:, :n_plain], want, **TOL)
        del want
        bytes_ = 4.0 * (Q * L + 3 * C * L) + 4.0 * Q * C
        ops = float(band_ops(nb) + 5 * (L - 2 * nb) + 1) * Q * C
        rec = dict(
            case=name, shape=f"Q={Q} C={C} L={L} w={w} v={V} nb={nb}",
            full_ms=time_ms(lambda: lb_enhanced_cuda(q, c, u, lo, w, V),
                            args.reps if name == "main" else 3),
            launches=launches, max_abs_err=err, within_tolerance=ok,
            plain_candidates=n_plain,
            bound_ms=max(bytes_ / 3.35e12, ops / 67e12) * 1e3,
            issue_floor_ms=4.0 * Q * C * (L - 2 * nb) / (sms * 128 * clock)
            * 1e3)
        if name == "main":
            k8 = lb_keogh_cuda(q, u, lo)
            rec.update(
                k8_ms=time_ms(lambda: lb_keogh_cuda(q, u, lo), args.reps),
                bands_ms=time_ms(lambda: lb_enhanced_cuda(
                    q, c, u, lo, w, V, bands_only=True), args.reps),
                full_v0_bit_equal_to_k8=torch.equal(
                    lb_enhanced_cuda(q, c, u, lo, w, 0), k8))
            if args.save:
                torch.save(k8.cpu(), args.save)
            if args.against:
                rec["k8_bit_equal_to_saved"] = torch.equal(
                    k8.cpu(), torch.load(args.against))
        print("k2_probe " + json.dumps(rec), flush=True)
        del q, c, u, lo, got
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
