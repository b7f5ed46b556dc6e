#!/usr/bin/env python3
"""Time K9's f32-arithmetic form on one card, beside SDPA.

    PYTHONPATH=src python3 scripts/k9_probe.py [--cases global,d512,...]

``repro_torch`` comes from ``PYTHONPATH``, and each source tree builds its
kernels into its own ``build/``, so two trees are compared on one card by
running the script once for each in one command (A, B, B, A).  Prints the
card's name and power limit, then one ``k9_probe {...}`` JSON line per
case: the kernel's ms with the case's cap and without it, SDPA's ms on the
same inputs without the cap (``F.scaled_dot_product_attention(is_causal=
True, enable_gqa=True)`` on (B, H, S, D) views), the FP32 bound (4 D
operations per unmasked (query head, key) pair at 67 TFLOP/s against q,
k, v and o at 3.35 TB/s), the launches of each count in one call, and the
largest difference from ``ref.flash_attention_ref`` without the cap.
Inputs are N(0, 1) in float32 from a fixed seed; ms are CUDA-event means
over ``--reps`` calls after two warm-up calls.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

# name: (B, S, Hq, Hkv, D, cap); causal, Sq = Skv = S
CASES = {
    # gemma2-2b's global layer (scoring prefill 2 x 8192) in f32
    "global": (2, 8192, 8, 4, 256, 50.0),
    "d64": (2, 8192, 8, 4, 64, 50.0),
    "d128": (2, 8192, 8, 4, 128, 50.0),
    # the wide rows of chip_smoke.py
    "d512": (1, 2048, 8, 4, 512, 50.0),
    "d1100": (1, 1024, 8, 4, 1100, None),
    "d2048": (1, 1024, 8, 4, 2048, None),
    "d4100": (1, 1024, 8, 4, 4100, None),
}


def pairs(S: int) -> int:
    return S * (S + 1) // 2


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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cases", default="global,d512,d1100,d2048")
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("k9_probe: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels.flash_attention import flash_attention_cuda

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(f"card: {card}", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(19)
    for name in args.cases.split(","):
        B, S, Hq, Hkv, D, cap = CASES[name]
        q = torch.randn(B, S, Hq, D, generator=gen, device="cuda")
        k = torch.randn(B, S, Hkv, D, generator=gen, device="cuda")
        v = torch.randn(B, S, Hkv, D, generator=gen, device="cuda")
        _build.reset_counts()
        got = flash_attention_cuda(q, k, v, True)
        torch.cuda.synchronize()
        launches = {n: c for n, c in _build.counts().items() if c}
        err = (got - ref.flash_attention_ref(q, k, v, True)).abs().max()
        nbytes = 4 * (2 * q.numel() + 2 * k.numel())
        bound = max(nbytes / 3.35e12, 4.0 * B * Hq * D * pairs(S) / 67e12)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        rec = dict(
            case=name, shape=f"B={B} S={S} Hq={Hq} Hkv={Hkv} D={D} "
                             f"float32 causal", cap=cap,
            ms=time_ms(lambda: flash_attention_cuda(q, k, v, True, None,
                                                    cap), args.reps),
            nocap_ms=time_ms(lambda: flash_attention_cuda(q, k, v, True),
                             args.reps),
            sdpa_ms=time_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True), args.reps),
            bound_ms=bound * 1e3, launches=launches,
            nocap_max_abs_err=err.item())
        print("k9_probe " + json.dumps(rec), flush=True)
        del q, k, v, qt, kt, vt, got
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
