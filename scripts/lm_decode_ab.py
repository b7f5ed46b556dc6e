#!/usr/bin/env python3
"""Decode tokens/s of gemma2-2b and falcon-mamba-7b, the two host-bound
decode requests of ``chip_smoke.py``, for one tree of the port.

    python3 scripts/lm_decode_ab.py [--src DIR] [--label NAME] [--reps N]

Imports ``repro_torch`` from ``DIR`` (default: this checkout's ``src``),
so that two trees are compared on one card by running it once for each,
in turns (A, B, B, A).  Each model runs at the smoke's request: full
width, random bf16 weights drawn on the card from seed 0, the kernel
route, B = 4 prompts of 1024 (gemma2-2b) or 2048 (falcon-mamba-7b)
tokens, a ``DecodeSession`` prefill into S + 32 and then 31 greedy steps,
timed alone (CUDA synchronised before and after), ``--reps`` times.
Prints one JSON line per model with every repeat's tokens/s and their
median, and the card's name and power limit.  Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

REQUESTS = {"gemma2-2b": dict(batch=4, prompt=1024, new=32),
            "falcon-mamba-7b": dict(batch=4, prompt=2048, new=32)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[1]
                                         / "src"))
    ap.add_argument("--label", default="tree")
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.src).resolve()))
    import torch

    if not torch.cuda.is_available():
        print("lm_decode_ab: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.configs import ARCHS
    from repro_torch.kernels import _build
    from repro_torch.models import LM
    from repro_torch.serve import DecodeSession

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"card: {card}")
    _build.build()
    _build.library()
    dev = torch.device("cuda:0")
    for name, req in REQUESTS.items():
        cfg = ARCHS[name]
        model = LM(cfg, attn_impl="kernel", ssm_impl="kernel")
        gen = torch.Generator(device=dev).manual_seed(0)
        params = model.compute_params(model.init(gen, device=dev))
        prompt = torch.randint(0, cfg.vocab, (req["batch"], req["prompt"]),
                               generator=gen, device=dev)
        rates = []
        for _ in range(args.reps):
            sess = DecodeSession(model, params,
                                 max_len=req["prompt"] + req["new"])
            logits = sess.prefill({"tokens": prompt})
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(req["new"] - 1):
                logits = sess.step(torch.argmax(logits, -1)[:, None])
            torch.cuda.synchronize()
            rates.append(req["batch"] * (req["new"] - 1)
                         / (time.perf_counter() - t0))
            del sess
        print("decode: " + json.dumps({
            "label": args.label, "src": args.src, "model": name, **req,
            "decode_tokens_per_s": rates,
            "median_decode_tokens_per_s": statistics.median(rates)}),
            flush=True)
        del model, params, prompt, logits
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
