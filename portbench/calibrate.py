"""Readings for the limits of a cell's check, on the card, in one process.

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,3 \
        [--batches 3] [--control-seeds 1,2,3] [--out FILE]

For each seed: the cell's set-up, its warm-up, ``--batches`` window
batches back to back (each timed), then the judge's numbers on the
cell's own sample (the program's reading).  For each control seed, also
the control: the reference in the program's place, computed in bfloat16,
judged the same way.  The benchmark's own runs never run this.  One JSON
line a seed on standard output (and appended to ``--out``).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--batches", type=int, default=3)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    from portbench import spec

    if not torch.cuda.is_available():
        sys.exit("calibrate: no CUDA device")
    cell = spec.load(args.workload, ROOT)
    drv = spec.system(cell)
    check = cell.run["check"]
    n_check, every = int(check["queries"]), int(check["check_every"])
    ctrl = {int(s) for s in args.control_seeds.split(",") if s}
    seeds = [int(s) for s in args.seeds.split(",")]
    for seed in seeds + sorted(ctrl - set(seeds)):
        line = {"workload": cell.name, "seed": seed,
                "card": torch.cuda.get_device_name(0)}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        state = drv.prepare(cell.config, cell.traffic, seed, "cuda")
        torch.cuda.synchronize()
        line["prepare_s"] = time.perf_counter() - t
        line["index_build_s"] = state.index_build_s
        t = time.perf_counter()
        drv.run_batch(state, "warmup", 0)
        torch.cuda.synchronize()
        line["warmup_s"] = time.perf_counter() - t
        outputs, times = [], []
        if seed in seeds:
            for b in range(args.batches):
                t = time.perf_counter()
                outputs.append(drv.run_batch(state, "window", b)[1])
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t)
        else:
            outputs.append(drv.run_batch(state, "window", 0)[1])
        line["batch_s"] = times
        line["counters"] = drv.counters(state, outputs)
        line["peak_bytes"] = torch.cuda.max_memory_allocated()
        drv.free_program(state)
        if seed in seeds:
            t = time.perf_counter()
            line["program"] = drv.judge(state, outputs, n_check, every)
            torch.cuda.synchronize()
            line["judge_s"] = time.perf_counter() - t
        if seed in ctrl:
            q = drv.window_queries(state, len(outputs))
            q = q[drv.sample(state, q.shape[0], n_check)]
            t = time.perf_counter()
            line["control_dist_gap"] = drv.control(state, q, every)
            torch.cuda.synchronize()
            line["control_s"] = time.perf_counter() - t
        del state, outputs
        torch.cuda.empty_cache()
        text = json.dumps(line)
        print(text, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(text + "\n")


if __name__ == "__main__":
    main()
