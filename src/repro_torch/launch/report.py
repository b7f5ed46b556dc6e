"""Dry-run and roofline tables from the dry-run's JSONs (port of
``repro.launch.report``).

Usage: PYTHONPATH=src python -m repro_torch.launch.report [--dir results/dryrun]
Prints markdown for the dry-run (per-rank memory) and the roofline.  The
port traces its steps instead of compiling them, so the dry-run table's
time column reads "trace s"; a size the dry-run did not measure (the
paper cell's temporaries) reads "not measured".
"""

from __future__ import annotations

import argparse
import glob
import json
import os


def _fmt_b(b: float | None) -> str:
    if b is None:
        return "not measured"
    for unit in ("B", "KB", "MB", "GB", "TB"):
        if abs(b) < 1024:
            return f"{b:.2f}{unit}"
        b /= 1024
    return f"{b:.2f}PB"


def load(result_dir: str, mesh: str) -> list[dict]:
    out = []
    for p in sorted(glob.glob(os.path.join(result_dir, f"{mesh}__*.json"))):
        with open(p) as f:
            out.append(json.load(f))
    order = {"train_4k": 0, "prefill_32k": 1, "decode_32k": 2,
             "long_500k": 3, "search_1m": 4}
    out.sort(key=lambda r: (r["arch"], order.get(r["shape"], 9)))
    return out


def dryrun_table(rows: list[dict]) -> str:
    lines = [
        "| arch | shape | status | trace s | args/dev | temps/dev | out/dev |",
        "|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        if r["status"] == "skip":
            lines.append(
                f"| {r['arch']} | {r['shape']} | SKIP — {r['reason']} | | | | |"
            )
            continue
        m = r["memory"]
        lines.append(
            f"| {r['arch']} | {r['shape']} | ok | {r['compile_s']} | "
            f"{_fmt_b(m['argument_size_in_bytes'])} | "
            f"{_fmt_b(m['temp_size_in_bytes'])} | "
            f"{_fmt_b(m['output_size_in_bytes'])} |"
        )
    return "\n".join(lines)


def roofline_table(rows: list[dict]) -> str:
    lines = [
        "| arch | shape | compute s | memory s | collective s | dominant | "
        "useful-FLOPs ratio | roofline frac |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        if r["status"] == "skip" or "roofline" not in r:
            continue
        rf = r["roofline"]
        lines.append(
            f"| {r['arch']} | {r['shape']} | {rf['compute_s']:.3g} | "
            f"{rf['memory_s']:.3g} | {rf['collective_s']:.3g} | "
            f"**{rf['dominant']}** | {rf['useful_flops_ratio']:.3f} | "
            f"{rf['roofline_fraction']:.4f} |"
        )
    return "\n".join(lines)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="results/dryrun")
    args = ap.parse_args()
    single = load(args.dir, "single")
    multi = load(args.dir, "multi")
    print("### Dry-run — single pod (16x16 = 256 chips)\n")
    print(dryrun_table(single))
    if multi:
        print("\n### Dry-run — multi-pod (2x16x16 = 512 chips)\n")
        print(dryrun_table(multi))
    print("\n### Roofline (single pod)\n")
    print(roofline_table(single))


if __name__ == "__main__":
    main()
