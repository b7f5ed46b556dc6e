"""The port's benchmark: one run of one cell.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout.  Prints, as the last line of standard
output, one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer ones), ``device``, with ``--trace 1`` ``breakdown``, and last
``check``: each number that decided ``correct`` with its limit, which
also end standard error.  Exits non-zero with no result when the card or
the program is missing, or when JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

_STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# forbidden top-level module names, compared whole
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def _since_process_start() -> float:
    """Seconds this process ran before ``_STARTED`` was read (Linux:
    ``/proc/self/stat``'s start tick against the uptime; 0 elsewhere)."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
    except OSError:
        return 0.0
    ran = up - int(fields[19]) / os.sysconf("SC_CLK_TCK")
    return max(0.0, ran - (time.perf_counter() - _STARTED))


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def _fail(msg: str, code: int) -> None:
    print(f"portbench: {msg}", file=sys.stderr)
    sys.exit(code)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    before = _since_process_start()

    if not (ROOT / "src" / "repro_torch").is_dir():
        _fail(f"the program (src/repro_torch) is not in {ROOT}", 2)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    # every cache of a run inside the checkout, at fixed paths
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ.setdefault(var, str(ROOT / "build" / "portbench" / sub))

    from portbench import spec

    cell = spec.load(args.workload, ROOT)
    import torch

    # one host thread: the window's host work is the engine's launches
    # and syncs, and idle intra-op threads only contend for shared cores
    torch.set_num_threads(1)
    if not torch.cuda.is_available():
        _fail("no CUDA device: the benchmark runs on the card only", 2)
    if torch.cuda.device_count() < cell.chips:
        _fail(f"{cell.name} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} present", 2)

    from portbench import harness

    result = harness.run(cell, args.seed, args.seconds, bool(args.trace),
                         device="cuda", started=_STARTED,
                         since_start=before)
    bad = forbidden_modules()
    if bad:
        _fail(f"modules loaded that the benchmark must not load: {bad}", 3)
    for name, c in result["check"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
