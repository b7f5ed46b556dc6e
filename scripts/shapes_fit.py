#!/usr/bin/env python3
"""Which of the repo's (architecture x shape) cells fit one card at batch
1, by the port's dry-run, and why the others do not.

    PYTHONPATH=src python3 scripts/shapes_fit.py [--budget BYTES] [--out FILE]

Host only (no card): each cell of ``configs/base.py``'s ``SHAPES`` that
JAX's ``shape_applicability`` runs, at batch 1 and its own length, is
traced by ``launch.dryrun.peak_memory`` on a (1, 1) mesh of a one-rank
fake world, as ``chip_smoke.py`` sizes its cells: a train cell with its
optimizer (``dryrun.opt_config_for``) on the plain routes, a prefill or
decode cell with the served tree in bf16 at rest and the kernels'
stand-ins where the card runs them.  Every ``long_500k`` cell (a decode
step in JAX's table) is also traced as the prefill of its 524288 tokens,
the way a card reaches it.  The budget
defaults to 0.9 (``chip_smoke.py``'s ``SHAPES_MEM_SHARE``) of 85017493504
B, the total ``torch.cuda.mem_get_info`` gives on an NVIDIA H100 80GB
HBM3.  The peaks are allocated bytes: a cell that fits the budget fits the
card under ``PYTORCH_CUDA_ALLOC_CONF=expandable_segments:True``, as
``chip_smoke.py`` runs it; with fixed segments the allocator may need more.  A cell
over the budget is put down to the bf16 weights (or the train state:
parameters and optimizer) alone, to the caches beside them, or else to
the step's transients.  Prints one JSON line a cell.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
H100_TOTAL = 85017493504
MEM_SHARE = 0.9


def main() -> int:
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    from repro_torch.configs import ARCHS
    from repro_torch.configs.base import (SHAPES, ShapeConfig,
                                          shape_applicability)
    from repro_torch.distributed.sharding import AxisRules
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_host_mesh

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--budget", type=float,
                    default=MEM_SHARE * H100_TOTAL)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    lines = []
    with dryrun.fake_world(1):
        mesh = make_host_mesh((1, 1), ("data", "model"), device_type="meta")
        rules = AxisRules.for_mesh(mesh)
        for name, cfg in ARCHS.items():
            for sname, shape in SHAPES.items():
                skip = shape_applicability(cfg, shape)
                if skip:
                    continue
                runs = [(sname, dataclasses.replace(shape, global_batch=1))]
                if sname == "long_500k":
                    runs.append((f"{sname} as a prefill", ShapeConfig(
                        sname, shape.seq_len, 1, "prefill")))
                for label, sh in runs:
                    kw = {}
                    if sh.kind != "train":
                        kw = {"params_dtype": torch.bfloat16}
                        if sh.kind == "prefill":
                            kw.update(attn_bypass=True, ssm_bypass=True)
                    t0 = time.perf_counter()
                    mem = dryrun.peak_memory(cfg, sh, mesh, rules, **kw)
                    cell = dryrun.build_cell(cfg, sh, mesh, rules, **kw)
                    if sh.kind == "train":
                        state = cell.args[0]
                        resting = dryrun.local_bytes((state.params,
                                                      state.opt))
                        caches = 0
                    else:
                        resting = dryrun.local_bytes(cell.args[0])
                        caches = (dryrun.local_bytes(cell.args[1])
                                  if sh.kind == "decode" else 0)
                    del cell
                    peak = mem["peak_bytes"]
                    why = None
                    if peak > args.budget:
                        why = ("train state (parameters and optimizer)"
                               if sh.kind == "train" and resting > args.budget
                               else "bf16 weights" if resting > args.budget
                               else "caches" if resting + caches > args.budget
                               else "the step's transients")
                    line = {"arch": name, "shape": label,
                            "kind": sh.kind, "B": 1, "S": sh.seq_len,
                            "predicted_peak": peak,
                            "weights_or_state": resting, "caches": caches,
                            "budget": args.budget,
                            "fits": peak <= args.budget, "why_not": why,
                            "depth": mem["depth"],
                            "trace_s": time.perf_counter() - t0}
                    print(json.dumps(line), flush=True)
                    lines.append(line)
    if args.out:
        Path(args.out).write_text("".join(json.dumps(x) + "\n"
                                          for x in lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
