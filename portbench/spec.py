"""Finding a cell's files by name.

``BENCHMARK.json`` (at the checkout's root) names the cells, their
configurations and traffic mixes, and the metrics.  Each is a file here:

  workloads/<cell>.json     the cell's run parameters (warm-up, the
                            correctness check's sample and limits);
  configs/<config>.json     the deployment as it is run (its ``file`` in
                            ``BENCHMARK.json``); ``system`` names
                            ``systems/<system>.py``;
  traffic/<traffic>.json    the mix, read by ``traffic/generator.py``;
  metrics/<metric>.py       a reader of one metric: ``read(record)``
                            returns a number or ``None`` (nothing to read).

A later cell, configuration, mix or metric is added as files and entries
only.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
DIR = HERE.name


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    run: dict
    end_to_end: tuple
    per_layer: tuple
    root: Path = ROOT


def _read(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json`` with its files."""
    bench = _read(root / "BENCHMARK.json")
    entry = {w["name"]: w for w in bench["workloads"]}.get(name)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    cfg_entry = {c["name"]: c for c in bench["configs"]}[entry["config"]]
    here = root / DIR
    run = _read(here / "workloads" / f"{name}.json")
    for key in ("config", "traffic"):
        if run[key] != entry[key]:
            raise ValueError(f"workloads/{name}.json has {key} "
                             f"{run[key]!r}, BENCHMARK.json {entry[key]!r}")
    config = _read(root / cfg_entry["file"])
    traffic = _read(here / "traffic" / f"{entry['traffic']}.json")
    return Cell(
        name=name, chips=int(entry["chips"]), config=config,
        traffic=traffic, run=run,
        end_to_end=tuple(m for m in bench["end_to_end"]
                         if _applies(m, name)),
        per_layer=tuple(m for m in bench["per_layer"] if _applies(m, name)),
        root=root)


def system(cell: Cell):
    return importlib.import_module(
        f"portbench.systems.{cell.config['system']}")


def reader(metric: str, root: Path = ROOT):
    """``metrics/<metric>.py`` as a module (names may hold dots)."""
    path = root / DIR / "metrics" / f"{metric}.py"
    mod_name = "portbench.metrics." + metric.replace(".", "_").replace(
        "-", "_")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
