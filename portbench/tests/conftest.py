"""Shared helpers of the benchmark's CPU tests: each cell cut to a tiny
store on the CPU, where the program runs its plain versions."""

from __future__ import annotations

import dataclasses
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

CELLS = ("search_1m.w03", "handoutlines.wfull")


def tiny(cell, n_store: int = 256, batch: int = 6):
    """``cell`` with its store and batches cut to a CPU test's size, at
    a length and window in the same ratio as the cell's (w = L stays
    w = L)."""
    L0 = cell.config["length"]
    L = 48 if L0 <= 512 else 80
    w0 = int(cell.traffic["w"])
    w = L if w0 >= L0 else max(1, round(w0 * L / L0))
    cfg = dict(cell.config, n_store=n_store, length=L)
    mix = dict(cell.traffic, batch=batch, w=w)
    return dataclasses.replace(cell, config=cfg, traffic=mix)


@pytest.fixture
def tiny_cell():
    from portbench import spec

    return lambda name, **kw: tiny(spec.load(name), **kw)
