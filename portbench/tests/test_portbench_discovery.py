"""A configuration, a cell, a traffic mix and a per-layer metric added as
files and entries are found by name, with no existing file edited."""

from __future__ import annotations

import hashlib
import json
import shutil

from portbench import spec
from portbench.tests.conftest import ROOT

READER = '''"""Batches the traced window ran."""


def read(rec):
    return float(rec.batches)
'''


def _digests(root):
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes())
            .hexdigest() for p in sorted(root.rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


def test_new_files_are_taken(tmp_path):
    from portbench import harness

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _digests(tmp_path / "portbench")

    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    here = tmp_path / "portbench"
    cfg = json.loads((here / "configs" / "handoutlines.json").read_text())
    cfg.update(name="tiny_store", n_store=128, length=40)
    (here / "configs" / "tiny_store.json").write_text(json.dumps(cfg))
    (here / "traffic" / "fresh_b4_w8.json").write_text(
        json.dumps({"batch": 4, "w": 8}))
    (here / "workloads" / "tiny_store.fresh.json").write_text(json.dumps({
        "config": "tiny_store", "traffic": "fresh_b4_w8",
        "check": {"queries": 4, "check_every": 8,
                  "limits": {"missing": 0, "dist_gap": 1e-4}}}))
    (here / "metrics" / "batches_seen.py").write_text(READER)
    bench["configs"].append({"name": "tiny_store", "source": "test",
                             "file": "portbench/configs/tiny_store.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "tiny_store.fresh",
                               "config": "tiny_store",
                               "traffic": "fresh_b4_w8", "chips": 1,
                               "why": "test"})
    bench["per_layer"].append({"name": "batches_seen", "unit": "batches",
                               "better": "higher", "source": "host_clock",
                               "layer": "engine", "moves": "queries_per_s",
                               "workloads": ["tiny_store.fresh"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = spec.load("tiny_store.fresh", tmp_path)
    assert cell.config["n_store"] == 128 and cell.traffic["batch"] == 4
    assert "batches_seen" in [m["name"] for m in cell.per_layer]
    res = harness.run(cell, 5, 0.1, True, device="cpu")
    assert res["correct"] is True
    assert res["metrics"]["batches_seen"]["value"] >= 1
    # an old cell does not report the new metric: it lists its cells
    old = spec.load("handoutlines.wfull", tmp_path)
    assert "batches_seen" not in [m["name"] for m in old.per_layer]
    after = _digests(tmp_path / "portbench")
    assert {k: v for k, v in after.items() if k in before} == before


def test_cell_and_its_file_must_agree(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = tmp_path / "portbench" / "workloads" / "handoutlines.wfull.json"
    run = json.loads(p.read_text())
    run["traffic"] = "fresh_b256_w154"
    p.write_text(json.dumps(run))
    try:
        spec.load("handoutlines.wfull", tmp_path)
    except ValueError as e:
        assert "traffic" in str(e)
    else:
        raise AssertionError("a cell whose file disagrees was taken")
