"""On the card: one run of a cell through the command, its last line
parsed.  Run: ``python -m pytest -m gpu portbench/tests``."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from portbench.tests.conftest import ROOT


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
def test_run_prints_a_correct_result_line(card):
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "handoutlines.wfull",
         "--seed", "2147483749", "--seconds", "2", "--trace", "1"],
        capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] is True and res["failed"] == 0
    assert res["device"]["platform"] == "gpu" and res["device"]["count"] == 1
    assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]
    assert set(res["metrics"]) == {
        "dtw_calls_per_batch", "dtw_per_query", "cascade_ms_per_batch",
        "idle_pct", "index_build_s"}
    assert 0 < res["metrics"]["idle_pct"]["value"] < 100
    assert list(res)[-1] == "check"
    assert out.stderr.strip().splitlines()[-1].startswith("check ")
