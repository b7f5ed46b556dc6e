"""The port's examples (``examples_torch/``) run end to end on the CPU at a
small size with ``--device cpu`` and report exact results; without the
flag they ask for the card, which this machine lacks, and fail.

``distributed_search.py`` spawns its 8-rank gloo world, a (4, 2) mesh;
``train_lm.py --tiny`` takes 20 AdamW steps of a 2-layer model.
Each run has a deadline, so a hung world fails its test.
"""

import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
DEADLINE = 180

CASES = {
    "quickstart.py": ([], "every bound below DTW: True"),
    "ucr_classification.py": (
        ["--per-class", "24", "--n-test", "2", "--length", "48"],
        "exact vs brute force: True"),
    "distributed_search.py": (
        ["--per-class", "16", "--n-test", "4", "--length", "48"],
        "exact vs single-device brute force: True"),
    "train_lm.py": (["--tiny"], "loss fell: True"),
}


def _run(script: str, args: list[str]):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    return subprocess.run(
        [sys.executable, str(ROOT / "examples_torch" / script), *args],
        env=env, capture_output=True, text=True, timeout=DEADLINE)


@pytest.mark.parametrize("script", sorted(CASES))
def test_example_runs_on_cpu_and_reports_exact(script):
    args, verdict = CASES[script]
    out = _run(script, ["--device", "cpu", *args])
    assert out.returncode == 0, out.stdout + out.stderr
    assert verdict in out.stdout.splitlines(), out.stdout


@pytest.mark.parametrize("script", sorted(CASES))
def test_example_defaults_to_the_card(script):
    out = _run(script, CASES[script][0])
    assert out.returncode != 0
    assert "CUDA" in out.stderr and "cpu" in out.stderr, out.stderr
