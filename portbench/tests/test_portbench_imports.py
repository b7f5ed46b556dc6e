"""What the benchmark loads: never JAX or the JAX package (top-level
names compared whole: ``repro_torch`` is not ``repro``), and the
reference nothing of the program.  And the runs it must refuse."""

from __future__ import annotations

import ast
import json
import os
import shutil
import subprocess
import sys

from portbench.tests.conftest import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}

_RUN_TINY = """
import json, sys
sys.path[:0] = [{root!r}, {src!r}]
from portbench import harness, spec
from portbench.tests.conftest import tiny
import portbench.run
for name in ("search_1m.w03", "handoutlines.wfull"):
    for trace in (False, True):
        harness.run(tiny(spec.load(name)), 1, 0.05, trace, device="cpu")
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _python(code: str) -> list[str]:
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_harness_loads_no_jax():
    names = _python(_RUN_TINY.format(root=str(ROOT),
                                     src=str(ROOT / "src")))
    assert "repro_torch" in names and "portbench" in names
    assert not FORBIDDEN & set(names)


def test_reference_imports_nothing_of_the_program():
    names = _python(
        f"import json, sys; sys.path.insert(0, {str(ROOT)!r}); "
        "import portbench.reference.nn_dtw; "
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    assert "repro_torch" not in names and not FORBIDDEN & set(names)
    tree = ast.parse((ROOT / "portbench" / "reference" / "nn_dtw.py")
                     .read_text())
    mods = {a.name.split(".")[0] for n in ast.walk(tree)
            if isinstance(n, ast.Import) for a in n.names}
    mods |= {n.module.split(".")[0] for n in ast.walk(tree)
             if isinstance(n, ast.ImportFrom)}
    assert mods <= {"__future__", "torch"}


def test_forbidden_names_are_whole():
    sys.path.insert(0, str(ROOT))
    from portbench import run

    saved = dict(sys.modules)
    try:
        sys.modules.pop("repro", None)
        assert "repro" not in run.forbidden_modules()
        sys.modules["repro.core"] = sys
        assert run.forbidden_modules() == ["repro"]
    finally:
        sys.modules.clear()
        sys.modules.update(saved)


def _cli(cwd, *extra):
    return subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "handoutlines.wfull",
         "--seed", "4294967301", "--seconds", "1", "--trace", "0", *extra],
        capture_output=True, text=True, timeout=300, cwd=cwd)


def test_refuses_without_a_card():
    out = _cli(ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA" in out.stderr or "card" in out.stderr


def test_refuses_without_the_program(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _cli(tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "src/repro_torch" in out.stderr
