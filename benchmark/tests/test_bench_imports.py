"""What the benchmark loads: never JAX or the JAX package (compared by the
whole top-level name: the port's name begins with the JAX package's), the
reference nothing of the program; and a run with no card, or with no
program beside the benchmark, prints no result."""

import ast
import json
import os
import shutil
import subprocess
import sys
import types
from pathlib import Path

import pytest

from benchmark import cell

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
JAX = {"jax", "jaxlib", "flax", "dnn_inference_engine_tpu"}


def imported(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
              == "import_module" and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


def top(name: str) -> str:
    return name.split(".")[0]


@pytest.mark.parametrize("path", sorted(HERE.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(HERE)))
def test_no_module_of_the_benchmark_imports_jax(path):
    assert not {top(m) for m in imported(path)} & JAX


@pytest.mark.parametrize("path", sorted((HERE / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_program(path):
    tops = {top(m) for m in imported(path)}
    assert tops <= {"__future__", "contextlib", "typing", "numpy", "torch"}


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    import dnn_inference_engine_tpu_torch  # noqa: F401  (the port is fine)
    assert cell.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "dnn_inference_engine_tpu.config",
                        types.ModuleType("dnn_inference_engine_tpu.config"))
    assert cell.forbidden_modules() == ["dnn_inference_engine_tpu"]


def _run(cwd, env_extra=None):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", **(env_extra or {}))
    env.pop("PYTHONPATH", None)
    return subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload",
         "yolov2-tiny-w8a8.offline-b512", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=cwd, env=env, capture_output=True, text=True,
        timeout=120)


def _no_result(out: str) -> bool:
    for line in out.splitlines():
        try:
            obj = json.loads(line)
        except ValueError:
            continue
        if isinstance(obj, dict) and "metrics" in obj:
            return False
    return "memory_peak_bytes" not in out


def test_a_run_without_a_card_fails_and_prints_no_result():
    r = _run(ROOT)
    assert r.returncode != 0
    assert _no_result(r.stdout)
    assert "no CUDA device" in r.stderr


def test_a_run_with_only_the_benchmark_fails(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    r = _run(tmp_path)
    assert r.returncode != 0
    assert _no_result(r.stdout)
    assert "No module named 'dnn_inference_engine_tpu_torch'" in r.stderr
