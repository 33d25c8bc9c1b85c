"""BENCHMARK.json against the rules of its format: every entry resolves to
its files, names and units keep to their characters, and every cell
reports what it must."""

import importlib
import json
import re
from pathlib import Path

import pytest

from benchmark import metrics, spec

ROOT = Path(__file__).resolve().parents[2]
BENCH = spec.load(ROOT)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys_and_paths():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p)
        assert not p.startswith("/") and ".." not in p.split("/")
        assert (ROOT / p).is_dir()
    assert len(BENCH["command"]) <= 32
    assert 1 <= BENCH["run_seconds"] <= 51
    assert isinstance(BENCH["run_seconds"], int)


def test_every_name_and_unit_keeps_to_its_characters():
    names = ([c["name"] for c in BENCH["configs"]] + CELLS
             + [m["name"] for m in METRICS]
             + [w["traffic"] for w in BENCH["workloads"]]
             + [k for c in BENCH["configs"] for k in c["reduced"]])
    assert all(NAME.match(n) for n in names), names
    for kind in (BENCH["configs"], BENCH["workloads"], METRICS):
        assert len({x["name"] for x in kind}) == len(kind)
    for m in METRICS:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")


@pytest.mark.parametrize("workload", CELLS)
def test_cell_resolves_to_its_files(workload):
    c = spec.cell(BENCH, workload, ROOT)
    assert c.chips in (1, 4)
    assert c.config["name"] == next(
        w["config"] for w in BENCH["workloads"] if w["name"] == workload)
    importlib.import_module(f"benchmark.tasks.{c.config['task']}")
    for m in c.end_to_end + c.per_layer:
        assert callable(metrics.reader(m["name"]))
    assert c.limits and all(v >= 0 for v in c.limits.values())
    assert {"setup_s"} < {m["name"] for m in c.end_to_end}
    assert c.per_layer


def test_configs_files_lie_under_paths_and_are_their_own():
    files = [c["file"] for c in BENCH["configs"]]
    assert len(set(files)) == len(files)
    for c in BENCH["configs"]:
        assert any(c["file"].startswith(p + "/") for p in BENCH["paths"])
        with open(ROOT / c["file"]) as f:
            cfg = json.load(f)
        assert cfg["reduced"] == c["reduced"] == []
        assert cfg["source"] == c["source"]
        assert c["name"] in {w["config"] for w in BENCH["workloads"]}


def test_metrics_name_their_layer_cells_and_moves():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0 < m["bound"] <= 0.25
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and m["layer"].strip()
        assert "\n" not in m["layer"] and len(m["layer"]) <= 200
        assert set(m["workloads"]) <= set(CELLS)
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_budget_of_a_full_check_fits_with_24_cells():
    per_cell = 14 * (BENCH["run_seconds"] + 60) + 2 * 90
    assert 2 * (BENCH["run_seconds"] + 60) + 24 * per_cell + 1200 <= 43200


def test_why_lines_are_short_single_lines():
    for x in BENCH["configs"] + BENCH["workloads"]:
        assert 1 <= len(x["why"]) <= 200 and "\n" not in x["why"]
        assert "\t" not in x["why"]
