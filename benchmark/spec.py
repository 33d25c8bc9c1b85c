"""``BENCHMARK.json`` and the files it names, resolved by name.

A cell (one entry of ``workloads``) brings its configuration (the file
``configs[].file`` names), its traffic mix (``traffic/<traffic>.json``),
its limits (``limits/<workload>.json``) and the metrics that list it (or
that list no cells).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, NamedTuple

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


class Cell(NamedTuple):
    name: str
    chips: int
    config: Dict
    traffic: Dict
    limits: Dict[str, float]
    end_to_end: List[Dict]
    per_layer: List[Dict]


def load(root: Path = ROOT) -> Dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def _for(metrics: List[Dict], workload: str) -> List[Dict]:
    return [m for m in metrics if workload in m.get("workloads", [workload])]


def cell(bench: Dict, workload: str, root: Path = ROOT) -> Cell:
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; have "
                       f"{sorted(cells)}")
    w = cells[workload]
    conf = next(c for c in bench["configs"] if c["name"] == w["config"])
    return Cell(
        name=workload, chips=w["chips"],
        config=_json(root / conf["file"]),
        traffic=_json(HERE / "traffic" / f"{w['traffic']}.json"),
        limits=_json(HERE / "limits" / f"{workload}.json"),
        end_to_end=_for(bench["end_to_end"], workload),
        per_layer=_for(bench["per_layer"], workload))
