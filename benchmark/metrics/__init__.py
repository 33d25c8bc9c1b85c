"""Metric readers, one file a metric: ``metrics/<name>.py`` holds
``read(ctx)``, which returns the metric's value or None where the run
holds nothing for it to read (the result line then leaves it out).

``ctx`` holds ``cfg`` and ``traffic`` (the cell's files), ``batch``,
``setup_s``, ``timed`` (the window: ``latencies_s`` of each batch, from
its dispatch to its results on the host; ``batches``, ``images``,
``seconds``) and, in a traced run, ``trace`` (``events``: the device
events of the traced window with their scopes, ``batches``, ``busy_s``,
``window_s``, ``launches``: the engine's launch counters over it).
"""

from __future__ import annotations

import importlib.util
from pathlib import Path
from typing import Dict, Optional

HERE = Path(__file__).resolve().parent


def reader(name: str):
    path = HERE / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"metric {name!r} has no reader {path}")
    spec = importlib.util.spec_from_file_location(
        f"benchmark.metrics._{name.replace('.', '_').replace('-', '_')}",
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def read(name: str, ctx: Dict) -> Optional[float]:
    return reader(name)(ctx)
