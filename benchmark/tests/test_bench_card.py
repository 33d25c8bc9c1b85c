"""On the card (``python -m pytest -m gpu benchmark/tests``): each cell at
its own image size and a small batch, traced, is correct and reads every
per-layer metric it lists, each share at most 100%."""

import pytest
import torch

from benchmark import cell, spec

BENCH = spec.load()
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.gpu
@pytest.mark.parametrize("workload", CELLS)
def test_a_small_traced_run_on_the_card(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs the CUDA card")
    c = spec.cell(BENCH, workload)
    r = cell.run(c, 2 ** 31 + 77, 0.5, True, 0.0, device="cuda",
                 sizes={"batch": 8, "pool_batches": 2, "sample_batches": 2,
                        "trace_batches": 4})
    assert r["correct"], r["checks"]
    assert set(r["metrics"]) == {m["name"] for m in c.per_layer}
    for name, m in r["metrics"].items():
        if m["unit"] == "%":
            assert 0 < m["value"] <= 100, (name, m)
    assert 0 < r["device"]["busy_s"] <= r["device"]["window_s"]
