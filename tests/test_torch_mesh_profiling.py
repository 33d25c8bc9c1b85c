"""Profiling and the sweep on a mesh (ROADMAP A15), on gloo ranks at 64 px.

Each rank times its own shard, and a rank-local stage may hold a
collective (the channel pair's row-parallel conv sums its int32
accumulator with ``all_reduce``), so every rank must loop it as many
times: the loop counts are rank 0's, and a trace lost on one rank is
taken again on all of them. Three spawns of ``_torch_dist_worker.py``:

- ``timing`` on (1, 2) with channel sharding and on (2, 1): the Engine's
  ``stage_times`` and ``layer_times`` at fixed counts, and (on (1, 2))
  the auto-scaled ``stage_times`` with rank 1's clock made slower, a
  trace lost on rank 1 alone, and ``cli layer-times --mesh``;
- ``sweep``: ``cli plan-sweep --mesh 1,2``, single-device as in the JAX
  CLI: rank 0 sweeps and writes, rank 1 waits.
"""

import json
import os

import numpy as np
import pytest

import _torch_dist as td
from dnn_inference_engine_tpu_torch.models import build_model
from dnn_inference_engine_tpu_torch.runtime import plan_sweep as tsweep
from dnn_inference_engine_tpu_torch.runtime.plan import plan_or_reason

pytestmark = pytest.mark.subproc

# the channel pair of YOLOv2-tiny's pin: L12's Cout slice, L13's Cin slice
PAIR_STAGES = ("L12_xla", "L13_xla")


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh_profiling")
    td.write_inputs(str(d), models=("yolov2-tiny",))
    return str(d)


_RUNS = {}


def _timing(inputs, mesh):
    """Each rank's results of the ``timing`` spawn on ``mesh`` (spawned
    once a module)."""
    if mesh not in _RUNS:
        outs = td.spawn("timing", 2, inputs, mesh, timeout=400)
        td.check_ranks(outs, "timing")
        ranks = []
        for r in range(2):
            with open(os.path.join(
                    inputs, f"timing_{mesh[0]}x{mesh[1]}_r{r}.json")) as f:
                ranks.append(json.load(f))
        _RUNS[mesh] = ranks
    return _RUNS[mesh]


@pytest.fixture(scope="module", params=[(1, 2), (2, 1)],
                ids=["1x2_channel", "2x1"])
def timing(request, inputs):
    return request.param, _timing(inputs, request.param)


@pytest.fixture(scope="module")
def channel(inputs):
    """The (1, 2) channel mesh's ranks, where the extra checks run."""
    return _timing(inputs, (1, 2))


def test_fixed_counts_finish_alike_on_every_rank(timing):
    """stage_times(iters=(4, 2)) and layer_times(iters=(4, 2)) run on both
    ranks (the row-parallel stage's all_reduce included) with the same
    loop counts."""
    _, ranks = timing
    for rk in ranks:
        assert rk["mesh"]["stage_iters"] == [[4, 2]] * len(
            rk["mesh"]["stage_iters"])
    assert ranks[0]["mesh"]["stage_iters"] == ranks[1]["mesh"]["stage_iters"]


def test_row_names_are_the_single_device_engines(timing):
    _, ranks = timing
    for rk in ranks:
        for key in ("stage_names", "layer_names"):
            assert rk["mesh"][key] == rk["single"][key], key
    assert any(n in PAIR_STAGES for n in ranks[0]["mesh"]["stage_names"])


def test_rows_count_the_ranks_share(timing):
    """A rank's useful work is its share: half the rows on (2, 1); on
    (1, 2) the whole batch, but half of each channel-pair stage."""
    mesh, ranks = timing
    for rk in ranks:
        names = rk["single"]["stage_names"]
        for name, g, g1 in zip(names, rk["mesh"]["gop"], rk["single"]["gop"]):
            halved = mesh == (2, 1) or name in PAIR_STAGES
            assert g == pytest.approx(g1 / 2 if halved else g1, abs=2e-3), \
                name


def test_auto_scaled_counts_are_rank_0s(channel):
    """Rank 1 reads its clock 1000 times slower, so its own counts would
    be the fewest the auto-scaler allows; every stage still runs rank 0's
    (hi, lo) on both ranks."""
    ranks = channel
    assert ranks[0]["auto_iters"] == ranks[1]["auto_iters"]
    assert any(hi - lo > 100 for hi, lo in ranks[0]["auto_iters"])


def test_a_trace_lost_on_one_rank_is_retaken_on_all(channel):
    """Rank 1's first trace lost an event: with agree_ranks both ranks
    take a second trace; alone, only rank 1 would."""
    ranks = channel
    assert [rk["takes_agree_True"] for rk in ranks] == [2, 2]
    assert [rk["takes_agree_False"] for rk in ranks] == [1, 2]


def test_cli_layer_times_on_a_mesh(channel):
    """``cli layer-times --mesh 1,2 --sharding channel --backend gloo
    --device cpu`` exits 0 on both ranks; rank 0 prints its stage rows
    and one total a rank, rank 1 nothing."""
    ranks = channel
    assert [rk["cli_rc"] for rk in ranks] == [0, 0]
    text = ranks[0]["cli_stdout"]
    assert "L13_xla" in text and "# TOTAL stages" in text
    assert "# rank 0: TOTAL stages ms" in text
    assert "# rank 1: TOTAL stages ms" in text
    assert ranks[1]["cli_stdout"] == ""


def test_cli_plan_sweep_on_a_mesh_sweeps_one_device(inputs, tmp_path):
    """Both ranks exit 0; only rank 0 writes its ``--out``, with the keys
    of the single-device sweep's artifact and a strategy the plan builder
    takes. The strategy itself is chosen by timing and not compared."""
    outs = td.spawn("sweep", 2, inputs, (1, 2), timeout=300)
    td.check_ranks(outs, "sweep")
    assert not os.path.exists(os.path.join(inputs, "sweep_r1.json"))
    with open(os.path.join(inputs, "sweep_r0.json")) as f:
        art = json.load(f)
    single = tsweep.sweep("yolov2-tiny", "w8a8", batch=2, input_size=64,
                          quick=True, iters=(2, 1), reps=1, auto_iters=False,
                          verbose=False, device="cpu")
    assert set(art) == set(single)
    assert set(art["strategy"]) == set(single["strategy"])
    path = tmp_path / "s.json"
    path.write_text(json.dumps(art))
    plan, why = plan_or_reason(build_model("yolov2-tiny"),
                               tsweep.load_strategy(str(path)), batch=2,
                               mode="w8a8")
    assert plan is not None, why
    assert art["input_size"] == 64 and np.isfinite(art["whole_net_ms"])
