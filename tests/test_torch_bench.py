"""The port's bench (``dnn_inference_engine_tpu_torch.bench``,
``bench_all`` and the CLI's ``bench``) against the JAX package's, on the
CPU at 64 px.

The JAX side is read, not run: the root ``bench.py`` and ``bench_all.py``
and the JAX CLI import JAX and time a TPU, so their contracts (the JSON
keys, the eleven config names, the subcommands) are read from their
source with ``ast``. The loop counts are cut to a few calls
(``quick_loops``): these tests hold the bench's contract and arithmetic,
not its timing, which is the card's (``tests/test_torch_gpu.py``,
``chip_smoke.py``). The module runs on one thread (ROADMAP C5).
"""

import ast
import json
import os
import re

import pytest
import threadpoolctl
import torch

from dnn_inference_engine_tpu_torch import bench, bench_all, cli
from dnn_inference_engine_tpu_torch.runtime import benchlib

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(device="cpu", input_size=64)

# what the port's ``detail`` adds to the JAX bench's, and no more
PORT_DETAIL = {"ms_per_batch_min", "ms_per_batch_spread_pct",
               "single_image_split_device_ms", "fp32_ms_per_batch",
               "fp32_ms_per_batch_spread_pct", "input_size", "card",
               "clocks_before", "clocks_after"}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpoolctl.threadpool_limits(limits=1):
        yield
    torch.set_num_threads(torch_threads)


def _quick(monkeypatch):
    """Loop-difference timings of 4 and 2 calls, 2 reps, and wall
    medians of 3 calls."""
    stats, wall = benchlib.per_iter_time_stats, benchlib.wall_time
    monkeypatch.setattr(benchlib, "per_iter_time_stats", lambda fn, args, **kw:
                        stats(fn, args, iters_hi=4, iters_lo=2, reps=2))
    monkeypatch.setattr(benchlib, "wall_time", lambda fn, args, **kw:
                        wall(fn, args, reps=3))


@pytest.fixture
def quick_loops(monkeypatch):
    _quick(monkeypatch)


@pytest.fixture(scope="module")
def result():
    with pytest.MonkeyPatch.context() as mp:
        _quick(mp)
        return bench.run_bench(batch=2, **SMALL)


def _source(path):
    with open(os.path.join(REPO, path)) as f:
        return ast.parse(f.read())


def _function(tree, name):
    return next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == name)


def _jax_bench_keys():
    """The keys of the root ``bench.py``'s ``run_bench`` dict and of its
    ``detail``."""
    fn = _function(_source("bench.py"), "run_bench")
    ret = next(n for n in ast.walk(fn) if isinstance(n, ast.Return))
    top = [k.value for k in ret.value.keys]
    detail = ret.value.values[top.index("detail")]
    return top, [k.value for k in detail.keys]


def test_jax_contract_keys_are_the_pinned_ones():
    top, detail = _jax_bench_keys()
    assert top == ["metric", "value", "unit", "vs_baseline", "detail"]
    assert detail == ["ms_per_batch", "p50_single_image_ms",
                      "single_image_device_ms", "fp32_images_per_s",
                      "fp32_precision", "kernel", "backend"]


def test_run_bench_returns_every_key_of_the_jax_contract(result):
    top, detail = _jax_bench_keys()
    assert list(result) == top
    assert set(result["detail"]) == set(detail) | PORT_DETAIL
    assert result["metric"] == "yolov2-tiny W8A8 images/sec/chip (batch 2)"
    assert result["unit"] == "images/s/chip"
    assert result["detail"]["kernel"] == "auto"
    assert result["detail"]["input_size"] == 64


def test_run_bench_value_and_ratio_are_the_forwards_times(result):
    d = result["detail"]
    # value = batch / ms_per_batch (each rounded: value to 0.1, ms to 1e-3)
    assert result["value"] == pytest.approx(2e3 / d["ms_per_batch"],
                                            rel=1e-3, abs=0.05)
    assert d["fp32_images_per_s"] == pytest.approx(
        2e3 / d["fp32_ms_per_batch"], rel=1e-3, abs=0.05)
    assert result["vs_baseline"] == pytest.approx(
        d["fp32_ms_per_batch"] / d["ms_per_batch"], rel=1e-3, abs=1e-3)
    assert d["ms_per_batch_min"] <= d["ms_per_batch"]
    assert d["ms_per_batch_spread_pct"] >= 0
    assert d["p50_single_image_ms"] > 0


def test_run_bench_on_the_cpu_times_no_card(result):
    """The card's fields are None on the CPU (a CPU time is no measure of
    the card); the fp32 baseline states what the port computes, not JAX's
    'HIGHEST'."""
    d = result["detail"]
    assert d["backend"] == "cpu"
    for k in ("single_image_device_ms", "single_image_split_device_ms",
              "card", "clocks_before", "clocks_after"):
        assert d[k] is None, k
    assert d["fp32_precision"] == bench.FP32_PRECISION["cpu"]
    assert "HIGHEST" not in json.dumps(bench.FP32_PRECISION)


def test_run_bench_refuses_a_missing_card(monkeypatch):
    """Without a device named, the bench runs on the card or raises: it
    never falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.run_bench(batch=2, input_size=64)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench_all.main(["--configs", "1", "--out", os.devnull])


def _jax_sweep_names():
    """The config names of the root ``bench_all.py``'s ``main``, in source
    order."""
    fn = _function(_source("bench_all.py"), "main")
    consts = sorted((n.lineno, n.col_offset, n.value) for n in ast.walk(fn)
                    if isinstance(n, ast.Constant)
                    and isinstance(n.value, str)
                    and re.match(r"\d[a-z]?_", n.value))
    names = []
    for _, _, v in consts:
        if v not in names:
            names.append(v)
    return names


def test_bench_all_config_names_are_the_jax_sweeps():
    names = _jax_sweep_names()
    assert len(names) == 11
    assert list(bench_all.CONFIGS) == names


def test_bench_all_picks_configs_by_name_or_leading_token():
    assert bench_all._pick("") == list(bench_all.CONFIGS)
    assert bench_all._pick("3,6_stage_roofline,8") == [
        "3_yolov2_w8a8_b32", "6_stage_roofline", "8_b1_detect_latency"]
    assert bench_all._pick("4b") == ["4b_resnet18_w8_b32"]
    with pytest.raises(SystemExit):
        bench_all._pick("9")


def test_bench_all_configs_1_and_8_write_out(quick_loops, tmp_path, capsys):
    out = tmp_path / "sweep.json"
    rc = bench_all.main(["--configs", "1,8", "--device", "cpu",
                         "--input-size", "64", "--out", str(out)])
    assert rc == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert [list(json.loads(ln)) for ln in lines] == [
        ["1_yolov2_fp32_b1"], ["8_b1_detect_latency"]]
    art = json.loads(out.read_text())
    assert art["backend"] == "cpu" and art["card"] is None
    c1 = art["configs"]["1_yolov2_fp32_b1"]
    assert "error" not in c1
    assert c1["images_per_s"] == pytest.approx(1e3 / c1["ms_per_batch"],
                                               rel=1e-3, abs=0.05)
    assert c1["ms_per_batch"] <= c1["ms_per_batch_median"]
    assert c1["cpu_reference"]["backend"] == "cpu"
    assert c1["cpu_reference"]["input_size"] == 64
    c8 = art["configs"]["8_b1_detect_latency"]
    assert "error" not in c8 and c8["p50_wall_ms"] > 0
    # the device split needs the card's timeline
    assert c8["detect_device_ms"] is None and c8["nms_device_ms"] is None


def test_bench_all_records_a_failed_config_and_exits_nonzero(tmp_path,
                                                             capsys):
    """Config 6 traces the card: on the CPU it is the config's error, the
    sweep goes on to the next config, and the run exits 1."""
    out = tmp_path / "sweep.json"
    rc = bench_all.main(["--configs", "6", "--device", "cpu",
                         "--input-size", "64", "--out", str(out)])
    assert rc == 1
    art = json.loads(out.read_text())
    assert "needs the card" in art["configs"]["6_stage_roofline"]["error"]
    assert "6_stage_roofline" in capsys.readouterr().err


def test_scaling_harness_runs_on_cpu_gloo_ranks():
    """Config 5's dp1/dp2 harness, each rank a process writing its output
    to a file: rank 0 of each group reports its images/s."""
    res = bench_all._dp_harness("cpu", 64, 2)
    assert res[1]["dp"] == 1 and res[1]["batch"] == 2
    assert res[2]["dp"] == 2 and res[2]["batch"] == 4
    assert res[1]["images_per_s"] > 0 and res[2]["images_per_s"] > 0


def _jax_subcommands():
    tree = _source(os.path.join("dnn_inference_engine_tpu", "cli.py"))
    return {n.args[0].value for n in ast.walk(tree)
            if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
            and n.func.attr == "add_parser"}


def test_cli_has_every_subcommand_of_the_jax_cli():
    import argparse
    sub = next(a for a in cli._parser()._actions
               if isinstance(a, argparse._SubParsersAction))
    jax_cmds = _jax_subcommands()
    assert "bench" in jax_cmds and len(jax_cmds) == 10
    assert set(sub.choices) == jax_cmds


def test_cli_bench_refuses_a_mesh(capsys):
    with pytest.raises(SystemExit):
        cli.main(["bench", "--mesh", "1,2", "--device", "cpu"])
    assert "config 5_scaling" in capsys.readouterr().err


@pytest.mark.parametrize("timer", ["device_ms", "throughput_ms",
                                   "latency_ms"])
def test_card_timers_raise_on_a_cpu_tensor(timer):
    x = torch.zeros(4)
    with pytest.raises(RuntimeError, match="need a CUDA device"):
        getattr(benchlib, timer)(lambda: x + 1, 3, device=x)


@pytest.mark.parametrize("reader", ["card_line", "clocks"])
def test_card_readers_raise_off_the_card(reader):
    with pytest.raises(RuntimeError, match="need a CUDA device"):
        getattr(benchlib, reader)("cpu")


def test_detect_split_needs_the_card():
    with pytest.raises(RuntimeError, match="needs the CUDA card"):
        bench.detect_device_split(lambda x: x, torch.zeros(1, 8, 8, 3))


def test_wire_batch_is_the_jax_benchs_batch():
    """uniform [0, 1) from seed 0, uint8 codes for a quantized mode; the
    b1 image is the batch's first row."""
    import numpy as np
    f = bench.wire_batch(3, 16, "fp32")
    q = bench.wire_batch(3, 16, "w8a8")
    assert f.dtype == np.float32 and q.dtype == np.uint8
    np.testing.assert_array_equal(
        q, np.clip(np.round(f * 255), 0, 255).astype(np.uint8))
    np.testing.assert_array_equal(bench.wire_batch(1, 16, "w8")[0], q[0])
