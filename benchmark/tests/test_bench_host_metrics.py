"""The model step's host metrics (``host_uploads_per_batch``,
``host_upload_ms``, ``host_launch_ms``, ``host_issue_ms``) read the
program's span table and upload counter after a traced window: on the CPU
at 64 px, a traced run of the YOLO cell through the harness, with every
scale the engine makes counted as an upload (the CPU standing in for the
card, where the uploads happen). The prepared W8A8 step makes none, so
both upload metrics read 0 there; a run whose window call makes one
upload a batch reads it. Without a trace, or against a program without
the spans and the counter, each reads nothing."""

import pytest
import torch

from benchmark import cell, metrics, spec
from dnn_inference_engine_tpu_torch.quant import quantize
from dnn_inference_engine_tpu_torch.runtime import profiling

BENCH = spec.load()
UPLOADS = ["host_uploads_per_batch", "host_upload_ms"]
HOST = ["host_launch_ms", "host_issue_ms"]
NAMES = UPLOADS + HOST
CELLS = {"yolov2-tiny-w8a8.offline-b512", "resnet18-w8a8.offline-b512",
         "yolov2-tiny-w8a8.eval-b512"}
SMALL = {"input_size": 64, "batch": 4, "pool_batches": 2,
         "sample_batches": 4, "trace_batches": 2}


def _traced(fault=None):
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(quantize, "_on_card", lambda device: True)
            c = spec.cell(BENCH, "yolov2-tiny-w8a8.offline-b512")
            return cell.run(c, 2 ** 31 + 11, 0.3, True, 0.0, device="cpu",
                            sizes=SMALL, fault=fault)
    finally:
        torch.set_num_threads(prev)


def one_upload(call):
    """The window's call with one blocking scale upload before it."""
    def f(x):
        quantize.f32_scalar(1.0, x.device)
        return call(x)
    return f


@pytest.fixture(scope="module")
def traced_run():
    return _traced()


@pytest.fixture(scope="module")
def traced_run_with_an_upload():
    return _traced(one_upload)


def test_every_cell_lists_the_host_metrics():
    cells = {w["name"] for w in BENCH["workloads"]}
    listed = {m["name"]: m for m in BENCH["per_layer"]}
    for name in NAMES:
        m = listed[name]
        assert set(m["workloads"]) <= cells
        assert CELLS <= set(m["workloads"])
        assert (m["layer"], m["moves"], m["source"]) == (
            "model step dispatch", "throughput_img_s", "device_trace")


@pytest.mark.parametrize("name", HOST)
def test_reads_a_positive_value_after_a_recorded_call(traced_run, name):
    assert traced_run["correct"], traced_run["checks"]
    assert traced_run["metrics"][name]["value"] > 0


@pytest.mark.parametrize("name", UPLOADS)
def test_the_w8a8_step_makes_no_upload(traced_run, name):
    assert traced_run["correct"], traced_run["checks"]
    assert traced_run["metrics"][name]["value"] == 0


@pytest.mark.parametrize("name", UPLOADS)
def test_an_upload_in_the_recorded_window_reads_positive(
        traced_run_with_an_upload, name):
    r = traced_run_with_an_upload
    assert r["correct"], r["checks"]
    assert r["metrics"][name]["value"] > 0
    assert r["metrics"]["host_uploads_per_batch"]["value"] == 1


def test_uploads_a_batch_are_whole_and_issue_holds_the_launches(traced_run):
    m = {k: v["value"] for k, v in traced_run["metrics"].items()}
    assert m["host_uploads_per_batch"] == int(m["host_uploads_per_batch"])
    assert m["host_issue_ms"] > m["host_launch_ms"]


@pytest.mark.parametrize("name", NAMES)
def test_reads_nothing_without_a_trace(name):
    assert metrics.read(name, {"batch": 4}) is None


@pytest.mark.parametrize("name", NAMES)
def test_reads_nothing_from_a_program_without_spans(name, monkeypatch):
    monkeypatch.delattr(profiling, "read_spans")
    monkeypatch.delattr(quantize.f32_scalar, "uploads")
    assert metrics.read(name, {"trace": {"batches": 2, "events": []}}) \
        is None
