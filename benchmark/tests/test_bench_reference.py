"""The plain reference against the port on the CPU at 64 px: the layer
lists, the decode and NMS, and whole runs of each cell, which agree bit
for bit there (the port's plain versions round as the reference does)."""

import json

import numpy as np
import pytest
import torch

from benchmark import cell, families, spec
from benchmark.reference import detect_post
from benchmark.reference.int8_net import Reference
from dnn_inference_engine_tpu_torch.models import build_model
from dnn_inference_engine_tpu_torch.models import layers as L
from dnn_inference_engine_tpu_torch.postprocess import (
    decode_yolov2_cols, device_nms_cols)

BENCH = spec.load()
CELLS = [w["name"] for w in BENCH["workloads"]]
SMALL = {"input_size": 64, "batch": 4, "pool_batches": 2,
         "sample_batches": 3, "trace_batches": 2}


@pytest.fixture(autouse=True)
def few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def as_json(layer):
    """The program's layer in the configuration file's vocabulary."""
    if isinstance(layer, L.Conv):
        return {"type": "conv", "filters": layer.out_ch,
                "size": layer.ksize, "stride": layer.stride,
                "act": layer.act}
    if isinstance(layer, L.MaxPool):
        pad = "RIGHT_BOTTOM" if layer.stride == 1 else layer.padding
        return {"type": "maxpool", "size": layer.size,
                "stride": layer.stride, "padding": pad}
    if isinstance(layer, L.Route):
        return {"type": "route", "layers": list(layer.layers)}
    if isinstance(layer, L.Shortcut):
        return {"type": "shortcut", "from": layer.frm, "act": layer.act}
    if isinstance(layer, L.GlobalAvgPool):
        return {"type": "gap"}
    return {"type": "dense", "units": layer.out, "act": layer.act}


def _family(conf):
    with open(spec.ROOT / conf["file"]) as f:
        return families.name(json.load(f))


LAYER_LISTS = [c for c in BENCH["configs"] if _family(c) == "layer_list"]


@pytest.mark.parametrize("conf", LAYER_LISTS, ids=lambda c: c["name"])
def test_config_layers_are_the_programs_model(conf):
    c = spec.cell(BENCH, next(w["name"] for w in BENCH["workloads"]
                              if w["config"] == conf["name"]))
    model = build_model(c.config["model"],
                        num_classes=c.config["num_classes"])
    assert [as_json(x) for x in model.layers] == c.config["layers"]
    assert model.input_size == c.config["input_size"]


@pytest.mark.parametrize("topk, thresh", [(256, 0.3), (None, 0.005),
                                          (7, 0.05)])
def test_decode_and_nms_equal_the_ports(topk, thresh):
    g = torch.Generator().manual_seed(3)
    head = 3 * torch.randn(3, 4, 4, 125, generator=g)
    anchors = spec.cell(BENCH, CELLS[0]).config["anchors"]
    boxes, scores = detect_post.decode(head, anchors, 20, 128)
    pb, ps = decode_yolov2_cols(head, tuple(map(tuple, anchors)), 20, 128)
    assert torch.equal(boxes.transpose(1, 2), pb)
    assert torch.equal(scores.transpose(1, 2), ps)
    ref = detect_post.nms(boxes, scores, 0.45, thresh, topk, 128)
    got = device_nms_cols(pb, ps, iou_thresh=0.45, score_thresh=thresh,
                          topk=topk if topk is not None else 1 << 30,
                          max_det=128)
    for r, p in zip(ref, got):
        assert torch.equal(r, p)
    assert int((ref[1] > 0).sum()) > 10


def test_reference_int4_differs_from_int8():
    c = spec.cell(BENCH, CELLS[1]).config
    from benchmark import inputs
    p = inputs.fp32_weights(c, 5, "cpu")
    r8, r4 = Reference(c, p), Reference(c, p, qmax=7)
    assert int(r8.qparams[0]["wq"].abs().max()) == 127
    assert int(r4.qparams[0]["wq"].abs().max()) == 7


@pytest.mark.parametrize("workload", CELLS)
def test_a_cell_run_on_the_cpu_is_correct_bit_for_bit(workload):
    c = spec.cell(BENCH, workload)
    r = cell.run(c, 2 ** 33 + 5, 0.3, False, 0.0, device="cpu",
                 sizes=SMALL)
    assert r["correct"], r["checks"]
    checks = {k: v["value"] for k, v in r["checks"].items()}
    assert checks["weight_codes_off"] == 0
    assert checks["scales_gap"] == 0
    assert checks["head_gap"] == 0
    assert checks.get("det_unmatched", 0) == 0
    assert list(r["checks"]) == list(c.limits)
    assert list(r)[-1] == "checks"
    assert set(r["metrics"]) == {m["name"] for m in c.end_to_end}
