"""The operation and byte counts of the layer lists."""

import json
from pathlib import Path

import pytest

from benchmark import roofline

CONFIGS = Path(__file__).resolve().parents[1] / "configs"


def cfg(name):
    with open(CONFIGS / f"{name}.json") as f:
        return json.load(f)


# darknet prints 6.97 BFLOPs for yolov2-tiny-voc.cfg; ResNet-18's convs
# and classifier hold 1.814 G multiply-accumulates (the 1.82 G often
# quoted adds batch norm, ReLU and pooling)
@pytest.mark.parametrize("name, macs, gops", [
    ("yolov2-tiny-w8a8", 3_485_520_896, 6.97),
    ("resnet18-w8a8", 1_814_073_344, 3.63)])
def test_ops_per_image_match_the_published_counts(name, macs, gops):
    ops = roofline.ops_per_image(cfg(name))
    assert ops == 2 * macs
    assert round(ops / 1e9, 2) == gops


def test_yolov2_tiny_units_fold_each_following_pool():
    units = roofline.conv_units(cfg("yolov2-tiny-w8a8"))
    assert [u["layers"] for u in units] == [
        (0, 1), (2, 3), (4, 5), (6, 7), (8, 9), (10, 11), (12, 12),
        (13, 13), (14, 14)]
    # the entry: 416x416x3 bytes in, the pooled 208x208x16 codes out
    assert units[0]["act_bytes"] == 416 * 416 * 3 + 208 * 208 * 16
    # the head writes float32
    assert units[-1]["act_bytes"] == 13 * 13 * 1024 + 13 * 13 * 125 * 4
    assert units[-1]["weight_bytes"] == 1024 * 125 + 8 * 125


def test_resnet18_geometry_ends_in_the_classifier():
    geo = roofline.layer_geometry(cfg("resnet18-w8a8"))
    assert geo[1]["out"] == (56, 56, 64)
    assert geo[31]["out"] == (7, 7, 512)
    assert geo[-1]["out"] == (1, 1, 1000)
    assert len(roofline.conv_units(cfg("resnet18-w8a8"))) == 20


def test_bound_is_the_larger_of_compute_and_bytes():
    c = cfg("yolov2-tiny-w8a8")
    ops, bw = roofline.peaks("NVIDIA H100 80GB HBM3")
    assert (ops, bw) == (1979e12, 3.35e12)
    u = roofline.conv_units(c)[0]
    assert roofline.unit_bound_s(u, 128, ops, bw) == pytest.approx(
        (u["act_bytes"] * 128 + u["weight_bytes"]) / bw)
    u = roofline.conv_units(c)[7]                 # L13: compute-bound
    assert roofline.unit_bound_s(u, 128, ops, bw) == pytest.approx(
        u["ops"] * 128 / ops)
    assert roofline.peaks("NVIDIA H100 PCIe")[0] == 1513e12
