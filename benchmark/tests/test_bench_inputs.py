"""The seeded inputs repeat, seed for seed, whatever the seed's size."""

import json
from pathlib import Path

import torch

from benchmark import inputs

with open(Path(__file__).resolve().parents[1] / "configs"
          / "yolov2-tiny-w8a8.json") as f:
    CFG = json.load(f)
BIG = 2 ** 31 + 12345


def test_weights_repeat_and_follow_he_init():
    a = inputs.fp32_weights(CFG, BIG, "cpu")
    b = inputs.fp32_weights(CFG, BIG, "cpu")
    c = inputs.fp32_weights(CFG, BIG + 1, "cpu")
    assert all(torch.equal(p[k], q[k]) for p, q in zip(a, b) for k in p)
    assert not torch.equal(a[0]["w"], c[0]["w"])
    w = a[13]["w"]                       # 3x3x1024x1024
    assert w.shape == (3, 3, 1024, 1024) and w.dtype == torch.float32
    assert abs(float(w.std()) - (2 / (9 * 1024)) ** 0.5) < 1e-3 * 2
    assert abs(float(a[13]["b"].std()) - 0.01) < 2e-3


def test_images_and_pool_repeat():
    for f in (lambda s: inputs.calib_images(CFG, s, "cpu", 32),
              lambda s: torch.stack(inputs.pool(CFG, s, "cpu", 32, 2, 3))):
        assert torch.equal(f(BIG), f(BIG))
        assert not torch.equal(f(BIG), f(7))
    pool = inputs.pool(CFG, BIG, "cpu", 32, 2, 3)
    assert all(x.dtype == torch.uint8 and x.shape == (2, 32, 32, 3)
               for x in pool)
    assert not torch.equal(pool[0], pool[1])
    cal = inputs.calib_images(CFG, BIG, "cpu", 32)
    assert cal.shape == (8, 32, 32, 3) and float(cal.max()) <= 1.0


def test_streams_of_one_seed_differ():
    assert len({inputs.stream_seed(BIG, s) for s in range(4)}) == 4
    assert inputs.stream_seed(2 ** 40, 0) < 2 ** 63


def test_a_standardized_head_has_unit_channels_on_the_calibration():
    small = dict(CFG, input_size=64)
    cal = inputs.calib_images(small, BIG, "cpu", 64)
    params = inputs.weights(small, BIG, "cpu", cal)
    raw = inputs.fp32_weights(small, BIG, "cpu")
    assert all(torch.equal(p[k], q[k]) for p, q in zip(params[:-1], raw)
               for k in p)
    from benchmark.reference.int8_net import Reference
    head = Reference(small, params).forward_fp32(cal)[-1].double()
    assert head.shape[-1] == 125
    assert float(head.mean((0, 1, 2)).abs().max()) < 1e-5
    assert float((head.std((0, 1, 2)) - 1).abs().max()) < 1e-5
    assert torch.equal(inputs.weights(small, BIG, "cpu", cal)[-1]["w"],
                       params[-1]["w"])
